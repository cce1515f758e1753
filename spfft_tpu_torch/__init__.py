"""spfft_tpu_torch — the PyTorch and CUDA port of spfft_tpu.

Sparse 3D FFTs of the kind plane-wave DFT codes run: sparse frequency
values on z-sticks <-> a dense space-domain grid. The JAX package
``spfft_tpu`` is the reference; this package computes the same
transforms with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use). It never imports JAX.

The port covers the local C2C and R2C plans in single and double
precision at every dims the JAX package plans (axes above 512 through
the two-pass FFT, Bluestein's FFT or ``torch.fft``), their batched
and pointwise execution, the two-kernel route (``fused=False``), the
``Grid`` / ``Transform`` / multi-transform API, the distributed plan
over S shards with every exchange of the JAX package (the padded blocks,
the ring, the exact-count ragged and op schedules, ``overlap_chunks`` and
the f32 / bf16 / int8 wire ladder), held on one device or spread over the
ranks of a ``torch.distributed`` process group (one process per GPU:
``initialize_multihost``, ``build_distributed_plan_multihost``,
``make_mesh(S, process_group=...)``), the native index planner
(``native/planner.cpp``), and the benchmark CLI
``python -m spfft_tpu_torch.benchmark``::

    import spfft_tpu_torch as sp
    plan = sp.make_local_plan(sp.TransformType.C2C, 64, 64, 64, triplets)
    space = plan.backward(values)                 # (64, 64, 64, 2) on cuda
    values2 = plan.forward(space, sp.Scaling.FULL)
    spaces = plan.backward_batched(values_batch)  # (B, 64, 64, 64, 2)
    values3 = plan.apply_pointwise(values, fn, potential)

    dplan = sp.make_distributed_plan(sp.TransformType.C2C, 64, 64, 64,
                                     triplets_per_shard, [16] * 4,
                                     mesh=sp.make_mesh(4))
    slabs = dplan.unshard_space(dplan.backward(values_per_shard))

Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels
on the host.

The plans are observed and fault-injectable as the JAX package's are:
``spfft_tpu_torch.obs`` (counters, spans, the Prometheus text, the
``MetricsServer`` scrape endpoint, the flight recorder's journal and
incident bundles), ``spfft_tpu_torch.faults`` (``FaultPlan`` scripts at
the JAX package's seams, the fused kernels' runtime demotion ladder) and
``spfft_tpu_torch.control.config`` (``ServeConfig``, the knobs the
distributed plan reads its defaults from). A local plan's tables export
as ``PlanTables`` and restore with ``restore_plan``.

C and Fortran programs reach the same plans through the drop-in C ABI
``libspfft_tpu_torch.so`` (``include/spfft_tpu_torch.h``, the symbols of
the JAX package's ``include/spfft_tpu.h``), built by
``spfft_tpu_torch.native.build_capi``; its Python side is
``spfft_tpu_torch.capi_bridge``.
"""

from . import obs, timing
from .errors import (AllocationError, DeadlineExpiredError, DeviceAllocationError,
                     DeviceError, DeviceFFTError, DeviceSupportError,
                     DistributedError, DistributedSupportError,
                     DuplicateIndicesError, ErrorCode, FFTError, GenericError,
                     HostExecutionError, InternalError, InvalidIndicesError,
                     InvalidParameterError, OverflowError_,
                     ParameterMismatchError, PrecisionContractError,
                     QueueFullError, ServeError)
from .grid import Grid, Transform
from .indexing import IndexPlan, build_index_plan, check_stick_duplicates
from .multi import multi_transform_backward, multi_transform_forward
from .parallel import (DistributedIndexPlan, DistributedTransformPlan,
                       build_distributed_plan,
                       build_distributed_plan_multihost,
                       initialize_multihost, make_distributed_plan,
                       make_mesh, plan_fingerprint, validate_consistent)
from .plan import (PlanTables, TransformPlan, make_local_plan,
                   predicted_rel_error, restore_plan)
from .types import (ExchangeType, IndexFormat, ProcessingUnit, Scaling,
                    TransformType)

__all__ = [
    "ErrorCode", "GenericError", "AllocationError", "OverflowError_",
    "InvalidParameterError",
    "DuplicateIndicesError", "InvalidIndicesError", "DistributedSupportError",
    "DistributedError", "ParameterMismatchError", "HostExecutionError",
    "FFTError", "InternalError", "DeviceError", "DeviceSupportError",
    "DeviceAllocationError", "DeviceFFTError",
    "ServeError", "QueueFullError", "DeadlineExpiredError",
    "ExchangeType", "ProcessingUnit", "IndexFormat", "TransformType",
    "Scaling",
    "IndexPlan", "build_index_plan", "check_stick_duplicates",
    "TransformPlan", "make_local_plan", "predicted_rel_error",
    "PlanTables", "restore_plan",
    "PrecisionContractError",
    "DistributedIndexPlan", "DistributedTransformPlan",
    "build_distributed_plan", "build_distributed_plan_multihost",
    "initialize_multihost", "make_distributed_plan", "make_mesh",
    "plan_fingerprint", "validate_consistent",
    "Grid", "Transform",
    "multi_transform_backward", "multi_transform_forward",
    "timing", "obs",
]
