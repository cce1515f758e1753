"""spfft_tpu_torch — the PyTorch and CUDA port of spfft_tpu.

Sparse 3D FFTs of the kind plane-wave DFT codes run: sparse frequency
values on z-sticks <-> a dense space-domain grid. The JAX package
``spfft_tpu`` is the reference; this package computes the same
transforms with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use). It never imports JAX.

The port covers the local C2C and R2C plans in single and double
precision at every dims the JAX package plans (axes above 512 through
the two-pass FFT, the long matrix form or ``torch.fft``), their batched
and pointwise execution, the two-kernel route (``fused=False``), the
``Grid`` / ``Transform`` / multi-transform API, the distributed plan
over S shards held on one device with the block exchange, and the
benchmark CLI ``python -m spfft_tpu_torch.benchmark``::

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

C and Fortran programs reach the same plans through the drop-in C ABI
``libspfft_tpu_torch.so`` (``include/spfft_tpu_torch.h``, the symbols of
the JAX package's ``include/spfft_tpu.h``), built by
``spfft_tpu_torch.native.build_capi``; its Python side is
``spfft_tpu_torch.capi_bridge``.
"""

from .errors import (DeviceError, DuplicateIndicesError, ErrorCode,
                     GenericError, InvalidIndicesError,
                     InvalidParameterError, OverflowError_,
                     PrecisionContractError)
from .grid import Grid, Transform
from .indexing import IndexPlan, build_index_plan
from .multi import multi_transform_backward, multi_transform_forward
from .parallel import (DistributedTransformPlan, make_distributed_plan,
                       make_mesh)
from .plan import TransformPlan, make_local_plan, predicted_rel_error
from .types import (ExchangeType, IndexFormat, ProcessingUnit, Scaling,
                    TransformType)

__all__ = [
    "DeviceError", "DistributedTransformPlan", "DuplicateIndicesError",
    "ErrorCode", "ExchangeType", "GenericError", "Grid", "IndexFormat",
    "IndexPlan", "InvalidIndicesError", "InvalidParameterError",
    "OverflowError_", "PrecisionContractError", "ProcessingUnit", "Scaling",
    "Transform", "TransformPlan", "TransformType", "build_index_plan",
    "make_distributed_plan", "make_local_plan", "make_mesh",
    "multi_transform_backward", "multi_transform_forward",
    "predicted_rel_error",
]
