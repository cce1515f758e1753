"""spfft_tpu_torch — the PyTorch and CUDA port of spfft_tpu.

Sparse 3D FFTs of the kind plane-wave DFT codes run: sparse frequency
values on z-sticks <-> a dense space-domain grid. The JAX package
``spfft_tpu`` is the reference; this package computes the same
transforms with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use). It never imports JAX.

The port covers the local single-precision C2C and R2C plans, their
batched and pointwise execution, the two-kernel route (``fused=False``)
and the ``Grid`` / ``Transform`` / multi-transform API::

    import spfft_tpu_torch as sp
    plan = sp.make_local_plan(sp.TransformType.C2C, 64, 64, 64, triplets)
    space = plan.backward(values)                 # (64, 64, 64, 2) on cuda
    values2 = plan.forward(space, sp.Scaling.FULL)
    spaces = plan.backward_batched(values_batch)  # (B, 64, 64, 64, 2)
    values3 = plan.apply_pointwise(values, fn, potential)

Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels
on the host.
"""

from .errors import (DeviceError, DuplicateIndicesError, ErrorCode,
                     GenericError, InvalidIndicesError,
                     InvalidParameterError, OverflowError_,
                     PrecisionContractError)
from .grid import Grid, Transform
from .indexing import IndexPlan, build_index_plan
from .multi import multi_transform_backward, multi_transform_forward
from .plan import TransformPlan, make_local_plan, predicted_rel_error
from .types import (ExchangeType, IndexFormat, ProcessingUnit, Scaling,
                    TransformType)

__all__ = [
    "DeviceError", "DuplicateIndicesError", "ErrorCode", "ExchangeType",
    "GenericError", "Grid", "IndexFormat", "IndexPlan",
    "InvalidIndicesError", "InvalidParameterError", "OverflowError_",
    "PrecisionContractError", "ProcessingUnit", "Scaling", "Transform",
    "TransformPlan", "TransformType", "build_index_plan", "make_local_plan",
    "multi_transform_backward", "multi_transform_forward",
    "predicted_rel_error",
]
