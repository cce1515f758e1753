"""spfft_tpu_torch — the PyTorch and CUDA port of spfft_tpu.

Sparse 3D FFTs of the kind plane-wave DFT codes run: sparse frequency
values on z-sticks <-> a dense space-domain grid. The JAX package
``spfft_tpu`` is the reference; this package computes the same
transforms with PyTorch and hand-written CUDA kernels for the H100
(``csrc/``, built with ``nvcc`` at first use). It never imports JAX.

This slice covers the local single-precision C2C plan::

    import spfft_tpu_torch as sp
    plan = sp.make_local_plan(sp.TransformType.C2C, 64, 64, 64, triplets)
    space = plan.backward(values)                 # (64, 64, 64, 2) on cuda
    values2 = plan.forward(space, sp.Scaling.FULL)

Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels
on the host.
"""

from .errors import (DeviceError, DuplicateIndicesError, ErrorCode,
                     GenericError, InvalidIndicesError,
                     InvalidParameterError, OverflowError_,
                     PrecisionContractError)
from .indexing import IndexPlan, build_index_plan
from .plan import TransformPlan, make_local_plan, predicted_rel_error
from .types import IndexFormat, ProcessingUnit, Scaling, TransformType

__all__ = [
    "DeviceError", "DuplicateIndicesError", "ErrorCode", "GenericError",
    "IndexFormat", "IndexPlan", "InvalidIndicesError",
    "InvalidParameterError", "OverflowError_", "PrecisionContractError",
    "ProcessingUnit", "Scaling", "TransformPlan", "TransformType",
    "build_index_plan", "make_local_plan", "predicted_rel_error",
]
