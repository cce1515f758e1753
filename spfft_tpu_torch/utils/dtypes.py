"""Precision names and the interleaved-real <-> complex boundary
(counterpart of ``spfft_tpu.utils.dtypes``).

The reference stores complex data as interleaved real pairs
(docs/source/details.rst "Complex Number Format"); the public value and
space layouts of this package keep a trailing axis of extent 2, like
the JAX package, so that the two compare like with like. Inside, the
pipeline is planar: separate real and imaginary tensors of the plan's
real type, float32 for ``"single"`` and float64 for ``"double"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidParameterError

_REAL = {"double": np.float64, "single": np.float32}
_COMPLEX = {"double": np.complex128, "single": np.complex64}


def real_dtype(precision: str):
    """numpy real dtype of a precision name."""
    try:
        return _REAL[precision]
    except KeyError:
        raise InvalidParameterError(
            f"precision must be 'double' or 'single', got {precision!r}")


def torch_real_dtype(precision: str) -> torch.dtype:
    """torch real dtype of a precision name: the type of every tensor a
    plan of that precision computes on."""
    return torch.float64 if real_dtype(precision) is np.float64 \
        else torch.float32


def complex_dtype(precision: str):
    """numpy complex dtype of a precision name."""
    real_dtype(precision)
    return _COMPLEX[precision]


def interleaved_to_complex(arr: torch.Tensor) -> torch.Tensor:
    """(..., 2) real tensor -> (...) complex tensor (a copy)."""
    return torch.complex(arr[..., 0], arr[..., 1])


def complex_to_interleaved(arr: torch.Tensor) -> torch.Tensor:
    """(...) complex tensor -> (..., 2) real tensor (a copy)."""
    return torch.stack([arr.real, arr.imag], dim=-1)


def as_interleaved(arr, precision: str) -> np.ndarray:
    """Coerce host-side input (numpy complex, or real already-interleaved)
    into the canonical (..., 2) real layout at the plan's precision."""
    arr = np.asarray(arr)
    rdt = real_dtype(precision)
    if np.issubdtype(arr.dtype, np.complexfloating):
        out = np.empty(arr.shape + (2,), rdt)
        out[..., 0] = arr.real
        out[..., 1] = arr.imag
        return out
    if arr.ndim >= 1 and arr.shape[-1] == 2:
        return np.ascontiguousarray(arr, rdt)
    raise InvalidParameterError(
        "expected complex array or interleaved real array with trailing "
        f"axis 2, got dtype {arr.dtype} shape {arr.shape}")


def as_complex_np(interleaved) -> np.ndarray:
    """Host-side (..., 2) real -> numpy complex."""
    if isinstance(interleaved, torch.Tensor):
        interleaved = interleaved.detach().cpu().numpy()
    arr = np.asarray(interleaved)
    cdt = np.complex128 if arr.dtype == np.float64 else np.complex64
    return (arr[..., 0] + 1j * arr[..., 1]).astype(cdt)
