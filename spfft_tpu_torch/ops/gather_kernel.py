"""The sparse compression gather of the two-kernel route: port of
``spfft_tpu/ops/gather_kernel.py`` ``run_gather``, which reaches the
Pallas calls ``_monotone_gather_call`` (``gather_kernel.py:751``/``:778``),
``_monotone_gather_call_aliased`` (``:824``/``:848``) and
``_wide_gather_call`` (``:1119``/``:1145``). One CUDA kernel
(``csrc/gather.cu``) covers all three: they compute one function, and
their windows, selector words and segments are TPU decompositions.

* :func:`gather` — ``out[b, j] = src[b, idx[j]]`` where ``valid[j]`` and
  ``0 <= idx[j] < num_src``, else 0, on planar f32 views with a leading
  batch, in one launch whatever the batch.
* :func:`decompress` — sparse values -> planar z-sticks through the
  plan's inverse slot map ``slot_src`` (sentinel ``num_values`` = empty).
* :func:`compress` — planar z-sticks -> sparse values through
  ``value_indices``.

Values are in the plan's public layout: interleaved ``(B?, N, 2)``, or
the planar pair ``(B?, 2, N)`` when ``pair`` is set. On a CUDA tensor
:func:`gather` launches the kernel; on a CPU tensor it runs its plain
version, :func:`gather_plain`. :func:`decompress_plain` (a sentinel row
gather) and :func:`compress_plain` (an indexed read) are the plain twins
of the two directions, independent of :func:`gather_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidParameterError
from . import _build, stages

_SRC = "gather.cu"
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_ARGS = [_P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _LL, ctypes.c_int]


def gather_plain(src, idx, out, valid=None) -> None:
    """Plain version of :func:`gather`: every invalid or out-of-range
    index becomes the sentinel ``num_src``, and
    :func:`~spfft_tpu_torch.ops.stages.gather_rows_with_sentinel` reads
    the rows (one row per source slot, one column per batch element)."""
    n = src[0].shape[1]
    i = idx.long()
    bad = (i < 0) | (i >= n)
    if valid is not None:
        bad |= ~valid
    i = torch.where(bad, n, i)
    for s, o in zip(src, out):
        o.copy_(stages.gather_rows_with_sentinel(s.t(), i).t())


def _check_planes(name, planes, shape=None):
    """Two f32 ``(B, n)`` views of one device with equal strides."""
    re, im = planes
    for t in planes:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise InvalidParameterError(
                f"gather {name}: expected float32 tensors, got "
                f"{getattr(t, 'dtype', type(t).__name__)}")
        if t.dim() != 2:
            raise InvalidParameterError(
                f"gather {name}: expected (batch, n) views, got "
                f"{tuple(t.shape)}")
    if re.shape != im.shape or re.stride() != im.stride() \
            or re.device != im.device:
        raise InvalidParameterError(
            f"gather {name}: the real and imaginary views differ in shape, "
            f"strides or device")
    if shape is not None and tuple(re.shape) != tuple(shape):
        raise InvalidParameterError(
            f"gather {name}: expected shape {tuple(shape)}, got "
            f"{tuple(re.shape)}")


def gather(src, idx: torch.Tensor, out, valid=None) -> None:
    """``out[k][b, j] = src[k][b, idx[j]]`` where ``valid[j]`` (every
    slot when None) and ``0 <= idx[j] < num_src``, else 0, for the real
    and imaginary ``k``, in place.

    ``src`` and ``out`` are ``(re, im)`` pairs of f32 ``(B, num_src)`` and
    ``(B, num_out)`` views (any strides, the two views of a pair alike,
    so interleaved rows and planar planes are both views); ``idx`` is
    int32 ``(num_out,)`` and ``valid`` bool ``(num_out,)``, contiguous.
    Each kernel launch (one per call, whatever B is) adds one to
    ``gather.launches``."""
    _check_planes("source", src)
    b, n = src[0].shape
    num_out = idx.shape[0] if idx.dim() == 1 else -1
    dev = src[0].device
    _build.require(idx, "gather idx", torch.int32, (num_out,), dev)
    _check_planes("output", out, (b, num_out))
    if out[0].device != dev:
        raise InvalidParameterError(
            f"gather output: expected a tensor on {dev}, got "
            f"{out[0].device}")
    if valid is not None:
        _build.require(valid, "gather valid", torch.bool, (num_out,), dev)
    if not _build.on_cuda(src[0], "gather"):
        gather_plain(src, idx, out, valid)
        return
    if b > 2**31 - 1:
        raise InvalidParameterError(f"gather: batch {b} above 2^31 - 1")
    if b == 0 or num_out == 0:
        return
    fn = _build.function(_SRC, "spfft_gather", _ARGS)
    _build.launch(fn, "gather kernel", dev, src[0].data_ptr(),
                  src[1].data_ptr(), src[0].stride(1), src[0].stride(0), n,
                  idx.data_ptr(), None if valid is None else valid.data_ptr(),
                  out[0].data_ptr(), out[1].data_ptr(), out[0].stride(1),
                  out[0].stride(0), num_out, b)
    gather.launches += 1


gather.launches = 0


def value_planes(values: torch.Tensor, pair: bool):
    """``(re, im)`` views ``(B, N)`` of values in a public layout: ``(B?,
    N, 2)`` interleaved, or ``(B?, 2, N)`` with ``pair``."""
    v = values if values.dim() == 3 else values.unsqueeze(0)
    if pair:
        return v[:, 0, :], v[:, 1, :]
    return v[..., 0], v[..., 1]


def values_shape(batch, num_values: int, pair: bool) -> tuple:
    """The public value layout's shape, with a leading ``batch`` unless
    it is None."""
    shape = (2, num_values) if pair else (num_values, 2)
    return shape if batch is None else (batch,) + shape


def decompress(values: torch.Tensor, slot_src: torch.Tensor, dim_z: int,
               pair: bool = False):
    """Sparse values -> planar sticks ``(sr, si)``, each ``(B?,
    slot_src.numel() // dim_z, dim_z)`` f32 (leading B when ``values``
    is batched): every slot written, the sentinel ``num_values`` as 0
    (the plan's trailing sentinel stick comes out as zeros)."""
    if values.dim() not in (2, 3):
        raise InvalidParameterError(
            f"decompress: expected (B?, N, 2) or (B?, 2, N) values, got "
            f"{tuple(values.shape)}")
    if slot_src.numel() % dim_z:
        raise InvalidParameterError(
            f"decompress: {slot_src.numel()} slots are not whole sticks of "
            f"dim_z={dim_z}")
    src = value_planes(values, pair)
    lead = values.shape[:1] if values.dim() == 3 else ()
    shape = lead + (slot_src.numel() // dim_z, dim_z)
    sr = torch.empty(shape, dtype=torch.float32, device=values.device)
    si = torch.empty_like(sr)
    flat = (src[0].shape[0], slot_src.numel())
    gather(src, slot_src, (sr.view(flat), si.view(flat)))
    return sr, si


def decompress_plain(values: torch.Tensor, slot_src: torch.Tensor,
                     dim_z: int, pair: bool = False):
    """Plain twin of :func:`decompress`:
    :func:`~spfft_tpu_torch.ops.stages.gather_rows_with_sentinel` of the
    value rows."""
    rows = values.transpose(-1, -2) if pair else values
    flat = stages.gather_rows_with_sentinel(rows, slot_src.long())
    shape = values.shape[:-2] + (slot_src.numel() // dim_z, dim_z)
    return flat[..., 0].reshape(shape), flat[..., 1].reshape(shape)


def compress_plain(sr: torch.Tensor, si: torch.Tensor,
                   value_indices: torch.Tensor, pair: bool = False):
    """Plain twin of :func:`compress`: an indexed read of the flat stick
    slots, stacked into the value layout."""
    vi = value_indices.long()
    planes = (sr.flatten(-2)[..., vi], si.flatten(-2)[..., vi])
    return torch.stack(planes, dim=-2 if pair else -1)


def compress(sr: torch.Tensor, si: torch.Tensor, value_indices: torch.Tensor,
             pair: bool = False) -> torch.Tensor:
    """Planar sticks ``(B?, S, dim_z)`` -> the sparse values at the flat
    slots ``value_indices`` (int32), ``(B?, N, 2)`` f32 (``(B?, 2, N)``
    with ``pair``)."""
    if sr.dim() not in (2, 3):
        raise InvalidParameterError(
            f"compress: expected (B?, S, dim_z) sticks, got "
            f"{tuple(sr.shape)}")
    for t in (sr, si):
        _build.require(t, "compress sticks", torch.float32, sr.shape)
    batch = sr.shape[0] if sr.dim() == 3 else None
    flat = (1 if batch is None else batch, sr.shape[-2] * sr.shape[-1])
    out = torch.empty(values_shape(batch, value_indices.numel(), pair),
                      dtype=torch.float32, device=sr.device)
    gather((sr.view(flat), si.view(flat)), value_indices,
           value_planes(out, pair))
    return out
