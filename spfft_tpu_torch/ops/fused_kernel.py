"""Sparse compression fused with the z-stick DFT: ports of
``spfft_tpu/ops/fused_kernel.py`` ``run_decompress_zdft`` (Pallas call at
``fused_kernel.py:587``) and ``run_zdft_compress`` (``:783``).

* :func:`decompress_zdft` (backward): sparse values -> z-transformed
  planar sticks, gathering through the plan-time inverse map
  ``slot_src`` (sentinel ``num_values`` = empty slot). For an R2C plan
  it completes the (x=0, y=0) stick before the z-DFT (the TPU kernel's
  ``_complete_zero_stick``, ``fused_kernel.py:350``).
* :func:`zdft_compress` (forward): raw planar sticks -> z-DFT (any FULL
  scale folded into the matrices) -> the sparse values, written through
  a plan-time CSR by stick (:func:`compress_csr`).

On a CUDA tensor each wrapper launches its kernel in
``csrc/fused_compress.cu`` (see that file for the design and what bounds
it: FP32 operations). On a CPU tensor it runs the plain version beside
it. Values are in the plan's public layout: interleaved ``(N, 2)``, or
the planar pair ``(2, N)`` when ``pair`` is set.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..errors import InvalidParameterError
from . import _build, dft, stages

_SRC = "fused_compress.cu"
_P = ctypes.c_void_p
_DEC_ARGS = [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_longlong, _P]
_CMP_ARGS = [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, _P]


def compress_csr(value_indices: np.ndarray, num_sticks: int, dim_z: int):
    """Plan-time CSR by stick of the value -> slot map: ``stick_ptr``
    ``(num_sticks + 1,)``, and per entry the value's position ``val_id``
    and its z slot ``val_z`` (each ``(num_values,)``), all int32. Entries
    are in stable slot order, so every value of a stick sits in one
    range, z ascending, and duplicate triplets keep one entry each."""
    vi = np.asarray(value_indices, np.int64)
    val_id = np.argsort(vi, kind="stable")
    slots = vi[val_id]
    counts = np.bincount(slots // dim_z, minlength=num_sticks)
    stick_ptr = np.zeros(num_sticks + 1, np.int64)
    np.cumsum(counts, out=stick_ptr[1:])
    return (stick_ptr.astype(np.int32), val_id.astype(np.int32),
            (slots % dim_z).astype(np.int32))


def _values_shape(num_values: int, pair: bool):
    return (2, num_values) if pair else (num_values, 2)


# -- backward: gather-decompress -> z-DFT ------------------------------------

def decompress_zdft_plain(values, slot_src, mats, dim_z: int, pair: bool,
                          zero_stick: int = -1):
    """Plain version of :func:`decompress_zdft`: sentinel row gather,
    :func:`~spfft_tpu_torch.ops.stages.complete_stick_hermitian` on the
    zero stick, then :func:`~spfft_tpu_torch.ops.dft.pdft_last`."""
    rows = values.t() if pair else values
    flat = stages.gather_rows_with_sentinel(rows, slot_src.long())
    num_sticks = slot_src.numel() // dim_z
    sr = flat[:, 0].reshape(num_sticks, dim_z)
    si = flat[:, 1].reshape(num_sticks, dim_z)
    if zero_stick >= 0:  # in place: flat is this function's own copy
        sr[zero_stick], si[zero_stick] = stages.complete_stick_hermitian(
            sr[zero_stick], si[zero_stick])
    return dft.pdft_last(sr, si, mats)


def decompress_zdft(values: torch.Tensor, slot_src: torch.Tensor, mats,
                    dim_z: int, pair: bool = False, zero_stick: int = -1):
    """Sparse values -> z-transformed planar sticks ``(sr, si)``, each
    ``(slot_src.numel() // dim_z, dim_z)`` f32.

    ``values`` is ``(N, 2)`` (``(2, N)`` with ``pair``) f32;
    ``slot_src`` is the int32 inverse slot map, sentinel N = zero;
    ``mats`` the backward z pair ``(dim_z, dim_z)``; ``zero_stick`` the
    stick to complete hermitian before the z-DFT (an R2C plan's (0,0)
    stick; -1 = none). Every output slot is written. Each kernel launch
    adds one to ``decompress_zdft.launches``."""
    n = values.shape[1] if pair else values.shape[0]
    dev = values.device
    _build.require(values, "decompress_zdft values", torch.float32,
                   _values_shape(n, pair))
    _build.require(slot_src, "decompress_zdft slot_src", torch.int32,
                   device=dev)
    if slot_src.dim() != 1 or slot_src.numel() % dim_z:
        raise InvalidParameterError(
            f"decompress_zdft: slot_src must be flat with a multiple of "
            f"dim_z={dim_z} slots, got {tuple(slot_src.shape)}")
    for c in mats:
        _build.require(c, "decompress_zdft matrix", torch.float32,
                       (dim_z, dim_z), dev)
    num_sticks = slot_src.numel() // dim_z
    if not -1 <= zero_stick < num_sticks:
        raise InvalidParameterError(
            f"decompress_zdft: zero_stick {zero_stick} is not a stick of "
            f"{num_sticks} (or -1)")
    if not _build.on_cuda(values, "decompress_zdft"):
        return decompress_zdft_plain(values, slot_src, mats, dim_z, pair,
                                     zero_stick)
    sr = torch.empty((num_sticks, dim_z), dtype=torch.float32, device=dev)
    si = torch.empty_like(sr)
    if num_sticks == 0:
        return sr, si
    fn = _build.function(_SRC, "spfft_decompress_zdft", _DEC_ARGS)
    _build.launch(fn, "decompress_zdft kernel", dev, values.data_ptr(),
                  slot_src.data_ptr(), mats[0].data_ptr(),
                  mats[1].data_ptr(), sr.data_ptr(), si.data_ptr(),
                  num_sticks, dim_z, n, int(pair), int(zero_stick))
    decompress_zdft.launches += 1
    return sr, si


decompress_zdft.launches = 0


# -- forward: z-DFT -> compress ----------------------------------------------

def zdft_compress_plain(sr, si, mats, csr, pair: bool):
    """Plain version of :func:`zdft_compress`:
    :func:`~spfft_tpu_torch.ops.dft.pdft_last`, then an indexed gather of
    the CSR's slots."""
    stick_ptr, val_id, val_z = csr
    yr, yi = dft.pdft_last(sr, si, mats)
    num_sticks, dim_z = sr.shape
    counts = (stick_ptr[1:] - stick_ptr[:-1]).long()
    stick = torch.repeat_interleave(
        torch.arange(num_sticks, device=sr.device), counts)
    slot = stick * dim_z + val_z.long()
    vid = val_id.long()
    out = torch.empty(_values_shape(val_id.numel(), pair),
                      dtype=torch.float32, device=sr.device)
    re, im = (out[0], out[1]) if pair else (out[:, 0], out[:, 1])
    re[vid] = yr.reshape(-1)[slot]
    im[vid] = yi.reshape(-1)[slot]
    return out


def zdft_compress(sr: torch.Tensor, si: torch.Tensor, mats, csr,
                  pair: bool = False):
    """Raw planar sticks ``(num_sticks, dim_z)`` -> z-DFT -> the sparse
    values, ``(N, 2)`` (``(2, N)`` with ``pair``) f32.

    ``mats`` is the forward z pair (FULL scale folded in); ``csr`` is
    :func:`compress_csr`'s ``(stick_ptr, val_id, val_z)`` as int32
    tensors. Each value is written exactly once. Each kernel launch adds
    one to ``zdft_compress.launches``."""
    if sr.dim() != 2:
        raise InvalidParameterError(
            f"zdft_compress: expected (num_sticks, dim_z) sticks, got "
            f"{tuple(sr.shape)}")
    num_sticks, dim_z = sr.shape
    dev = sr.device
    stick_ptr, val_id, val_z = csr
    n = val_id.numel()
    _build.require(sr, "zdft_compress sr", torch.float32)
    _build.require(si, "zdft_compress si", torch.float32, sr.shape, dev)
    for c in mats:
        _build.require(c, "zdft_compress matrix", torch.float32,
                       (dim_z, dim_z), dev)
    _build.require(stick_ptr, "zdft_compress stick_ptr", torch.int32,
                   (num_sticks + 1,), dev)
    _build.require(val_id, "zdft_compress val_id", torch.int32, (n,), dev)
    _build.require(val_z, "zdft_compress val_z", torch.int32, (n,), dev)
    if not _build.on_cuda(sr, "zdft_compress"):
        return zdft_compress_plain(sr, si, mats, csr, pair)
    out = torch.empty(_values_shape(n, pair), dtype=torch.float32,
                      device=dev)
    if num_sticks == 0:
        return out
    fn = _build.function(_SRC, "spfft_zdft_compress", _CMP_ARGS)
    _build.launch(fn, "zdft_compress kernel", dev, sr.data_ptr(),
                  si.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(),
                  stick_ptr.data_ptr(), val_id.data_ptr(), val_z.data_ptr(),
                  out.data_ptr(), num_sticks, dim_z, n, int(pair))
    zdft_compress.launches += 1
    return out


zdft_compress.launches = 0
