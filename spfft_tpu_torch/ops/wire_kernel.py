"""The int8 rung of the exchange's wire ladder: the counterpart of
``spfft_tpu/parallel/exchange.py`` ``quantize_blocks_int8`` (:124) and
``dequantize_blocks_int8`` (:156), which the JAX package computes with XLA
elementwise ops (no Pallas call). Here both are one CUDA source,
``csrc/wire.cu``, a template with float and double instances.

* :func:`quantize` — a padded exchange block's planar pair ``(re, im)``,
  each ``(G, S, max_sticks, max_planes)`` (G the leading batch and source
  shards, S the destination slots; any strides), with one float32 absmax
  scale per (g, slot, quant row): rows are sticks for ``quant_axis`` 1
  (the backward exchange) and planes for 2 (the forward). Returns the
  int8 payloads ``(G, S, rows, elements)`` and the scales ``(G, S,
  rows)``: ``scale = absmax / 127`` (1 where absmax is 0), ``q =
  clip(round(x / scale), -127, 127)``, computed in float32 (a double
  block is cast first, as the JAX package casts it).
* :func:`dequantize` — the payloads and scales (after the move) ->
  ``(G, S, max_sticks, max_planes)`` contiguous of the plan's real type,
  ``q * scale`` in float32, then cast.

On a CUDA tensor each wrapper launches its kernel and adds one to its
``.launches``; on a CPU tensor it runs its plain twin
(:func:`quantize_plain`, :func:`dequantize_plain`, torch compositions).
The kernel and the plain twin agree bit for bit: IEEE division, rounding
half to even, one rounded product.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidParameterError
from . import _build

_SRC = "wire.cu"
_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_Q_ARGS = [_P, _P] + [_LL] * 8 + [_P, _P, _P, _P]
_D_ARGS = [_P, _P, _P, _LL, _LL, _LL, _I, _P, _P, _P]


def _check_axis(quant_axis: int) -> None:
    if quant_axis not in (1, 2):
        raise InvalidParameterError(
            f"quant_axis must be 1 (sticks) or 2 (planes), got {quant_axis}")


def quantize_plain(planes: tuple, quant_axis: int):
    """Plain twin of :func:`quantize` (same operands and results)."""
    _check_axis(quant_axis)
    re, im = (t.to(torch.float32) for t in planes)
    if quant_axis == 2:
        re, im = re.transpose(-1, -2), im.transpose(-1, -2)
    if re.shape[-1] == 0:
        absmax = re.new_zeros(re.shape[:-1])
    else:
        absmax = torch.maximum(re.abs().amax(-1), im.abs().amax(-1))
    # a tensor divisor: on the card torch divides by a Python scalar as a
    # product with its reciprocal, which is not the JAX package's division
    scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = tuple(torch.clamp(torch.round(t / scale[..., None]), -127, 127)
              .to(torch.int8).contiguous() for t in (re, im))
    return q[0], q[1], scale.contiguous()


def dequantize_plain(payload: tuple, scales: torch.Tensor, quant_axis: int,
                     real_dtype) -> tuple:
    """Plain twin of :func:`dequantize`."""
    _check_axis(quant_axis)
    out = []
    for q in payload:
        x = (q.to(torch.float32) * scales[..., None]).to(real_dtype)
        out.append((x.transpose(-1, -2) if quant_axis == 2 else x)
                   .contiguous())
    return tuple(out)


def _check_block(planes) -> torch.dtype:
    re, im = planes
    dtype = _build.call_dtype(re, "wire quantize block")
    for t in planes:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype \
                or t.dim() != 4 or t.shape != re.shape \
                or t.stride() != re.stride() or t.device != re.device:
            raise InvalidParameterError(
                "wire quantize: expected two (G, S, max_sticks, max_planes) "
                "views of one real type, shape and strides")
    return dtype


def quantize(planes: tuple, quant_axis: int):
    """``(q_re, q_im, scales)`` of the block ``planes`` (see the module
    docstring): int8 ``(G, S, rows, elements)`` each and float32 ``(G,
    S, rows)``."""
    _check_axis(quant_axis)
    dtype = _check_block(planes)
    re, im = planes
    if not _build.on_cuda(re, "wire quantize"):
        return quantize_plain(planes, quant_axis)
    g, s, ms, mp = re.shape
    rows, n = (ms, mp) if quant_axis == 1 else (mp, ms)
    g_st, s_st, i_st, p_st = re.stride()
    r_st, e_st = (i_st, p_st) if quant_axis == 1 else (p_st, i_st)
    q_re = torch.empty((g, s, rows, n), dtype=torch.int8, device=re.device)
    q_im = torch.empty_like(q_re)
    scales = torch.empty((g, s, rows), dtype=torch.float32,
                         device=re.device)
    fn = _build.function(_SRC, _build.entry("spfft_wire_quantize", dtype),
                         _Q_ARGS)
    _build.launch(fn, "wire quantize kernel", re.device, re.data_ptr(),
                  im.data_ptr(), g_st, s_st, r_st, e_st, g, s, rows, n,
                  q_re.data_ptr(), q_im.data_ptr(), scales.data_ptr())
    quantize.launches += 1
    return q_re, q_im, scales


quantize.launches = 0


def dequantize(payload: tuple, scales: torch.Tensor, quant_axis: int,
               real_dtype) -> tuple:
    """``(re, im)`` ``(G, S, max_sticks, max_planes)`` contiguous of
    ``real_dtype`` from the payloads ``(G, S, rows, elements)`` int8 and
    the scales ``(G, S, rows)`` float32 of :func:`quantize`."""
    _check_axis(quant_axis)
    q_re, q_im = payload
    if real_dtype not in _build.REAL_TYPES:
        raise InvalidParameterError(
            f"wire dequantize: expected float32 or float64, got {real_dtype}")
    for q in payload:
        _build.require(q, "wire dequantize payload", torch.int8,
                       q_re.shape, q_re.device)
    if q_re.dim() != 4:
        raise InvalidParameterError(
            f"wire dequantize: expected a (G, S, rows, elements) payload, "
            f"got {tuple(q_re.shape)}")
    _build.require(scales, "wire dequantize scales", torch.float32,
                   q_re.shape[:3], q_re.device)
    if not _build.on_cuda(q_re, "wire dequantize"):
        return dequantize_plain(payload, scales, quant_axis, real_dtype)
    g, s, rows, n = q_re.shape
    ms, mp = (rows, n) if quant_axis == 1 else (n, rows)
    out = tuple(torch.empty((g, s, ms, mp), dtype=real_dtype,
                            device=q_re.device) for _ in range(2))
    fn = _build.function(_SRC,
                         _build.entry("spfft_wire_dequantize", real_dtype),
                         _D_ARGS)
    _build.launch(fn, "wire dequantize kernel", q_re.device,
                  q_re.data_ptr(), q_im.data_ptr(), scales.data_ptr(),
                  g * s, ms, mp, quant_axis, out[0].data_ptr(),
                  out[1].data_ptr())
    dequantize.launches += 1
    return out


dequantize.launches = 0
