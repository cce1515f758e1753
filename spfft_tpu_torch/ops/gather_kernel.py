"""The sparse compression gather of the two-kernel route: port of
``spfft_tpu/ops/gather_kernel.py`` ``run_gather``, which reaches the
Pallas calls ``_monotone_gather_call`` (``gather_kernel.py:751``/``:778``),
``_monotone_gather_call_aliased`` (``:824``/``:848``) and
``_wide_gather_call`` (``:1119``/``:1145``), batched bodies
``_kernel_batched`` (``:627``) and ``_kernel_wide_batched`` (``:960``).
One CUDA kernel (``csrc/gather.cu``) covers all of them: they compute one
function, and their windows, selector words and segments are TPU
decompositions.

* :func:`gather` — ``out[s, b, j] = src[s, b, idx[s, j]]`` where
  ``valid[s, j]`` and ``0 <= idx[s, j] < n``, else 0, on planar
  float32 or float64 views (``spfft_gather`` or ``spfft_gather_f64``,
  one template's two instances; source and output of one type) with a
  leading shard axis (optional: a local plan's tables have none) and
  batch, in one launch whatever S and B are.
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
_I = ctypes.c_int
_ARGS = [_P, _P, _LL, _LL, _LL, _LL, _P, _LL, _P, _LL, _P, _P, _LL, _LL, _LL,
         _LL, _I, _I, _I, _P]  # the last: the stream

#: csrc/gather.cu's layout word: which accesses may be wide in every group
#: of slots (:func:`_layout_word` sets it from the operands)
IDX_VEC, VALID_VEC, SRC_PAIR, OUT_PLANAR, OUT_PAIR = 1, 2, 4, 8, 16
MAX_SHARDS = 65535  # the grid's y extent


def _strides(t: torch.Tensor, sharded: bool) -> list:
    """``t``'s strides with the shard axis first (0 where ``t`` has none)
    and 0 along an axis of length 1 (never stepped)."""
    st = [st if n > 1 else 0 for n, st in zip(t.shape, t.stride())]
    return st if sharded else [0] + st


def _layout_word(src, src_st, idx_ptr, idx_sst, valid_ptr, valid_sst, out,
                 out_st, esize: int) -> int:
    """csrc/gather.cu's layout word from the planes' addresses (``src``,
    ``out``: (re, im) pairs), their (shard, batch, element) strides, the
    tables' addresses and shard strides (``valid_ptr`` None: no mask)
    and the planes' element size ``esize`` in bytes (4 or 8): each wide
    access only where every group of 4 slots finds it aligned. A pair
    (re, im) is 2 ``esize`` bytes and must lie on a multiple of that; a
    planar group's 16-byte stores need its start on 16 bytes."""
    word = 0
    if idx_ptr % 16 == 0 and idx_sst % 4 == 0:
        word |= IDX_VEC
    if valid_ptr is not None and valid_ptr % 4 == 0 and valid_sst % 4 == 0:
        word |= VALID_VEC
    pair = 2 * esize
    per16 = 16 // esize  # elements in 16 bytes
    (re, im), (ss, sb, se) = src, src_st
    if se == 2 and im == re + esize and re % pair == 0 and ss % 2 == 0 \
            and sb % 2 == 0:
        word |= SRC_PAIR
    (re, im), (os_, ob, oe) = out, out_st
    if oe == 1 and re % 16 == 0 and im % 16 == 0 and os_ % per16 == 0 \
            and ob % per16 == 0:
        word |= OUT_PLANAR
    elif oe == 2 and im == re + esize and re % pair == 0 and os_ % 2 == 0 \
            and ob % 2 == 0:
        word |= OUT_PAIR
    return word


def _shard_form(src, idx, out, valid):
    """The operands of the form without a shard axis as one shard."""
    if idx.dim() == 2:
        return src, idx, out, valid
    return (tuple(t.unsqueeze(0) for t in src), idx.unsqueeze(0),
            tuple(t.unsqueeze(0) for t in out),
            None if valid is None else valid.unsqueeze(0))


def gather_plain(src, idx, out, valid=None) -> None:
    """Plain version of :func:`gather` (same operands): every invalid or
    out-of-range index becomes the sentinel ``n``, and
    :func:`~spfft_tpu_torch.ops.stages.gather_rows_with_sentinel` reads
    each shard's rows (one row per source slot, one column per batch
    element)."""
    src, idx, out, valid = _shard_form(src, idx, out, valid)
    n = src[0].shape[-1]
    i = idx.long()
    bad = (i < 0) | (i >= n)
    if valid is not None:
        bad |= ~valid
    i = torch.where(bad, n, i)
    for s, o in zip(src, out):
        for r in range(i.shape[0]):
            o[r].copy_(stages.gather_rows_with_sentinel(s[r].t(), i[r]).t())


def _check_planes(name, planes, dims, shape=None, dtype=None):
    """Two views of ``dims`` axes on one device with equal strides, of
    ``dtype`` (where None, of one type, float32 or float64); returns
    their dtype."""
    re, im = planes
    if dtype is None:
        dtype = getattr(re, "dtype", None)
        if dtype not in _build.REAL_TYPES:
            dtype = torch.float32
    for t in planes:
        if not isinstance(t, torch.Tensor) or t.dtype != dtype:
            got = getattr(t, 'dtype', type(t).__name__)
            raise InvalidParameterError(
                f"gather {name}: expected {dtype} tensors, got {got} "
                f"(both planes of the source and of the output share one "
                f"real type, float32 or float64)")
        if t.dim() != dims:
            raise InvalidParameterError(
                f"gather {name}: expected "
                f"{'(shards, batch, n)' if dims == 3 else '(batch, n)'} "
                f"views, got {tuple(t.shape)}")
    if re.shape != im.shape or re.stride() != im.stride() \
            or re.device != im.device:
        raise InvalidParameterError(
            f"gather {name}: the real and imaginary views differ in shape, "
            f"strides or device")
    if shape is not None and re.shape != shape:
        raise InvalidParameterError(
            f"gather {name}: expected shape {tuple(shape)}, got "
            f"{tuple(re.shape)}")
    return dtype


def _check_table(t, name, dtype, shape, device) -> None:
    """A table of ``dtype`` and ``shape`` on ``device`` whose rows are
    contiguous (the rows of a 2-D table may lie any stride apart)."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise InvalidParameterError(
            f"{name}: expected a {dtype} tensor, got "
            f"{getattr(t, 'dtype', type(t).__name__)}")
    if t.shape != shape:
        raise InvalidParameterError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise InvalidParameterError(
            f"{name}: expected a tensor on {device}, got {t.device}")
    if shape[-1] > 1 and t.stride(-1) != 1:
        raise InvalidParameterError(f"{name}: expected contiguous rows")


def gather(src, idx: torch.Tensor, out, valid=None) -> None:
    """``out[k][s, b, j] = src[k][s, b, idx[s, j]]`` where ``valid[s, j]``
    (every slot when None) and ``0 <= idx[s, j] < n``, else 0, for the
    real and imaginary ``k``, in place.

    ``src`` and ``out`` are ``(re, im)`` pairs of ``(S, B, n)`` and
    ``(S, B, num_out)`` views, all four float32 or all four float64 (any
    strides, the two views of a pair alike, so interleaved rows and
    planar planes are both views);
    ``idx`` is int32 ``(S, num_out)`` and ``valid`` bool ``(S, num_out)``,
    each with contiguous rows. Stacked per-shard tables pad each shard
    with indices at or past ``n``, which give 0. Without the shard axis
    (``(B, n)`` views, ``idx`` and ``valid`` ``(num_out,)``) it is one
    shard. Each kernel launch (one per call, whatever S and B are) adds
    one to ``gather.launches``."""
    if not isinstance(idx, torch.Tensor) or idx.dim() not in (1, 2):
        raise InvalidParameterError(
            f"gather idx: expected a (num_out,) or (shards, num_out) "
            f"tensor, got {getattr(idx, 'shape', type(idx).__name__)}")
    sharded = idx.dim() == 2
    dtype = _check_planes("source", src, 2 + sharded)
    shape = src[0].shape
    n, num_out = shape[-1], idx.shape[-1]
    dev = src[0].device
    table = (shape[0], num_out) if sharded else (num_out,)
    _check_table(idx, "gather idx", torch.int32, table, dev)
    _check_planes("output", out, 2 + sharded, shape[:-1] + (num_out,),
                  dtype)
    if out[0].device != dev:
        raise InvalidParameterError(
            f"gather output: expected a tensor on {dev}, got "
            f"{out[0].device}")
    if valid is not None:
        _check_table(valid, "gather valid", torch.bool, table, dev)
    if not _build.on_cuda(src[0], "gather"):
        gather_plain(src, idx, out, valid)
        return
    shards, b = shape[:2] if sharded else (1, shape[0])
    if b > 2**31 - 1 or shards > MAX_SHARDS:
        raise InvalidParameterError(
            f"gather: {shards} shards x batch {b} above the kernel's grid "
            f"({MAX_SHARDS} shards, batch 2^31 - 1)")
    if shards == 0 or b == 0 or num_out == 0:
        return
    fn = _build.function(_SRC, _build.entry("spfft_gather", dtype), _ARGS)
    src_p = (src[0].data_ptr(), src[1].data_ptr())
    out_p = (out[0].data_ptr(), out[1].data_ptr())
    src_st, out_st = _strides(src[0], sharded), _strides(out[0], sharded)
    idx_p = idx.data_ptr()
    idx_sst = idx.stride(0) if sharded and shards > 1 else 0
    valid_p, valid_sst = (None, 0) if valid is None else \
        (valid.data_ptr(), valid.stride(0) if sharded and shards > 1 else 0)
    _build.launch(
        fn, "gather kernel", dev, *src_p, src_st[2], src_st[1], src_st[0], n,
        idx_p, idx_sst, valid_p, valid_sst, *out_p, out_st[2], out_st[1],
        out_st[0], num_out, b, shards,
        _layout_word(src_p, src_st, idx_p, idx_sst, valid_p, valid_sst,
                     out_p, out_st, src[0].element_size()))
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
    slot_src.numel() // dim_z, dim_z)`` of the values' real type
    (leading B when ``values`` is batched): every slot written, the
    sentinel ``num_values`` as 0 (the plan's trailing sentinel stick
    comes out as zeros)."""
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
    sr = torch.empty(shape, dtype=values.dtype, device=values.device)
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
             pair: bool = False, out: torch.Tensor = None) -> torch.Tensor:
    """Planar sticks ``(B?, S, dim_z)`` -> the sparse values at the flat
    slots ``value_indices`` (int32), ``(B?, N, 2)`` (``(B?, 2, N)`` with
    ``pair``) of the sticks' real type, written into ``out`` where given
    (a contiguous tensor of that shape and type, which is returned)."""
    if sr.dim() not in (2, 3):
        raise InvalidParameterError(
            f"compress: expected (B?, S, dim_z) sticks, got "
            f"{tuple(sr.shape)}")
    dtype = _build.call_dtype(sr, "compress sticks")
    for t in (sr, si):
        _build.require(t, "compress sticks", dtype, sr.shape)
    batch = sr.shape[0] if sr.dim() == 3 else None
    flat = (1 if batch is None else batch, sr.shape[-2] * sr.shape[-1])
    shape = values_shape(batch, value_indices.numel(), pair)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=sr.device)
    else:
        _build.require(out, "compress out", dtype, shape, sr.device)
    gather((sr.view(flat), si.view(flat)), value_indices,
           value_planes(out, pair))
    return out
