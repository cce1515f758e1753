"""Sparse compression fused with the z-stick DFT: ports of
``spfft_tpu/ops/fused_kernel.py`` ``run_decompress_zdft`` (Pallas call at
``fused_kernel.py:587``) and ``run_zdft_compress`` (``:783``).

* :func:`decompress_zdft` (backward): sparse values -> z-transformed
  planar sticks, gathering through the plan-time inverse map
  ``slot_src`` (sentinel ``num_values`` = empty slot). For an R2C plan
  it completes the (x=0, y=0) stick before the z-DFT (the TPU kernel's
  ``_complete_zero_stick``, ``fused_kernel.py:350``).
* :func:`zdft_compress` (forward): raw planar sticks -> z-DFT (any FULL
  scale carried by the z matrices) -> the sparse values, written through
  a plan-time CSR by stick (:func:`compress_csr`).

Both kernels hold a whole stick in shared memory, so they take a z axis
of at most ``dft.MATMUL_DFT_MAX``; a longer one is declined
(:func:`eligible_dim`, the JAX package's reason ``"dimz_over_cap"``,
``spfft_tpu/ops/fused_kernel.py:139-149``) and the plan takes the
two-kernel route, whose z stage runs the long forms.

Forms, chosen by shape (:func:`z_form`): z tables that carry their
function (``dft.DftMats``) in the length's own form run the FFT form
where dim_z is 2^a 3^b 5^c 7^d 11^e (``csrc/fused_fft.cu``: the gather
fused with a Stockham FFT in shared memory, ``csrc/fft_tile.cuh``) and
the Bluestein form at any other dim_z up to 512, a prime of 13 or more
(``csrc/fused_bluestein.cu``: the gather fused with Bluestein's chirp-z
FFT, ``csrc/bluestein.cuh``), both bound by bytes; a plain matrix pair
(or tables built in the matrix form) runs the matrix form
(``csrc/fused_compress.cu``: the z-DFT as a product against the matrix
pair, bound by operations), which no plan hands them. On a CUDA tensor
each wrapper launches the kernel of its form; on a CPU tensor it runs
the plain version beside it, whatever the form. Values are in the
plan's public layout: interleaved ``(N, 2)``, or the planar pair ``(2,
N)`` when ``pair`` is set. Values, sticks, matrices and twiddle table
share one real type, float32 or float64 (a double-precision plan's: the
entries with the suffix ``_f64``); a mixture is refused.

Both wrappers also take a leading batch ``B`` (values ``(B, N, 2)`` or
``(B, 2, N)``, sticks ``(B, S, dim_z)``): B transforms over one plan's
tables in ONE launch, the batched grids of the TPU kernels
(``_kernel_dec_zdft_batched``, ``_kernel_zdft_cmp_batched``). A launch
counts once whatever B is, in ``.launches`` and in ``.form_launches``
by form.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import faults
from ..errors import InvalidParameterError
from . import _build, dft, dft_kernel, stages

_SRC = "fused_compress.cu"
_FFT_SRC = "fused_fft.cu"
_BL_SRC = "fused_bluestein.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_DEC_ARGS = [_P] * 6 + [_LL, _I, _LL, _I, _LL, _I, _P]
_CMP_ARGS = [_P] * 8 + [_LL, _I, _LL, _I, _I, _P]


def _spec_args(real):
    """The transform's (n, sign, scale (ctypes type ``real``), in0, out0,
    radices) arguments of csrc/fused_fft.cu's entries, and the stream."""
    return [_I, _I, real, _I, _I, _I, _P]


def _fft_dec_args(real):
    """spfft_decompress_zdft_fft: values, slot_src, the twiddle table,
    the output sticks, num_sticks, N, pair, zero_stick, batch, the
    transform."""
    return [_P] * 5 + [_LL, _I, _I, _LL, _I] + _spec_args(real)


def _fft_cmp_args(real):
    """spfft_zdft_compress_fft: the sticks, the twiddle table, the CSR,
    the values, num_sticks, N, pair, batch, the transform."""
    return [_P] * 7 + [_LL, _I, _I, _I] + _spec_args(real)


#: csrc/fused_bluestein.cu's transform arguments: n, the windows' first
#: positions x0 and y0, M, m1, m2, the factors' radices, the paths (bit
#: 0 / bit 1: m1 / m2 in registers), and the stream
_BL_SPEC_ARGS = [_I] * 9 + [_P]
#: spfft_decompress_zdft_bluestein: values, slot_src, the chirp, spectrum
#: and twiddle tables, the output sticks, num_sticks, N, pair, zero_stick,
#: batch, the transform
_BL_DEC_ARGS = [_P] * 7 + [_LL, _I, _I, _LL, _I] + _BL_SPEC_ARGS
#: spfft_zdft_compress_bluestein: the sticks, the tables, the CSR, the
#: values, num_sticks, N, pair, batch, the transform
_BL_CMP_ARGS = [_P] * 9 + [_LL, _I, _I, _I] + _BL_SPEC_ARGS


#: largest batch of one launch (the grid's y extent)
MAX_BATCH = 65535
FORMS = ("matrix", "fft", "bluestein")


#: the longest z axis the fused kernels hold
MAX_DIM_Z = dft.MATMUL_DFT_MAX


def eligible_dim(dim_z: int):
    """None where the fused kernels take a z axis of ``dim_z``, else the
    reason they decline it, as the JAX package's ``eligible_dim`` words
    it: ``"dimz_over_cap"`` above :data:`MAX_DIM_Z`."""
    return None if int(dim_z) <= MAX_DIM_Z else "dimz_over_cap"


def _require_eligible(dim_z: int, name: str) -> None:
    why = eligible_dim(dim_z)
    if why is not None:
        raise InvalidParameterError(
            f"{name}: the fused kernels decline dim_z={dim_z} ({why}: above "
            f"{MAX_DIM_Z}); a plan takes the two-kernel route there")


class SeamKeys:
    """The executables whose trace-time seams have passed: a set of keys
    (:func:`trace_seam`). A callable in a key (a round trip's ``fn``) is
    held weakly where it can be, so a key of a dropped callable leaves the
    set and pins nothing the callable captured. The JAX package's jit
    cache holds its ``fn`` for the plan's lifetime; here a fresh callable
    per call still consults the seams afresh, as a fresh one recompiles
    there, but the set does not grow."""

    def __init__(self):
        self._keys = set()

    @staticmethod
    def _held(part, callback=None):
        if callable(part):
            try:
                return weakref.ref(part, callback)
            except TypeError:  # a builtin: no weak reference, lives on
                pass
        return part

    def __contains__(self, key) -> bool:
        return tuple(self._held(p) for p in key) in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    def add(self, key) -> None:
        self._keys.add(tuple(self._held(p, self._drop) for p in key))

    def _drop(self, ref) -> None:
        self._keys = {k for k in self._keys if not any(p is ref for p in k)}

    def keep(self, pred) -> None:
        """Keep only the keys ``pred`` accepts."""
        self._keys = {k for k in self._keys if pred(k)}


def trace_seam(seen: SeamKeys, key) -> None:
    """The ``kernel.launch`` fault seam of the JAX package's fused kernels
    (``spfft_tpu/ops/fused_kernel.py:520``, ``:719``), which fires at
    trace time, once per compiled executable: here, on the first call of
    ``key`` (a plan's name for the executable the JAX package's jit
    caches would compile: entry, direction, scaling, batch), recorded in
    ``seen`` once the check has passed (a firing check leaves the key
    unseen, as a failed trace leaves no executable)."""
    if key not in seen:
        faults.check_site("kernel.launch")
        seen.add(key)


def z_form(mats, dim_z: int) -> str:
    """The form of a fused z kernel against the z tables ``mats``:
    ``"fft"`` where they carry their function with an FFT factor list
    (:func:`~spfft_tpu_torch.ops.dft_kernel.stage_form`) over the whole
    stick (length ``dim_z``), ``"bluestein"`` where they carry it with
    Bluestein tables (a dim_z with a prime of 13 or more), else
    ``"matrix"`` (a plain pair, or tables built in the matrix form).
    Raises :class:`~spfft_tpu_torch.errors.InvalidParameterError` for
    tables of another form that hold no matrix pair."""
    form = dft_kernel.stage_form(mats)
    if form in ("fft", "bluestein") and mats.n == dim_z:
        return form
    if len(mats) != 2:
        raise InvalidParameterError(
            f"the fused z kernels take the FFT, Bluestein or matrix form "
            f"of a length-{dim_z} DFT, not {form!r} of length "
            f"{getattr(mats, 'n', None)}")
    return "matrix"


def _spec(mats) -> tuple:
    """The transform arguments of csrc/fused_fft.cu's entries."""
    return (mats.n, mats.sign, mats.scale, mats.rows[0], mats.cols[0],
            dft.radix_code(mats.factors))


def _bl_spec(mats, dtype) -> tuple:
    """The tables and transform arguments of csrc/fused_bluestein.cu's
    entries: the chirp, spectrum and twiddle pointers, then n, x0, y0 and
    :func:`~spfft_tpu_torch.ops.dft_kernel.bluestein_split_args`."""
    return (tuple(t.data_ptr() for t in mats.bluestein),
            (mats.n, mats.rows[0], mats.cols[0],
             *dft_kernel.bluestein_split_args(mats, dtype, _BL_SRC)))


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


def _batch(lead: tuple, what: str) -> int:
    """The batch of a launch: 1 unbatched, else B (at most MAX_BATCH)."""
    b = lead[0] if lead else 1
    if b > MAX_BATCH:
        raise InvalidParameterError(
            f"{what}: batch {b} above {MAX_BATCH} per launch")
    return b


# -- backward: gather-decompress -> z-DFT ------------------------------------

def decompress_zdft_plain(values, slot_src, mats, dim_z: int, pair: bool,
                          zero_stick: int = -1):
    """Plain version of :func:`decompress_zdft`: sentinel row gather,
    :func:`~spfft_tpu_torch.ops.stages.complete_stick_hermitian` on the
    zero stick, then :func:`~spfft_tpu_torch.ops.dft.pdft_last`."""
    rows = values.transpose(-1, -2) if pair else values
    flat = stages.gather_rows_with_sentinel(rows, slot_src.long())
    shape = values.shape[:-2] + (slot_src.numel() // dim_z, dim_z)
    sr = flat[..., 0].reshape(shape)
    si = flat[..., 1].reshape(shape)
    if zero_stick >= 0:  # in place: flat is this function's own copy
        sr[..., zero_stick, :], si[..., zero_stick, :] = \
            stages.complete_stick_hermitian(sr[..., zero_stick, :],
                                            si[..., zero_stick, :])
    return dft.pdft_last(sr, si, mats)


def decompress_zdft(values: torch.Tensor, slot_src: torch.Tensor, mats,
                    dim_z: int, pair: bool = False, zero_stick: int = -1):
    """Sparse values -> z-transformed planar sticks ``(sr, si)``, each
    ``(B?, slot_src.numel() // dim_z, dim_z)`` of the values' real type.

    ``values`` is ``(B?, N, 2)`` (``(B?, 2, N)`` with ``pair``), float32
    or float64, and ``mats`` of the same type;
    ``slot_src`` is the int32 inverse slot map, sentinel N = zero;
    ``mats`` the backward z pair ``(dim_z, dim_z)``; ``zero_stick`` the
    stick to complete hermitian before the z-DFT (an R2C plan's (0,0)
    stick; -1 = none), in every batch element. Every output slot is
    written. Each kernel launch (one per call, whatever B is) adds one to
    ``decompress_zdft.launches`` and to its :func:`z_form`'s count in
    ``decompress_zdft.form_launches``."""
    if values.dim() not in (2, 3):
        raise InvalidParameterError(
            f"decompress_zdft: expected (B?, N, 2) or (B?, 2, N) values, got "
            f"{tuple(values.shape)}")
    dtype = _build.call_dtype(values, "decompress_zdft values")
    lead = tuple(values.shape[:-2])
    n = values.shape[-1] if pair else values.shape[-2]
    dev = values.device
    _build.require(values, "decompress_zdft values", dtype,
                   lead + _values_shape(n, pair))
    _build.require(slot_src, "decompress_zdft slot_src", torch.int32,
                   device=dev)
    if slot_src.dim() != 1 or slot_src.numel() % dim_z:
        raise InvalidParameterError(
            f"decompress_zdft: slot_src must be flat with a multiple of "
            f"dim_z={dim_z} slots, got {tuple(slot_src.shape)}")
    _require_eligible(dim_z, "decompress_zdft")
    _build.require_mats(mats, "decompress_zdft", dtype, (dim_z, dim_z), dev)
    form = z_form(mats, dim_z)
    num_sticks = slot_src.numel() // dim_z
    if not -1 <= zero_stick < num_sticks:
        raise InvalidParameterError(
            f"decompress_zdft: zero_stick {zero_stick} is not a stick of "
            f"{num_sticks} (or -1)")
    batch = _batch(lead, "decompress_zdft")
    if not _build.on_cuda(values, "decompress_zdft"):
        return decompress_zdft_plain(values, slot_src, mats, dim_z, pair,
                                     zero_stick)
    sr = torch.empty(lead + (num_sticks, dim_z), dtype=dtype, device=dev)
    si = torch.empty_like(sr)
    if num_sticks == 0 or batch == 0:
        return sr, si
    if form == "fft":
        fn = _build.function(_FFT_SRC,
                             _build.entry("spfft_decompress_zdft_fft", dtype),
                             _fft_dec_args(_build.REAL_TYPES[dtype]))
        _build.launch(fn, "decompress_zdft fft kernel", dev,
                      values.data_ptr(), slot_src.data_ptr(),
                      mats.twiddles.data_ptr(), sr.data_ptr(), si.data_ptr(),
                      num_sticks, n, int(pair), int(zero_stick), batch,
                      *_spec(mats))
    elif form == "bluestein":
        tables, spec = _bl_spec(mats, dtype)
        fn = _build.function(
            _BL_SRC, _build.entry("spfft_decompress_zdft_bluestein", dtype),
            _BL_DEC_ARGS)
        _build.launch(fn, "decompress_zdft bluestein kernel", dev,
                      values.data_ptr(), slot_src.data_ptr(), *tables,
                      sr.data_ptr(), si.data_ptr(), num_sticks, n,
                      int(pair), int(zero_stick), batch, *spec)
    else:
        fn = _build.function(_SRC,
                             _build.entry("spfft_decompress_zdft", dtype),
                             _DEC_ARGS)
        _build.launch(fn, "decompress_zdft kernel", dev, values.data_ptr(),
                      slot_src.data_ptr(), mats[0].data_ptr(),
                      mats[1].data_ptr(), sr.data_ptr(), si.data_ptr(),
                      num_sticks, dim_z, n, int(pair), int(zero_stick),
                      batch)
    _build.count(decompress_zdft, form)
    return sr, si


# -- forward: z-DFT -> compress ----------------------------------------------

def zdft_compress_plain(sr, si, mats, csr, pair: bool):
    """Plain version of :func:`zdft_compress`:
    :func:`~spfft_tpu_torch.ops.dft.pdft_last`, then an indexed gather of
    the CSR's slots."""
    stick_ptr, val_id, val_z = csr
    yr, yi = dft.pdft_last(sr, si, mats)
    lead = tuple(sr.shape[:-2])
    num_sticks, dim_z = sr.shape[-2:]
    counts = (stick_ptr[1:] - stick_ptr[:-1]).long()
    stick = torch.repeat_interleave(
        torch.arange(num_sticks, device=sr.device), counts)
    slot = stick * dim_z + val_z.long()
    vid = val_id.long()
    out = torch.empty(lead + _values_shape(val_id.numel(), pair),
                      dtype=sr.dtype, device=sr.device)
    re, im = (out[..., 0, :], out[..., 1, :]) if pair \
        else (out[..., 0], out[..., 1])
    re[..., vid] = yr.flatten(-2)[..., slot]
    im[..., vid] = yi.flatten(-2)[..., slot]
    return out


def zdft_compress(sr: torch.Tensor, si: torch.Tensor, mats, csr,
                  pair: bool = False, out: torch.Tensor = None):
    """Raw planar sticks ``(B?, num_sticks, dim_z)`` -> z-DFT -> the
    sparse values, ``(B?, N, 2)`` (``(B?, 2, N)`` with ``pair``) of the
    sticks' real type (float32 or float64, the matrices' too).

    ``mats`` is the forward z pair, any FULL scale folded into its
    matrices and carried as its ``scale``; ``csr`` is
    :func:`compress_csr`'s ``(stick_ptr, val_id, val_z)`` as int32
    tensors. Each value is written exactly once, into ``out`` where it
    is given (a contiguous tensor of the result's shape and type, which
    is returned: a plan's donated values). Each kernel launch (one
    per call, whatever B is) adds one to ``zdft_compress.launches`` and to
    its :func:`z_form`'s count in ``zdft_compress.form_launches``."""
    if sr.dim() not in (2, 3):
        raise InvalidParameterError(
            f"zdft_compress: expected (B?, num_sticks, dim_z) sticks, got "
            f"{tuple(sr.shape)}")
    lead = tuple(sr.shape[:-2])
    num_sticks, dim_z = sr.shape[-2:]
    dev = sr.device
    stick_ptr, val_id, val_z = csr
    n = val_id.numel()
    dtype = _build.call_dtype(sr, "zdft_compress sr")
    _build.require(sr, "zdft_compress sr", dtype)
    _build.require(si, "zdft_compress si", dtype, sr.shape, dev)
    _require_eligible(dim_z, "zdft_compress")
    _build.require_mats(mats, "zdft_compress", dtype, (dim_z, dim_z), dev)
    form = z_form(mats, dim_z)
    _build.require(stick_ptr, "zdft_compress stick_ptr", torch.int32,
                   (num_sticks + 1,), dev)
    _build.require(val_id, "zdft_compress val_id", torch.int32, (n,), dev)
    _build.require(val_z, "zdft_compress val_z", torch.int32, (n,), dev)
    batch = _batch(lead, "zdft_compress")
    shape = lead + _values_shape(n, pair)
    if out is not None:
        _build.require(out, "zdft_compress out", dtype, shape, dev)
    if not _build.on_cuda(sr, "zdft_compress"):
        res = zdft_compress_plain(sr, si, mats, csr, pair)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=dev)
    if num_sticks == 0 or batch == 0:
        return out
    if form == "fft":
        fn = _build.function(_FFT_SRC,
                             _build.entry("spfft_zdft_compress_fft", dtype),
                             _fft_cmp_args(_build.REAL_TYPES[dtype]))
        _build.launch(fn, "zdft_compress fft kernel", dev, sr.data_ptr(),
                      si.data_ptr(), mats.twiddles.data_ptr(),
                      stick_ptr.data_ptr(), val_id.data_ptr(),
                      val_z.data_ptr(), out.data_ptr(), num_sticks, n,
                      int(pair), batch, *_spec(mats))
    elif form == "bluestein":
        tables, spec = _bl_spec(mats, dtype)
        fn = _build.function(
            _BL_SRC, _build.entry("spfft_zdft_compress_bluestein", dtype),
            _BL_CMP_ARGS)
        _build.launch(fn, "zdft_compress bluestein kernel", dev,
                      sr.data_ptr(), si.data_ptr(), *tables,
                      stick_ptr.data_ptr(), val_id.data_ptr(),
                      val_z.data_ptr(), out.data_ptr(), num_sticks, n,
                      int(pair), batch, *spec)
    else:
        fn = _build.function(_SRC, _build.entry("spfft_zdft_compress", dtype),
                             _CMP_ARGS)
        _build.launch(fn, "zdft_compress kernel", dev, sr.data_ptr(),
                      si.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(),
                      stick_ptr.data_ptr(), val_id.data_ptr(),
                      val_z.data_ptr(), out.data_ptr(), num_sticks, dim_z, n,
                      int(pair), batch)
    _build.count(zdft_compress, form)
    return out


for _w in (decompress_zdft, zdft_compress):
    _w.launches = 0
    _w.form_launches = dict.fromkeys(FORMS, 0)
