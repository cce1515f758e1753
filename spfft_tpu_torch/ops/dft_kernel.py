"""The DFT stage kernels: ports of ``spfft_tpu/ops/dft_kernel.py``
``pdft2``, ``pdft2_swapped``, ``prdft2`` and ``pdft2_cr`` (the Pallas
kernel ``_kernel2`` in modes ``cc``, ``rc`` and ``cr``, launched at
``dft_kernel.py:277``), and of ``pdft_last`` (the single-stage
``_stage_kernel``, launched at ``dft_kernel.py:165``).

* :func:`pdft_last` is one planar complex DFT along the minor axis,
  ``(..., K) -> (..., N)`` against ``mats`` ``(K, N)``: the z stage of
  the two-kernel route (rows are sticks), and the distributed plan's
  y and split-x stages.
* :func:`prdft_last` and :func:`pirdft_last` are one real DFT along the
  minor axis (real rows to the half spectrum, and back): the distributed
  R2C plan's x stage, which the JAX package runs outside any kernel;
  they are the real halves of :func:`prdft2` / :func:`pdft2_cr` alone.

* :func:`pdft2` maps planar complex ``(P, A, B)`` to ``(P, B', A')``: a
  DFT over the minor axis B against ``mats1`` ``(B, B')``, a swap of the
  two minor axes, a DFT over A against ``mats2`` ``(A, A')``.
* :func:`pdft2_swapped` is :func:`pdft2` with the result stored back in
  the input's axis order, ``(P, A', B')``: the C2C xy stage of the
  distributed plan, whose plane grid is ``(planes, dim_y, x)``.
* :func:`prdft2` (R2C forward head) takes a real ``(P, A, B)``; its first
  stage is the real DFT to the half spectrum (``mats1`` from
  ``dft.r2c_mats``).
* :func:`pdft2_cr` (R2C backward tail) returns a real ``(P, B', A')``;
  its second stage is the real inverse DFT (``mats2`` from
  ``dft.c2r_mats``).

All matrix pairs may be rectangular (the split-x window's row- and
column-selected matrices).

Forms. A complex (CC) stage whose matrices carry their function
(``dft.DftMats`` from ``dft.device_c2c``) with a length of the form
2^a 3^b 5^c runs as an FFT (``csrc/fft.cu``), bound by bytes: a CC plane
call whose plane fits one cluster of 8 blocks is ONE launch of the
cluster kernel (both FFTs and the swap with the intermediate in shared
memory, form ``"cluster"``), any other such stage one launch of the FFT
stage kernel (form ``"fft"``; a plane call is then two, the first
stored transposed within each plane). A real stage (modes rc and cr)
whose matrices carry their function (``dft.device_r2c`` /
``dft.device_c2r``) with an even length whose half is 2^a 3^b 5^c runs
as a real FFT, a half-length complex FFT and a pass over the pairs of
bins (``csrc/rfft.cu``, form ``"rfft"``, bound by bytes): ``prdft2`` and
``pdft2_cr`` are then one rfft and one fft launch. A stage with another
prime in its (half) length, an odd real length and a matrix pair without
its function run the matrix form (``csrc/dft2.cu``, form ``"matrix"``,
bound by FP32 operations). :func:`stage_form` and :func:`plane_forms`
are the dispatch, by shape and matrix alone.
Each wrapper counts its launches in ``.launches`` and by form in
``.form_launches`` (keyed by :data:`ALL_FORMS`). On a CPU tensor it runs
the plain version from :mod:`spfft_tpu_torch.ops.dft` (matrix products,
whatever the form).
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import InvalidParameterError
from . import _build, dft

_P = ctypes.c_void_p
_I = ctypes.c_int
#: ``mode`` argument of csrc/dft2.cu's ``spfft_dft_stage`` (``TileMode`` of
#: csrc/cdft_tile.cuh)
_MODES = {"cc": 0, "rc": 1, "cr": 2}
#: its argument types: the mode, the input planes, the matrix pair, the
#: output planes, then M, K, N, plane_rows and the stream
_ARGS = [_I] + [_P] * 6 + [ctypes.c_longlong, _I, _I, _I, _P]
#: csrc/fft.cu's ``spfft_fft_stage``: the input and output planes, the
#: twiddle table, M, K, N, plane_rows, the transform (n, sign, scale, in0,
#: out0, radices) and the stream
_FFT_STAGE_ARGS = [_P] * 5 + [ctypes.c_longlong, _I, _I, _I, _I, _I,
                              ctypes.c_float, _I, _I, _I, _P]
#: csrc/fft.cu's ``spfft_fft_plane``: the planes, both twiddle tables, P,
#: A, B, B', A', each transform's (n, sign, in0, out0, radices), the scale,
#: swap_out and the stream
_FFT_PLANE_ARGS = [_P] * 6 + [_I] * 15 + [ctypes.c_float, _I, _P]
#: csrc/rfft.cu's ``spfft_rfft_stage``: the mode, the input and output
#: planes, the twiddle table, M, K, N, plane_rows, the transform (n,
#: scale, the half-spectrum window's first bin, h's radices) and the
#: stream
_RFFT_ARGS = [_I] + [_P] * 5 + [ctypes.c_longlong, _I, _I, _I, _I,
                                ctypes.c_float, _I, _I, _P]
#: blocks of the cluster kernel's cluster (one plane), and the complex
#: elements one of its blocks holds (csrc/fft.cu's 512 threads x
#: fft_tile.cuh's EPT = 16)
CLUSTER_BLOCKS = 8
CLUSTER_BLOCK_ELEMS = 512 * 16
#: the forms of a complex stage
FORMS = ("matrix", "fft", "cluster")
#: every form a wrapper counts: a real stage's FFT form too
ALL_FORMS = FORMS + ("rfft",)
#: the kind of DftMats each real mode takes
_REAL_KIND = {"rc": "r2c", "cr": "c2r"}


def stage_form(mats) -> str:
    """The form of one stage against ``mats``: where the pair carries its
    function (``dft.DftMats``) and a factor list (``DftMats.factors``),
    ``"fft"`` for a complex pair and ``"rfft"`` for a real one (an even
    length whose half has an FFT factor list), else ``"matrix"``."""
    if getattr(mats, "twiddles", None) is None:
        return "matrix"
    return "fft" if mats.kind == "c2c" else "rfft"


def plane_forms(mats1, mats2, a: int) -> tuple:
    """The launches of one complex plane call on ``(P, a, B)`` planes,
    over B against ``mats1`` then over A against ``mats2``:
    ``("cluster",)`` where both stages take the FFT form and a plane fits
    one cluster (a block's ceil(a / 8) rows of length ``mats1.n`` and its
    ceil(B' / 8) columns of length ``mats2.n`` each within the elements it
    holds), else one launch per stage in its :func:`stage_form`."""
    forms = (stage_form(mats1), stage_form(mats2))
    if forms == ("fft", "fft"):
        b_out = mats1[0].shape[1]
        if max(-(-a // CLUSTER_BLOCKS) * mats1.n,
               -(-b_out // CLUSTER_BLOCKS) * mats2.n) <= CLUSTER_BLOCK_ELEMS:
            return ("cluster",)
    return forms


def _stage(mode: str, ins, mats, outs, plane_rows: int) -> str:
    """One launch of a stage kernel in ``mode``: rows of ``ins`` (minor
    axis K; one real plane in mode rc) against ``mats`` (K, N) into
    ``outs`` (one real plane in mode cr); the FFT stage kernel in mode cc
    and the real FFT stage kernel in modes rc and cr where
    :func:`stage_form` says so, else the matrix stage kernel. Returns the
    form."""
    k, n = mats[0].shape
    m = ins[0].numel() // k
    form = stage_form(mats)
    if form != "matrix" and mats.kind != _REAL_KIND.get(mode, "c2c"):
        raise InvalidParameterError(
            f"a {mats.kind} DFT spec cannot run a stage in mode {mode}")
    xr, xi = (*ins, None)[:2]
    yr, yi = (*outs, None)[:2]
    if form == "rfft":
        fn = _build.function("rfft.cu", "spfft_rfft_stage", _RFFT_ARGS)
        _build.launch(fn, f"rfft stage {mode}", xr.device, _MODES[mode],
                      *(None if t is None else t.data_ptr()
                        for t in (xr, xi, yr, yi, mats.twiddles)),
                      m, k, n, plane_rows, mats.n, mats.scale,
                      (mats.cols if mode == "rc" else mats.rows)[0],
                      dft.radix_code(mats.factors))
        return "rfft"
    if form == "fft":
        fn = _build.function("fft.cu", "spfft_fft_stage", _FFT_STAGE_ARGS)
        _build.launch(fn, "fft stage", ins[0].device,
                      *(t.data_ptr() for t in (*ins, *outs, mats.twiddles)),
                      m, k, n, plane_rows, mats.n, mats.sign, mats.scale,
                      mats.rows[0], mats.cols[0],
                      dft.radix_code(mats.factors))
        return "fft"
    fn = _build.function("dft2.cu", "spfft_dft_stage", _ARGS)
    _build.launch(fn, f"dft2 stage {mode}", xr.device, _MODES[mode],
                  *(None if t is None else t.data_ptr()
                    for t in (xr, xi, *mats, yr, yi)),
                  m, k, n, plane_rows)
    return "matrix"


def _plane(ins, mats1, mats2, outs, swap_out: bool) -> None:
    """One launch of the cluster kernel: ``(P, A, B)`` planes over B
    (``mats1``) then A (``mats2``) into ``(P, B', A')`` or, with
    ``swap_out``, ``(P, A', B')``."""
    p, a, b = ins[0].shape
    fn = _build.function("fft.cu", "spfft_fft_plane", _FFT_PLANE_ARGS)

    def spec(m):
        return (m.n, m.sign, m.rows[0], m.cols[0], dft.radix_code(m.factors))

    _build.launch(fn, "fft plane", ins[0].device,
                  *(t.data_ptr() for t in (*ins, *outs, mats1.twiddles,
                                           mats2.twiddles)),
                  p, a, b, mats1[0].shape[1], mats2[0].shape[1],
                  *spec(mats1), *spec(mats2), mats1.scale * mats2.scale,
                  int(swap_out))


def _check(name: str, ins, mats1, mats2):
    """The operand rules of the three wrappers; returns ``(p, a, b,
    b_out, a_out)``."""
    x = ins[0]
    if x.dim() != 3:
        raise InvalidParameterError(
            f"{name}: expected (P, A, B) operands, got {tuple(x.shape)}")
    p, a, b = x.shape
    b_out = mats1[0].shape[1]
    a_out = mats2[0].shape[1]
    dev = x.device
    _build.require(x, f"{name} input", torch.float32)
    for t in ins[1:]:
        _build.require(t, f"{name} input", torch.float32, x.shape, dev)
    for m, shape in ((mats1, (b, b_out)), (mats2, (a, a_out))):
        for c in m:
            _build.require(c, f"{name} matrix", torch.float32, shape, dev)
    return p, a, b, b_out, a_out


def _run2(wrapper, modes, ins, mats1, mats2, plain, swap_out=False):
    """The body of the four wrappers: one launch of the cluster kernel
    where :func:`plane_forms` says so (mode cc both stages), else a stage
    kernel in ``modes[0]`` stored transposed within each plane, then one in
    ``modes[1]`` stored straight (``(P, B', A')``) or, with ``swap_out``,
    transposed again (``(P, A', B')``), each launch counted in
    ``wrapper.launches`` and ``wrapper.form_launches``; ``plain`` on a CPU
    tensor. Mode cr as the second stage gives one real output."""
    name = wrapper.__name__
    p, a, b, b_out, a_out = _check(name, ins, mats1, mats2)
    x = ins[0]
    if not _build.on_cuda(x, name):
        return plain(*ins, mats1, mats2)
    real_out = modes[1] == "cr"
    oshape = (p, a_out, b_out) if swap_out else (p, b_out, a_out)
    out = tuple(torch.empty(oshape, dtype=torch.float32, device=x.device)
                for _ in range(1 if real_out else 2))
    if x.numel() == 0 or out[0].numel() == 0:
        for t in out:
            t.zero_()
    elif modes == ("cc", "cc") and plane_forms(mats1, mats2, a) == \
            ("cluster",):
        _plane(ins, mats1, mats2, out, swap_out)
        _build.count(wrapper, "cluster")
    else:
        mid = tuple(torch.empty((p, b_out, a), dtype=torch.float32,
                                device=x.device) for _ in range(2))
        _build.count(wrapper, _stage(modes[0], ins, mats1, mid,
                                     plane_rows=a))
        _build.count(wrapper, _stage(modes[1], mid, mats2, out,
                                     plane_rows=b_out if swap_out else 0))
    return out[0] if real_out else out


def _last(wrapper, mode: str, ins, mats, plain):
    """The body of the single-stage wrappers: one launch of a stage
    kernel in ``mode`` over the rows of ``ins`` (``(..., K)``; one real
    input in mode rc) against ``mats`` ``(K, N)``, stored straight
    (``(..., N)``; one real output in mode cr) and counted in
    ``wrapper``; ``plain`` on a CPU tensor."""
    name = wrapper.__name__
    x = ins[0]
    if x.dim() < 1:
        raise InvalidParameterError(
            f"{name}: expected (..., K) operands, got {tuple(x.shape)}")
    k = x.shape[-1]
    dev = x.device
    _build.require(x, f"{name} input", torch.float32)
    for t in ins[1:]:
        _build.require(t, f"{name} input", torch.float32, x.shape, dev)
    n = mats[0].shape[1] if mats[0].dim() == 2 else -1
    for c in mats:
        _build.require(c, f"{name} matrix", torch.float32, (k, n), dev)
    if not _build.on_cuda(x, name):
        return plain(*ins, mats)
    out = tuple(torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                            device=dev)
                for _ in range(1 if mode == "cr" else 2))
    if x.numel() == 0 or n == 0:
        for t in out:
            t.zero_()
    else:
        _build.count(wrapper, _stage(mode, ins, mats, out, plane_rows=0))
    return out[0] if mode == "cr" else out


def pdft_last(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Planar complex DFT along the minor axis, ``(..., K) -> (..., N)``
    against the ``(cr, ci)`` pair ``(K, N)``; any leading axes are rows.
    Each kernel launch (one per call) adds one to
    ``pdft_last.launches`` and to its form's count in
    ``pdft_last.form_launches``."""
    return _last(pdft_last, "cc", (xr, xi), mats, dft.pdft_last)


def prdft_last(x: torch.Tensor, mats):
    """Real DFT along the minor axis to the planar half spectrum, ``(...,
    n) -> (..., N)`` against the real pair ``mats`` ``(n, N)``
    (``dft.device_r2c`` or a plain ``dft.r2c_mats`` pair); any leading
    axes are rows. Each kernel launch (one per call) adds one to
    ``prdft_last.launches`` and to its form's count."""
    return _last(prdft_last, "rc", (x,), mats, dft.prdft_last)


def pirdft_last(yr: torch.Tensor, yi: torch.Tensor, mats):
    """Planar half spectrum to the real inverse DFT along the minor axis,
    ``(..., K) -> (..., n)`` against the real pair ``mats`` ``(K, n)``
    (``dft.device_c2r`` or a plain ``dft.c2r_mats`` pair); any leading
    axes are rows. Each kernel launch (one per call) adds one to
    ``pirdft_last.launches`` and to its form's count."""
    return _last(pirdft_last, "cr", (yr, yi), mats, dft.pirdft_last)


def pdft2(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, B', A')`` planar complex DFT over both minor
    axes; ``mats1``/``mats2`` are ``(cr, ci)`` pairs of shapes
    ``(B, B')`` and ``(A, A')``. Each kernel launch adds one to
    ``pdft2.launches`` (one per call in the cluster form, else two)."""
    return _run2(pdft2, ("cc", "cc"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor)


def pdft2_swapped(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, A', B')`` planar complex DFT over both minor
    axes, the result in the input's axis order: :func:`pdft2` with the
    last store transposed within each plane. Each kernel launch adds one
    to ``pdft2_swapped.launches`` (one per call in the cluster form, else
    two)."""
    return _run2(pdft2_swapped, ("cc", "cc"), (xr, xi), mats1, mats2,
                 dft.cdft2_xy, swap_out=True)


def prdft2(x: torch.Tensor, mats1, mats2):
    """Real ``(P, A, B) -> (P, B', A')`` planar: the real DFT over B to
    the half spectrum (``mats1`` ``(B, B')`` from ``dft.device_r2c``,
    ``dft.r2c_mats`` or its column window), swap, a complex DFT over A
    (``mats2`` ``(A, A')``). Each kernel launch adds one to
    ``prdft2.launches`` (two per call)."""
    return _run2(prdft2, ("rc", "cc"), (x,), mats1, mats2,
                 dft.prdft2_minor)


def pdft2_cr(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """Planar ``(P, A, B) -> `` real ``(P, B', A')``: a complex DFT over
    B (``mats1`` ``(B, B')``), swap, the real inverse DFT over A
    (``mats2`` ``(A, A')`` from ``dft.device_c2r``, ``dft.c2r_mats`` or
    its row window).
    Each kernel launch adds one to ``pdft2_cr.launches`` (two per
    call)."""
    return _run2(pdft2_cr, ("cc", "cr"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor_cr)


for _w in (pdft_last, prdft_last, pirdft_last, pdft2, pdft2_swapped,
           prdft2, pdft2_cr):
    _w.launches = 0
    _w.form_launches = dict.fromkeys(ALL_FORMS, 0)
