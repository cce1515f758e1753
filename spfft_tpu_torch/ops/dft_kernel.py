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
2^a 3^b 5^c 7^d 11^e runs as an FFT (``csrc/fft.cu``), bound by bytes: a
CC plane call whose lengths have radices 2-5 alone and whose plane fits
one cluster of 8 blocks is ONE launch of the cluster kernel (both FFTs
and the swap with the intermediate in shared memory, form ``"cluster"``),
any other such stage one launch of the FFT stage kernel (form ``"fft"``;
a plane call is then two, the first stored transposed within each
plane). A real stage (modes rc and cr) whose matrices carry their
function (``dft.device_r2c`` / ``dft.device_c2r``) with an even length
whose half is 2^a 3^b 5^c 7^d 11^e runs as a real FFT, a half-length
complex FFT and a pass over the pairs of bins (``csrc/rfft.cu``, form
``"rfft"``, bound by bytes): ``prdft2`` and ``pdft2_cr`` are then one
rfft and one fft launch. A stage with a prime of 13 or more in its
(half) length, and an odd real length, runs Bluestein's FFT (below). A
matrix pair without its function (or a ``DftMats`` of the matrix form)
runs the matrix form (``csrc/dft2.cu``, form ``"matrix"``, bound by
operations). :func:`stage_form` and :func:`plane_forms` are the
dispatch, by shape and matrix alone.

Long axes (above ``dft.MATMUL_DFT_MAX``, routed by length at plan time,
``dft.c2c_form`` / ``dft.real_form``). A complex stage with a split n =
n1 n2 runs the two-pass FFT (``csrc/fft_long.cu``, form ``"two_pass"``:
a pass over n1 with the twiddle W_n^(i2 k1) in its epilogue, then a pass
over n2 whose store puts the bins in natural order, straight or
transposed within each plane as the stage kernels store; one launch a
stage where a row fits a block, :func:`long_row_max`, else one a pass),
held to the two-stage product (``dft.two_pass_plain``); each factor
with a register plan (:func:`reg_plan`) runs its FFT in registers, any
other the shared-memory path of the same kernel (the wrapper passes
which, ``paths``). Every complex stage up to 1024 with no FFT or
two-pass form (a prime of 13 or more) and every real stage up to 1024
with no real FFT form run Bluestein's chirp-z FFT, one launch of
``csrc/bluestein.cu`` (form ``"bluestein"``: two length-M FFTs in one
block, M = ``dft.bluestein_length(n)``), held to
``dft.bluestein_plain``; a real stage up to 1024 whose half is 2^a 3^b
5^c 7^d 11^e runs the real FFT form; anything longer ``torch.fft`` (form
``"library"``: a PyTorch call, not a kernel of this package, so it
counts by form only, never in ``.launches``). The two-pass and
``torch.fft`` forms run whole axes: a window is expanded to the whole
axis before them and taken out after (the JAX package's
``_expand_x_window`` / ``_extract_x_window``); the Bluestein kernel
takes the windows itself. :func:`plane_forms` never takes the cluster
form for a long stage.

Every operand, matrix and twiddle table of a call shares one real type,
float32 or float64 (a double-precision plan's); the wrappers take the
kernels' entry for it (``spfft_fft_stage`` or ``spfft_fft_stage_f64``,
one template's two instances) and refuse a mixture. A float64 launch
counts under the same form as a float32 one.
Each wrapper counts its launches in ``.launches`` and by form in
``.form_launches`` (keyed by :data:`ALL_FORMS`). On a CPU tensor it runs
the plain version from :mod:`spfft_tpu_torch.ops.dft` (matrix products,
the two-stage product or ``torch.fft``, whatever the form).
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


def _fft_stage_args(real):
    """csrc/fft.cu's ``spfft_fft_stage``: the input and output planes,
    the twiddle table, M, K, N, plane_rows, the transform (n, sign, scale
    of ctypes type ``real``, in0, out0, radices) and the stream."""
    return [_P] * 5 + [ctypes.c_longlong, _I, _I, _I, _I, _I, real, _I, _I,
                       _I, _P]


def _fft_plane_args(real):
    """csrc/fft.cu's ``spfft_fft_plane``: the planes, both twiddle
    tables, P, A, B, B', A', each transform's (n, sign, in0, out0,
    radices), the scale (``real``), swap_out and the stream."""
    return [_P] * 6 + [_I] * 15 + [real, _I, _P]


def _long_args(real):
    """csrc/fft_long.cu's ``spfft_fft_long``: the pass (0: both in one
    launch), the input and output planes, the length-n twiddle table, M,
    n, n1, n2, plane_rows, sign, the scale (``real``), each factor's
    radices (0: its direct DFT), the paths (bit 0 / bit 1: pass 1 / pass
    2 in registers) and the stream."""
    return [_I] + [_P] * 5 + [ctypes.c_longlong] + [_I] * 5 + [real, _I, _I,
                                                               _I, _P]


#: csrc/bluestein.cu's ``spfft_bluestein``: the mode, the input and
#: output planes, the chirp, spectrum and twiddle tables, the rows, K, N,
#: plane_rows, n, the windows' first positions x0 and y0, M, m1, m2, the
#: factors' radices, the paths (bit 0 / bit 1: m1 / m2 in registers) and
#: the stream
_BLUESTEIN_ARGS = [_I] + [_P] * 7 + [ctypes.c_longlong] + [_I] * 12 + [_P]


def _rfft_args(real):
    """csrc/rfft.cu's ``spfft_rfft_stage``: the mode, the input and
    output planes, the twiddle table, M, K, N, plane_rows, the transform
    (n, scale (``real``), the half-spectrum window's first bin, h's
    radices) and the stream."""
    return [_I] + [_P] * 5 + [ctypes.c_longlong, _I, _I, _I, _I, real, _I,
                              _I, _P]


#: blocks of the cluster kernel's cluster (one plane), and the complex
#: elements one of its blocks holds (csrc/fft.cu's 512 threads x
#: fft_tile.cuh's EPT = 16)
CLUSTER_BLOCKS = 8
CLUSTER_BLOCK_ELEMS = 512 * 16
#: the forms of a complex stage
FORMS = ("matrix", "fft", "cluster")
#: every form a wrapper counts: a real stage's FFT form and the long-axis
#: forms too
ALL_FORMS = FORMS + ("rfft", "two_pass", "bluestein", "library")
#: the kind of DftMats each real mode takes
_REAL_KIND = {"rc": "r2c", "cr": "c2r"}


def stage_form(mats) -> str:
    """The form of one stage against ``mats``: the ``form`` a
    ``dft.DftMats`` carries (``"fft"``, ``"rfft"``, ``"matrix"``,
    ``"two_pass"``, ``"bluestein"``, ``"library"``); for a plain pair
    without its function ``"matrix"``. A plain pair with a side above
    ``dft.MATMUL_DFT_MAX`` has no form (the long forms need the function
    a ``DftMats`` carries) and raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError`."""
    form = getattr(mats, "form", None)
    if form is not None:
        return form
    if max(dft.mats_shape(mats)) > dft.MATMUL_DFT_MAX:
        raise InvalidParameterError(
            f"a plain matrix pair of shape {dft.mats_shape(mats)} has a side "
            f"above {dft.MATMUL_DFT_MAX}: pass the stage as dft.DftMats "
            f"(dft.device_c2c / device_r2c / device_c2r)")
    return "matrix"


def reg_plan(source: str, n: int, dtype) -> bool:
    """Does a factor of length ``n`` run its FFT in registers in the
    kernels of ``source`` (``"fft_long.cu"``, ``"bluestein.cu"`` or
    ``"fused_bluestein.cu"``) on
    ``dtype``? The library's own rule (csrc/fft_reg.cuh), read through
    its ``spfft_<name>_reg_plan``; any other factor takes the
    shared-memory path of the same kernel."""
    fn = _build.function(source, f"spfft_{source[:-3]}_reg_plan", (_I, _I))
    return bool(fn(n, int(dtype == torch.float64)))


def plane_forms(mats1, mats2, a: int) -> tuple:
    """The launches of one complex plane call on ``(P, a, B)`` planes,
    over B against ``mats1`` then over A against ``mats2``:
    ``("cluster",)`` where both stages take the FFT form with radices 2-5
    alone and a plane fits one cluster (a block's ceil(a / 8) rows of
    length ``mats1.n`` and its ceil(B' / 8) columns of length ``mats2.n``
    each within the elements it holds), else one launch per stage in its
    :func:`stage_form` (on an H100 a length with radix 7 or 11 ran faster
    in two stage launches than in the cluster kernel)."""
    forms = (stage_form(mats1), stage_form(mats2))
    if forms == ("fft", "fft") and max(mats1.factors + mats2.factors,
                                       default=1) <= 5:
        b_out = dft.mats_shape(mats1)[1]
        if max(-(-a // CLUSTER_BLOCKS) * mats1.n,
               -(-b_out // CLUSTER_BLOCKS) * mats2.n) <= CLUSTER_BLOCK_ELEMS:
            return ("cluster",)
    return forms


def _store(res, outs, plane_rows: int) -> None:
    """Copy results ``(..., N)`` into ``outs`` as a stage kernel stores
    them: straight, or transposed within planes of ``plane_rows`` rows."""
    for r, o in zip(res, outs):
        n = r.shape[-1]
        if plane_rows == 0:
            o.view(-1, n).copy_(r.reshape(-1, n))
        else:
            o.view(-1, n, plane_rows).copy_(
                r.reshape(-1, plane_rows, n).transpose(1, 2))


def long_row_max() -> int:
    """The longest row one block of csrc/fft_long.cu holds whole (its
    ``WHOLE_N``, read from the built library): a two-pass stage up to it
    is one launch, above it two (pass 1, then pass 2)."""
    return _build.function("fft_long.cu", "spfft_fft_long_whole_n", ())()


def _two_pass(wrapper, ins, mats, outs, plane_rows: int) -> None:
    """The two-pass form of csrc/fft_long.cu on the rows of ``ins``: one
    launch where a row fits a block (:func:`long_row_max`), else pass 1
    into an intermediate and pass 2 (:func:`_long_passes`)."""
    _long_passes(wrapper, ins, mats, outs, plane_rows,
                 one_launch=mats.n <= long_row_max())


def _long_passes(wrapper, ins, mats, outs, plane_rows: int,
                 one_launch: bool) -> None:
    """csrc/fft_long.cu's passes, both in one launch (``one_launch``) or
    pass 1 into an intermediate then pass 2, on the rows of ``ins``
    (their window expanded to the whole axis), each launch counted in
    ``wrapper``; into ``outs`` (or, where the output window is not the
    whole axis, into whole rows whose window is then taken out)."""
    n = mats.n
    n1, n2 = mats.split
    xr, xi = (dft.expand_window(t, mats.rows, n) for t in ins)
    dtype = xr.dtype
    m = xr.numel() // n
    fn = _build.function("fft_long.cu", _build.entry("spfft_fft_long", dtype),
                         _long_args(_build.REAL_TYPES[dtype]))
    whole = tuple(mats.cols) == (0, n)
    dst = outs if whole else (torch.empty_like(xr), torch.empty_like(xr))
    rows = plane_rows if whole else 0
    codes = (dft.radix_code(dft.fft_factors(n1)),
             dft.radix_code(dft.fft_factors(n2)))
    # pass 2 of two launches (n2 above 64 for every row longer than the
    # one-launch kernel's) takes the shared-memory path
    paths = int(reg_plan("fft_long.cu", n1, dtype)) | (
        int(reg_plan("fft_long.cu", n2, dtype)) << 1 if one_launch else 0)
    if one_launch:
        steps = ((0, (xr, xi), dst, rows),)
    else:
        mid = (torch.empty_like(xr), torch.empty_like(xr))
        steps = ((1, (xr, xi), mid, 0), (2, mid, dst, rows))
    for p, src, out, prows in steps:
        _build.launch(fn, f"fft_long pass {p}", xr.device, p,
                      *(t.data_ptr() for t in (*src, *out, mats.twiddles)),
                      m, n, n1, n2, prows, mats.sign, mats.scale, *codes,
                      paths)
        _build.count(wrapper, "two_pass")
    if not whole:
        _store(tuple(dft.extract_window(t, mats.cols, n) for t in dst),
               outs, plane_rows)


def bluestein_split_args(mats, dtype, source: str = "bluestein.cu") -> tuple:
    """``(M, m1, m2, rad1, rad2, paths)`` of a launch of the Bluestein
    tables ``mats.bluestein`` in the kernels of ``source``: the
    convolution's length and split, the factors' stage radices, and which
    factor runs in registers (bit 0 / bit 1: m1 / m2, the library's own
    rule, :func:`reg_plan`). Raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` where a float
    factor, or in the fused z kernels any factor, has no register plan
    there (those kernels hold no shared-memory FFT)."""
    bt = mats.bluestein
    m1, m2 = bt.split
    paths = int(reg_plan(source, m1, dtype)) | int(
        reg_plan(source, m2, dtype)) << 1
    if paths != 3 and (dtype == torch.float32
                       or source == "fused_bluestein.cu"):
        raise InvalidParameterError(
            f"Bluestein length {bt.m} = {m1} x {m2} (dft.bluestein_length"
            f"({mats.n})) has a factor without a float register plan in "
            f"csrc/{source}")
    return (bt.m, m1, m2, dft.radix_code(dft.fft_factors(m1)),
            dft.radix_code(dft.fft_factors(m2)), paths)


def _bluestein(wrapper, mode: str, ins, mats, outs, plane_rows: int) -> None:
    """One launch of csrc/bluestein.cu in ``mode`` on the rows of ``ins``
    (their input window as ``mats.rows`` says) into ``outs`` (the output
    window), stored straight or transposed within planes of
    ``plane_rows`` rows, counted in ``wrapper``."""
    k, n_out = dft.mats_shape(mats)
    xr, xi = (*ins, None)[:2]
    yr, yi = (*outs, None)[:2]
    dtype = xr.dtype
    split = bluestein_split_args(mats, dtype)
    fn = _build.function("bluestein.cu",
                         _build.entry("spfft_bluestein", dtype),
                         _BLUESTEIN_ARGS)
    _build.launch(fn, f"bluestein {mode}", xr.device, _MODES[mode],
                  *(None if t is None else t.data_ptr()
                    for t in (xr, xi, yr, yi, *mats.bluestein)),
                  xr.numel() // k, k, n_out, plane_rows, mats.n,
                  mats.rows[0], mats.cols[0], *split)
    _build.count(wrapper, "bluestein")


#: the plain version of each mode's stage, as a tuple of outputs
_PLAIN = {"cc": dft.pdft_last,
          "rc": dft.prdft_last,
          "cr": lambda yr, yi, mats: (dft.pirdft_last(yr, yi, mats),)}


def _stage(wrapper, mode: str, ins, mats, outs, plane_rows: int) -> None:
    """One stage in ``mode``: rows of ``ins`` (minor axis K; one real
    plane in mode rc) against ``mats`` (K, N) into ``outs`` (one real
    plane in mode cr), stored straight or transposed within planes of
    ``plane_rows`` rows: the FFT stage kernel in mode cc and the real FFT
    stage kernel in modes rc and cr where :func:`stage_form` says so, the
    launches of the two-pass form, the Bluestein kernel, ``torch.fft`` in
    the ``"library"`` form, else the matrix stage kernel. Each launch,
    and the ``torch.fft`` call, is counted in ``wrapper`` by its form
    where it is made."""
    k, n = dft.mats_shape(mats)
    m = ins[0].numel() // k
    form = stage_form(mats)
    if form != "matrix" and mats.kind != _REAL_KIND.get(mode, "c2c"):
        raise InvalidParameterError(
            f"a {mats.kind} DFT spec cannot run a stage in mode {mode}")
    if form == "library":
        _store(_PLAIN[mode](*ins, mats), outs, plane_rows)
        _build.count(wrapper, "library")
        return
    if form == "two_pass":
        _two_pass(wrapper, ins, mats, outs, plane_rows)
        return
    if form == "bluestein":
        _bluestein(wrapper, mode, ins, mats, outs, plane_rows)
        return
    xr, xi = (*ins, None)[:2]
    yr, yi = (*outs, None)[:2]
    dtype = xr.dtype
    real = _build.REAL_TYPES[dtype]
    if form == "rfft":
        fn = _build.function("rfft.cu",
                             _build.entry("spfft_rfft_stage", dtype),
                             _rfft_args(real))
        _build.launch(fn, f"rfft stage {mode}", xr.device, _MODES[mode],
                      *(None if t is None else t.data_ptr()
                        for t in (xr, xi, yr, yi, mats.twiddles)),
                      m, k, n, plane_rows, mats.n, mats.scale,
                      (mats.cols if mode == "rc" else mats.rows)[0],
                      dft.radix_code(mats.factors))
        _build.count(wrapper, "rfft")
        return
    if form == "fft":
        fn = _build.function("fft.cu", _build.entry("spfft_fft_stage", dtype),
                             _fft_stage_args(real))
        _build.launch(fn, "fft stage", ins[0].device,
                      *(t.data_ptr() for t in (*ins, *outs, mats.twiddles)),
                      m, k, n, plane_rows, mats.n, mats.sign, mats.scale,
                      mats.rows[0], mats.cols[0],
                      dft.radix_code(mats.factors))
        _build.count(wrapper, "fft")
        return
    fn = _build.function("dft2.cu", _build.entry("spfft_dft_stage", dtype),
                         _ARGS)
    _build.launch(fn, f"dft2 stage {mode}", xr.device, _MODES[mode],
                  *(None if t is None else t.data_ptr()
                    for t in (xr, xi, *mats, yr, yi)),
                  m, k, n, plane_rows)
    _build.count(wrapper, "matrix")


def _plane(ins, mats1, mats2, outs, swap_out: bool) -> None:
    """One launch of the cluster kernel: ``(P, A, B)`` planes over B
    (``mats1``) then A (``mats2``) into ``(P, B', A')`` or, with
    ``swap_out``, ``(P, A', B')``."""
    p, a, b = ins[0].shape
    dtype = ins[0].dtype
    fn = _build.function("fft.cu", _build.entry("spfft_fft_plane", dtype),
                         _fft_plane_args(_build.REAL_TYPES[dtype]))

    def spec(m):
        return (m.n, m.sign, m.rows[0], m.cols[0], dft.radix_code(m.factors))

    _build.launch(fn, "fft plane", ins[0].device,
                  *(t.data_ptr() for t in (*ins, *outs, mats1.twiddles,
                                           mats2.twiddles)),
                  p, a, b, dft.mats_shape(mats1)[1],
                  dft.mats_shape(mats2)[1],
                  *spec(mats1), *spec(mats2), mats1.scale * mats2.scale,
                  int(swap_out))


def _check(name: str, ins, mats1, mats2):
    """The operand rules of the plane wrappers: every operand and matrix
    of the input's real type (float32 or float64), and its twiddle table
    too; returns ``(p, a, b, b_out, a_out)``."""
    x = ins[0]
    dtype = _build.call_dtype(x, f"{name} input")
    if x.dim() != 3:
        raise InvalidParameterError(
            f"{name}: expected (P, A, B) operands, got {tuple(x.shape)}")
    p, a, b = x.shape
    b_out = dft.mats_shape(mats1)[1]
    a_out = dft.mats_shape(mats2)[1]
    dev = x.device
    _build.require(x, f"{name} input", dtype)
    for t in ins[1:]:
        _build.require(t, f"{name} input", dtype, x.shape, dev)
    for m, shape in ((mats1, (b, b_out)), (mats2, (a, a_out))):
        _build.require_mats(m, name, dtype, shape, dev)
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
    out = tuple(torch.empty(oshape, dtype=x.dtype, device=x.device)
                for _ in range(1 if real_out else 2))
    if x.numel() == 0 or out[0].numel() == 0:
        for t in out:
            t.zero_()
    elif modes == ("cc", "cc") and plane_forms(mats1, mats2, a) == \
            ("cluster",):
        _plane(ins, mats1, mats2, out, swap_out)
        _build.count(wrapper, "cluster")
    else:
        mid = tuple(torch.empty((p, b_out, a), dtype=x.dtype,
                                device=x.device) for _ in range(2))
        _stage(wrapper, modes[0], ins, mats1, mid, plane_rows=a)
        _stage(wrapper, modes[1], mid, mats2, out,
               plane_rows=b_out if swap_out else 0)
    return out[0] if real_out else out


def _last(wrapper, mode: str, ins, mats, plain):
    """The body of the single-stage wrappers: one launch of a stage
    kernel in ``mode`` over the rows of ``ins`` (``(..., K)``; one real
    input in mode rc) against ``mats`` ``(K, N)``, stored straight
    (``(..., N)``; one real output in mode cr) and counted in
    ``wrapper``; ``plain`` on a CPU tensor."""
    name = wrapper.__name__
    x = ins[0]
    dtype = _build.call_dtype(x, f"{name} input")
    if x.dim() < 1:
        raise InvalidParameterError(
            f"{name}: expected (..., K) operands, got {tuple(x.shape)}")
    k = x.shape[-1]
    dev = x.device
    _build.require(x, f"{name} input", dtype)
    for t in ins[1:]:
        _build.require(t, f"{name} input", dtype, x.shape, dev)
    shape = dft.mats_shape(mats)
    n = shape[1] if len(shape) == 2 else -1
    _build.require_mats(mats, name, dtype, (k, n), dev)
    if not _build.on_cuda(x, name):
        return plain(*ins, mats)
    out = tuple(torch.empty(x.shape[:-1] + (n,), dtype=dtype, device=dev)
                for _ in range(1 if mode == "cr" else 2))
    if x.numel() == 0 or n == 0:
        for t in out:
            t.zero_()
    else:
        _stage(wrapper, mode, ins, mats, out, plane_rows=0)
    return out[0] if mode == "cr" else out


def pdft_last(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Planar complex DFT along the minor axis, ``(..., K) -> (..., N)``
    against the ``(cr, ci)`` pair ``(K, N)``; any leading axes are rows.
    Each kernel launch (one per call; two in the two-pass form above
    :func:`long_row_max`, none in the ``torch.fft`` form) adds one to
    ``pdft_last.launches`` and to its form's count in
    ``pdft_last.form_launches``."""
    return _last(pdft_last, "cc", (xr, xi), mats, dft.pdft_last)


def prdft_last(x: torch.Tensor, mats):
    """Real DFT along the minor axis to the planar half spectrum, ``(...,
    n) -> (..., N)`` against the real pair ``mats`` ``(n, N)``
    (``dft.device_r2c`` or a plain ``dft.r2c_mats`` pair); any leading
    axes are rows. Each kernel launch (one per call; none in the
    ``torch.fft`` form) adds one to ``prdft_last.launches`` and to its
    form's count."""
    return _last(prdft_last, "rc", (x,), mats, dft.prdft_last)


def pirdft_last(yr: torch.Tensor, yi: torch.Tensor, mats):
    """Planar half spectrum to the real inverse DFT along the minor axis,
    ``(..., K) -> (..., n)`` against the real pair ``mats`` ``(K, n)``
    (``dft.device_c2r`` or a plain ``dft.c2r_mats`` pair); any leading
    axes are rows. Each kernel launch (one per call; none in the
    ``torch.fft`` form) adds one to ``pirdft_last.launches`` and to its
    form's count."""
    return _last(pirdft_last, "cr", (yr, yi), mats, dft.pirdft_last)


def pdft2(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, B', A')`` planar complex DFT over both minor
    axes; ``mats1``/``mats2`` are ``(cr, ci)`` pairs of shapes
    ``(B, B')`` and ``(A, A')``. Each kernel launch adds one to
    ``pdft2.launches`` (one per call in the cluster form, else one per
    stage, two for a two-pass stage above :func:`long_row_max`)."""
    return _run2(pdft2, ("cc", "cc"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor)


def pdft2_swapped(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """``(P, A, B) -> (P, A', B')`` planar complex DFT over both minor
    axes, the result in the input's axis order: :func:`pdft2` with the
    last store transposed within each plane. Each kernel launch adds one
    to ``pdft2_swapped.launches`` (one per call in the cluster form, else
    one per stage, two for a two-pass stage above :func:`long_row_max`)."""
    return _run2(pdft2_swapped, ("cc", "cc"), (xr, xi), mats1, mats2,
                 dft.cdft2_xy, swap_out=True)


def prdft2(x: torch.Tensor, mats1, mats2):
    """Real ``(P, A, B) -> (P, B', A')`` planar: the real DFT over B to
    the half spectrum (``mats1`` ``(B, B')`` from ``dft.device_r2c``,
    ``dft.r2c_mats`` or its column window), swap, a complex DFT over A
    (``mats2`` ``(A, A')``). Each kernel launch adds one to
    ``prdft2.launches`` (two per call; three where the complex stage
    takes the two-pass form above :func:`long_row_max`)."""
    return _run2(prdft2, ("rc", "cc"), (x,), mats1, mats2,
                 dft.prdft2_minor)


def pdft2_cr(xr: torch.Tensor, xi: torch.Tensor, mats1, mats2):
    """Planar ``(P, A, B) -> `` real ``(P, B', A')``: a complex DFT over
    B (``mats1`` ``(B, B')``), swap, the real inverse DFT over A
    (``mats2`` ``(A, A')`` from ``dft.device_c2r``, ``dft.c2r_mats`` or
    its row window).
    Each kernel launch adds one to ``pdft2_cr.launches`` (two per
    call; three where the complex stage takes the two-pass form above
    :func:`long_row_max`)."""
    return _run2(pdft2_cr, ("cc", "cr"), (xr, xi), mats1, mats2,
                 dft.pdft2_minor_cr)


for _w in (pdft_last, prdft_last, pirdft_last, pdft2, pdft2_swapped,
           prdft2, pdft2_cr):
    _w.launches = 0
    _w.form_launches = dict.fromkeys(ALL_FORMS, 0)
