"""The real FFT form of the port's real DFT stages (``csrc/rfft.cu``), on
the CPU.

The kernel cannot run here, but its launch path can: the ``emulated``
fixture makes every wrapper take its CUDA path on CPU tensors and runs
``spfft_rfft_stage`` in numpy (:func:`rfft_form`: the real row packed as
h = n / 2 complex values, ``test_torch_fft.stockham`` of length h on the
even entries of the table the wrapper hands the kernel, the pass over
the pairs of bins with the table's post-twiddles, windows, scale and
stores), reading and writing the operands through the pointers the
wrapper passes; every other C entry goes to ``test_torch_fft``'s
emulation. On those paths:

* the emulated real FFT form against the matrices (``r2c_mats`` /
  ``c2r_mats``, exact products in float64) for every even n <= 512 whose
  half is 2^a 3^b 5^c, scaled, in windows of the half spectrum that
  start at 0, start past 0 and wrap, with nonzero imaginary parts at DC
  and Nyquist (which the inverse must drop);
* ``prdft2`` / ``pdft2_cr`` / ``prdft_last`` / ``pirdft_last`` through
  the launch path against the JAX package's ``prdft2`` / ``pdft2_cr``
  (Pallas, interpret mode) and its XLA compositions;
* the dispatch (``dft_kernel.stage_form``) and the launches by form;
* ``dft.device_r2c`` / ``device_c2r`` against the matrix builders, bit
  for bit;
* the local and distributed R2C plans hand a real spec to every real
  stage, and their pairs through the launch path agree with
  ``spfft_tpu``.

Tolerance against the JAX package: 2e-6 relative l2 (``chip_smoke.py``'s
``KERNEL_TOL``, the JAX package's kernel tests' own): both sides compute
in f32, the JAX side as f32 matrix products whose error grows with
sqrt(n), this side as an FFT whose error grows with log n.
"""

import types

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import dft_kernel as jdk

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import _build, dft, dft_kernel, fused_kernel

from test_torch_fft import _store, _view, stockham
from test_torch_zfft import _emulate
from test_util import (dense_cube_from_values, hermitian_triplets,
                       random_values, sample_cube)

torch.set_num_threads(2)

TOL = 2e-6
EVEN_SMOOTH = [n for n in range(2, 513, 2) if dft.rfft_factors(n) is not None]
RC, CR = 1, 2  # the mode codes of spfft_rfft_stage


def _rel(got, want):
    got, want = np.asarray(got, np.complex128), np.asarray(want, np.complex128)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else np.linalg.norm(got)


# -- the numpy mirror of csrc/rfft.cu -----------------------------------------

def rfft_form(mode, x, n, scale, x0, width, table, dtype=np.complex128):
    """What ``spfft_rfft_stage`` computes. RC: real rows ``x`` (M, n) ->
    (M, width) bins from ``x0`` (mod n/2 + 1); CR: planar rows ``x`` (M,
    width) complex at those bins -> real (M, n). ``table``: the (2, n)
    table e^(sign 2 pi i m / n) the kernel reads, in ``dtype``'s
    precision."""
    real = np.float32 if dtype == np.complex64 else np.float64
    h, xf = n // 2, n // 2 + 1
    hp = h // 2 + 1
    t = (table[0] + 1j * table[1]).astype(dtype)
    tw_h, pw = t[0::2], t[:hp]
    factors = dft.rfft_factors(n)
    k = np.arange(hp)
    bins = (x0 + np.arange(width)) % xf
    half = real(0.5)
    if mode == RC:
        x = np.asarray(x, real)
        z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(dtype)
        zf = stockham(z, -1, factors, tw_h)
        zk, zm = zf[:, k], zf[:, np.where(k == 0, 0, h - k)]
        e = half * (zk + zm.conj())
        o = half * (zk - zm.conj()) * dtype(-1j)
        wo = pw[k] * o
        out = np.empty((x.shape[0], xf), dtype)
        out[:, k] = e + wo
        pair = h - k != k
        out[:, (h - k)[pair]] = (e - wo).conj()[:, pair]
        return out[:, bins] * real(scale)
    spec = np.zeros((x.shape[0], xf), dtype)
    spec[:, bins] = x
    spec[:, [0, h]] = spec[:, [0, h]].real  # Im X[0], Im X[h] dropped
    xk, xm = spec[:, k], spec[:, h - k]
    a = xk + xm.conj()
    wb = pw[k] * (xk - xm.conj())
    zs = np.empty((x.shape[0], h), dtype)
    zs[:, k] = a + dtype(1j) * wb
    pair = (k != 0) & (h - k != k)
    zs[:, (h - k)[pair]] = (a - dtype(1j) * wb).conj()[:, pair]
    z = stockham(zs, +1, factors, tw_h)
    out = np.empty((x.shape[0], n), real)
    out[:, 0::2], out[:, 1::2] = z.real, z.imag
    return out * real(scale)


def _table(n, sign, real=np.float32):
    t = dft.fft_twiddles(n, sign)
    return np.stack([t.real, t.imag]).astype(real)


def emulate_rfft(args, real=np.float32):
    """``spfft_rfft_stage`` (``real`` float32) or ``spfft_rfft_stage_f64``
    (float64) on the operands behind the pointers (the emulations of
    test_torch_fft and test_torch_zfft hand it theirs)."""
    (mode, xr, xi, yr, yi, tw, m, k, n_out, plane_rows, n, scale, x0,
     code) = args
    factors = []
    while code:
        factors.append(code & 7)
        code >>= 3
    assert tuple(factors) == dft.rfft_factors(n)

    def view(ptr, count):
        return _view(ptr, count, real)

    table = view(tw, 2 * n).reshape(2, n)
    sign = dft.FORWARD if mode == RC else dft.BACKWARD
    np.testing.assert_array_equal(table, _table(n, sign, real))
    scale = real(scale)  # the kernel takes its scale in its real type
    if mode == RC:
        assert xi is None and k == n and 1 <= n_out <= n // 2 + 1
        x = view(xr, m * k).reshape(m, k)
        y = rfft_form(RC, x, n, scale, x0, n_out, table)
        _store(view(yr, m * n_out), view(yi, m * n_out), y, plane_rows)
    else:
        assert mode == CR and yi is None and n_out == n
        x = (view(xr, m * k) + 1j * view(xi, m * k)).reshape(m, k)
        y = rfft_form(CR, x, n, scale, x0, k, table)
        _store(view(yr, m * n_out), None, y, plane_rows)


WRAPPERS = (dft_kernel.pdft_last, dft_kernel.prdft_last,
            dft_kernel.pirdft_last, dft_kernel.pdft2,
            dft_kernel.pdft2_swapped, dft_kernel.prdft2, dft_kernel.pdft2_cr,
            fused_kernel.decompress_zdft, fused_kernel.zdft_compress)


@pytest.fixture
def emulated(monkeypatch):
    """The DFT wrappers and the fused z kernels take their launch path on
    CPU tensors, each launch run by ``test_torch_zfft``'s emulation (which
    hands ``spfft_rfft_stage`` to :func:`emulate_rfft`); the gather stays
    on its plain version. Yields the list of launched symbols."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda", lambda t, what: what != "gather")
    monkeypatch.setattr(_build, "function",
                        lambda source, symbol, argtypes: (source, symbol))
    assert dft_kernel._build is _build and fused_kernel._build is _build

    def launch(fn, what, device, *args):
        calls.append(fn[1])
        _emulate(fn[1], args)

    monkeypatch.setattr(_build, "launch", launch)
    for w in WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "form_launches",
                            dict.fromkeys(dft_kernel.ALL_FORMS, 0))
    yield calls


def _counts(*forms):
    """Launches by form of a call that launched ``forms``."""
    out = dict.fromkeys(dft_kernel.ALL_FORMS, 0)
    for f in forms:
        out[f] += 1
    return out


def _windows(n):
    """Half-spectrum windows (x0, w): the whole, from 0, past 0, and one
    that wraps (mod n/2 + 1)."""
    xf = n // 2 + 1
    out = [None, (0, max(1, xf // 2)), (xf // 3, max(1, xf - xf // 3))]
    if xf > 2:
        out.append((xf - 2, min(xf, 5)))
    return out


def _idx(n, win):
    xf = n // 2 + 1
    x0, w = (0, xf) if win is None else win
    return tuple(int(i) for i in (x0 + np.arange(w)) % xf)


# -- the emulated form against the matrices ----------------------------------

@pytest.mark.parametrize("n", EVEN_SMOOTH)
def test_rfft_form_matches_the_matrices(n):
    rng = np.random.default_rng(n)
    h = n // 2
    for win in _windows(n):
        scale = 1.0 if win is None else 1.0 / n
        idx = _idx(n, win)
        x0, w = (0, h + 1) if win is None else win
        a, b = (m.astype(np.float64)
                for m in dft.sub_cols_r2c_mats(n, idx, scale))
        x = rng.standard_normal((5, n)).astype(np.float32)
        want = x @ a + 1j * (x @ b)
        for dt in (np.complex128, np.complex64):
            got = rfft_form(RC, x, n, scale, x0, w,
                            _table(n, dft.FORWARD), dt)
            assert _rel(got, want) < 1e-6, (n, win, dt)
        a, b = (m.astype(np.float64)
                for m in dft.sub_rows_c2r_mats(n, idx, scale))
        y = (rng.standard_normal((5, w))
             + 1j * rng.standard_normal((5, w))).astype(np.complex64)
        want = y.real @ a + y.imag @ b
        for dt in (np.complex128, np.complex64):
            got = rfft_form(CR, y, n, scale, x0, w,
                            _table(n, dft.BACKWARD), dt)
            assert got.dtype == (np.float32 if dt == np.complex64
                                 else np.float64)
            assert _rel(got, want) < 1e-6, (n, win, dt)
        # the imaginary parts at DC and Nyquist do not reach the output
        on = [j for j, i in enumerate(idx) if i in (0, h)]
        if on:
            y2 = y.copy()
            y2[:, on] += 1j * rng.standard_normal((5, len(on)))
            np.testing.assert_array_equal(
                rfft_form(CR, y2, n, scale, x0, w, _table(n, dft.BACKWARD)),
                rfft_form(CR, y, n, scale, x0, w, _table(n, dft.BACKWARD)))


def test_even_smooth_lengths():
    assert EVEN_SMOOTH[:6] == [2, 4, 6, 8, 10, 12]
    assert {24, 100, 250, 256, 512} <= set(EVEN_SMOOTH)
    assert len(EVEN_SMOOTH) == 52
    assert dft.rfft_factors(2) == () and dft.rfft_factors(256) == (4, 4, 4, 2)
    for n in (1, 7, 14, 22, 26, 255, 514):
        assert dft.rfft_factors(n) is None


# -- DftMats of the real kinds ------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 6, 7, 10, 13, 14, 24, 100, 250, 256,
                               512])
def test_device_real_mats_equal_the_matrix_builders(n):
    xf = n // 2 + 1
    for scale in (1.0, 1.0 / n):
        for win in _windows(n):
            idx = _idx(n, win)
            x0, w = (0, xf) if win is None else win
            r2c = dft.device_r2c(n, scale, cols=win)
            c2r = dft.device_c2r(n, scale, rows=win)
            for m, want in ((r2c, dft.sub_cols_r2c_mats(n, idx, scale)),
                            (c2r, dft.sub_rows_c2r_mats(n, idx, scale))):
                assert isinstance(m, dft.DftMats) and len(m) == 2
                for got, wm in zip(m, want):
                    np.testing.assert_array_equal(got.numpy(), wm)
                assert (m.n, m.scale) == (n, scale)
            if win is None:
                for got, wm in zip(r2c, dft.r2c_mats(n, scale)):
                    np.testing.assert_array_equal(got.numpy(), wm)
                for got, wm in zip(c2r, dft.c2r_mats(n, scale)):
                    np.testing.assert_array_equal(got.numpy(), wm)
            assert (r2c.kind, r2c.sign, r2c.rows, r2c.cols) == \
                ("r2c", dft.FORWARD, (0, n), (x0, w))
            assert (c2r.kind, c2r.sign, c2r.rows, c2r.cols) == \
                ("c2r", dft.BACKWARD, (x0, w), (0, n))
    f = dft.rfft_factors(n)
    for m, sign in ((dft.device_r2c(n), dft.FORWARD),
                    (dft.device_c2r(n), dft.BACKWARD)):
        assert m.factors == f
        if f is None:
            assert m.twiddles is None
        else:
            np.testing.assert_array_equal(m.twiddles.numpy(),
                                          _table(n, sign))


def test_device_real_mats_reject_windows_past_the_half_spectrum():
    with pytest.raises(sp.InvalidParameterError):
        dft.device_r2c(8, cols=(0, 6))
    with pytest.raises(sp.InvalidParameterError):
        dft.device_c2r(8, rows=(2, 6))
    assert dft.device_c2r(8, rows=(7, 5)).rows == (2, 5)  # x0 mod 5


# -- dispatch -----------------------------------------------------------------

def test_stage_form_by_shape():
    f = dft_kernel.stage_form
    for n in (2, 4, 6, 10, 24, 100, 250, 256, 512):
        assert f(dft.device_r2c(n)) == "rfft" == f(dft.device_c2r(n))
    for n in (7, 13, 15, 255):  # odd
        assert f(dft.device_r2c(n)) == "matrix" == f(dft.device_c2r(n))
    for n in (14, 22, 26, 98, 286):  # a prime >= 7 in the half
        assert f(dft.device_r2c(n)) == "matrix" == f(dft.device_c2r(n))
    assert f(dft.device_mats(dft.r2c_mats(256), "cpu")) == "matrix"
    assert f(dft.device_c2c(256, dft.FORWARD)) == "fft"
    assert "rfft" in dft_kernel.ALL_FORMS


def test_a_spec_refuses_a_mode_of_another_kind(emulated):
    r2c = dft.device_r2c(8)
    c2r_shaped_as_r2c = dft.DftMats(
        *r2c, n=8, sign=dft.BACKWARD, scale=1.0, rows=(0, 8), cols=(0, 5),
        twiddles=r2c.twiddles, kind="c2r")
    x = torch.zeros((3, 4, 8))
    with pytest.raises(sp.InvalidParameterError, match="c2r"):
        dft_kernel.prdft2(x, c2r_shaped_as_r2c,
                          dft.device_c2c(4, dft.FORWARD))
    with pytest.raises(sp.InvalidParameterError, match="c2c"):
        dft_kernel.prdft_last(torch.zeros((3, 5)),
                              dft.device_c2c(5, dft.FORWARD))
    assert emulated == []


# -- the launch path against the JAX package ----------------------------------

def _t(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)


def _np(t):
    return np.asarray(t, np.float32)


PLANE_CASES = [  # (P, A, nx, window of the half spectrum)
    (3, 10, 12, None), (2, 9, 24, (3, 5)), (4, 8, 16, (0, 4)),
    (1, 12, 2, None), (2, 5, 4, None), (3, 6, 100, (40, 11)),
    (2, 3, 512, (0, 257)), (2, 7, 14, None), (3, 6, 15, (2, 4)),
    (2, 4, 250, (120, 6))]


@pytest.mark.parametrize("case", range(len(PLANE_CASES)))
def test_prdft2_launch_path_matches_jax(emulated, case):
    p, a, nx, win = PLANE_CASES[case]
    rng = np.random.default_rng(20 + case)
    idx = _idx(nx, win)
    x = _t(rng, p, a, nx)
    m1 = dft.device_r2c(nx, cols=win)
    m2 = dft.device_c2c(a, dft.FORWARD, 1.0 / a)
    got = dft_kernel.prdft2(x, m1, m2)
    j1 = jdft.sub_cols_r2c_mats(nx, idx)
    j2 = jdft.c2c_mats(a, jdft.FORWARD, 1.0 / a)
    want = jdk.prdft2(_np(x), j1, j2, interpret=True)
    comp = jdft.prdft2_minor(_np(x), j1, j2)
    for w in (want, comp):
        assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                    np.asarray(w[0]) + 1j * np.asarray(w[1])) < TOL
    form = dft_kernel.stage_form(m1)
    assert form == ("rfft" if dft.rfft_factors(nx) is not None else "matrix")
    assert dft_kernel.prdft2.form_launches == _counts(
        form, dft_kernel.stage_form(m2))
    assert emulated[0] == ("spfft_rfft_stage" if form == "rfft"
                           else "spfft_dft_stage")


@pytest.mark.parametrize("case", range(len(PLANE_CASES)))
def test_pdft2_cr_launch_path_matches_jax(emulated, case):
    p, a, nx, win = PLANE_CASES[case]
    rng = np.random.default_rng(40 + case)
    idx = _idx(nx, win)
    k = len(idx)
    xr, xi = _t(rng, p, k, a), _t(rng, p, k, a)
    m1 = dft.device_c2c(a, dft.BACKWARD)
    m2 = dft.device_c2r(nx, 0.5, rows=win)
    got = dft_kernel.pdft2_cr(xr, xi, m1, m2)
    j1 = jdft.c2c_mats(a, jdft.BACKWARD)
    j2 = jdft.sub_rows_c2r_mats(nx, idx, 0.5)
    want = jdk.pdft2_cr(_np(xr), _np(xi), j1, j2, interpret=True)
    comp = jdft.pdft2_minor_cr(_np(xr), _np(xi), j1, j2)
    assert got.shape == (p, a, nx)
    for w in (want, comp):
        assert _rel(got.numpy(), np.asarray(w)) < TOL
    form = dft_kernel.stage_form(m2)
    assert dft_kernel.pdft2_cr.form_launches == _counts(
        dft_kernel.stage_form(m1), form)
    assert emulated[-1] == ("spfft_rfft_stage" if form == "rfft"
                            else "spfft_dft_stage")


LAST_CASES = [  # (leading rows, nx, window, scale)
    ((37,), 256, None, 1.0), ((5, 7), 24, (2, 9), 0.25), ((3,), 2, None, 1.0),
    ((9,), 512, (100, 157), 1.0 / 512), ((4,), 6, (3, 4), 1.0),
    ((6,), 13, None, 1.0), ((2, 3), 22, (1, 5), 2.0), ((0,), 16, None, 1.0)]


@pytest.mark.parametrize("case", range(len(LAST_CASES)))
def test_real_last_launch_path_matches_jax(emulated, case):
    lead, nx, win, scale = LAST_CASES[case]
    rng = np.random.default_rng(60 + case)
    idx = _idx(nx, win)
    x = _t(rng, *lead, nx)
    m = dft.device_r2c(nx, scale, cols=win)
    got = dft_kernel.prdft_last(x, m)
    want = jdft.prdft_last(_np(x), jdft.sub_cols_r2c_mats(nx, idx, scale))
    assert got[0].shape == lead + (len(idx),)
    if x.numel():
        assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                    np.asarray(want[0]) + 1j * np.asarray(want[1])) < TOL
    yr, yi = _t(rng, *lead, len(idx)), _t(rng, *lead, len(idx))
    m = dft.device_c2r(nx, scale, rows=win)
    got = dft_kernel.pirdft_last(yr, yi, m)
    want = jdft.pirdft_last(_np(yr), _np(yi),
                            jdft.sub_rows_c2r_mats(nx, idx, scale))
    assert got.shape == lead + (nx,)
    if x.numel():
        assert _rel(got.numpy(), np.asarray(want)) < TOL
    runs = 1 if x.numel() else 0
    form = dft_kernel.stage_form(m)
    for w in (dft_kernel.prdft_last, dft_kernel.pirdft_last):
        assert w.form_launches == _counts(*[form] * runs)
        assert w.launches == runs
    assert emulated == ["spfft_rfft_stage" if form == "rfft"
                        else "spfft_dft_stage"] * (2 * runs)


def test_real_last_transposed_store(emulated):
    """The kernel's store transposed within planes (what prdft2's first
    launch asks for), in both modes, through the C entry."""
    rng = np.random.default_rng(80)
    for nx, win in ((16, None), (24, (5, 6))):
        m = dft.device_r2c(nx, cols=win)
        x = _t(rng, 3, 8, nx)
        k = m[0].shape[1]
        out = tuple(torch.empty((3, k, 8)) for _ in range(2))
        counter = types.SimpleNamespace(launches=0, form_launches={})
        dft_kernel._stage(counter, "rc", (x,), m, out, plane_rows=8)
        assert counter.form_launches == {"rfft": 1} and counter.launches == 1
        want = dft.prdft_last(x, m)
        for g, w in zip(out, want):
            np.testing.assert_allclose(g.numpy(), w.transpose(1, 2).numpy(),
                                       rtol=0, atol=2e-5)
        c = dft.device_c2r(nx, rows=win)
        y = (_t(rng, 3, 8, k), _t(rng, 3, 8, k))
        real = torch.empty((3, nx, 8))
        dft_kernel._stage(counter, "cr", y, c, (real,), plane_rows=8)
        assert counter.form_launches == {"rfft": 2} and counter.launches == 2
        np.testing.assert_allclose(
            real.numpy(), dft.pirdft_last(*y, c).transpose(1, 2).numpy(),
            rtol=0, atol=2e-5)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(81)
    x = _t(rng, 4, 16)
    m = dft.device_r2c(16)
    before = dft_kernel.prdft_last.launches
    got = dft_kernel.prdft_last(x, m)
    for g, w in zip(got, dft.prdft_last(x, m)):
        assert torch.equal(g, w)
    assert dft_kernel.prdft_last.launches == before


# -- the plans hand a real spec to every real stage ---------------------------

def _record(monkeypatch):
    """Wrap the real-stage wrappers so that each call records whether its
    real matrix argument is a DftMats of the right kind."""
    seen = []

    def wrap(name, pick, kind):
        fn = getattr(dft_kernel, name)

        def rec(*args, **kw):
            m = args[pick]
            seen.append((name, isinstance(m, dft.DftMats)
                         and m.kind == kind))
            return fn(*args, **kw)

        # the wrappers count on the function their module name holds
        rec.launches = 0
        rec.form_launches = dict.fromkeys(dft_kernel.ALL_FORMS, 0)
        monkeypatch.setattr(dft_kernel, name, rec)

    wrap("prdft2", 1, "r2c")
    wrap("pdft2_cr", 3, "c2r")
    wrap("prdft_last", 1, "r2c")
    wrap("pirdft_last", 2, "c2r")
    return seen


def _r2c_case(dims, seed):
    rng = np.random.default_rng(seed)
    trip = hermitian_triplets(rng, dims)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    cube = np.fft.fftn(np.fft.ifftn(cube).real)
    return trip, cube


@pytest.mark.parametrize("dims", [(16, 12, 10), (12, 11, 13), (13, 8, 9),
                                  (14, 6, 8)])
@pytest.mark.parametrize("fused", [True, False])
def test_local_r2c_plan_hands_a_real_spec(monkeypatch, emulated, dims,
                                          fused):
    trip, cube = _r2c_case(dims, 90)
    vals = sample_cube(cube, trip, dims).astype(np.complex64)
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.R2C, *dims, trip,
                                   precision="single", use_pallas=False)
    want_b = np.array(jp.backward(vals))
    want_f = np.asarray(jp.forward(want_b, spfft_tpu.Scaling.FULL))
    seen = _record(monkeypatch)
    tp = sp.make_local_plan(sp.TransformType.R2C, *dims, trip, device="cpu",
                            fused=fused)
    got_b = tp.backward(vals).numpy()
    got_f = tp.forward(torch.from_numpy(want_b), sp.Scaling.FULL).numpy()
    assert sorted(seen) == [("pdft2_cr", True), ("prdft2", True)]
    form = "rfft" if dft.rfft_factors(dims[0]) is not None else "matrix"
    cc = "fft" if dft.fft_factors(dims[1]) is not None else "matrix"
    for w in (dft_kernel.prdft2, dft_kernel.pdft2_cr):
        assert w.form_launches == _counts(form, cc)
    assert _rel(got_b, want_b) < TOL and _rel(got_f, want_f) < TOL


@pytest.mark.parametrize("dims", [(12, 11, 13), (10, 8, 9)])
def test_distributed_r2c_plan_hands_a_real_spec(monkeypatch, emulated,
                                                dims):
    trip, cube = _r2c_case(dims, 91)
    st = np.where(trip < 0, trip + np.array(dims), trip)
    owner = (st[:, 0] * 7 + st[:, 1]) % 3
    parts = [trip[owner == r] for r in range(3)]
    planes = [dims[2] - 2 * (dims[2] // 3), dims[2] // 3, dims[2] // 3]
    vals = [sample_cube(cube, p, dims).astype(np.complex64) for p in parts]
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType.R2C, *dims,
                                    parts, planes, mesh=jpar.make_mesh(3),
                                    precision="single")
    want_b = np.array(jp.backward(vals))
    want_f = np.asarray(jp.forward(jax.device_put(want_b, jp._sharded),
                                   spfft_tpu.Scaling.FULL))
    seen = _record(monkeypatch)
    tp = sp.make_distributed_plan(sp.TransformType.R2C, *dims, parts,
                                  planes, device="cpu")
    got_b = tp.backward(vals).numpy()
    got_f = tp.forward(torch.from_numpy(want_b), sp.Scaling.FULL).numpy()
    assert sorted(seen) == [("pirdft_last", True), ("prdft_last", True)]
    form = "rfft" if dft.rfft_factors(dims[0]) is not None else "matrix"
    cc = "fft" if dft.fft_factors(dims[1]) is not None else "matrix"
    for w in (dft_kernel.prdft_last, dft_kernel.pirdft_last):
        assert w.form_launches == _counts(form)
    assert dft_kernel.pdft_last.form_launches == _counts(cc, cc)
    assert _rel(got_b, want_b) < TOL and _rel(got_f, want_f) < TOL
