"""The FFT form of the port's complex DFT stage, on the CPU.

* ``dft.device_c2c`` (``DftMats``: the matrices plus the function they
  stand for) equals ``c2c_mats`` / ``sub_rows_mats`` / ``sub_cols_mats``
  bit for bit, and unpacks as the plain pair;
* a numpy Stockham FFT that takes exactly the plan's factor list
  (``dft.fft_factors``) and twiddle table (``dft.fft_twiddles``) and the
  butterflies of ``csrc/fft_tile.cuh`` agrees with ``np.fft`` in
  complex128 and within 1e-6 relative l2 in complex64, for every length
  2^a 3^b 5^c <= 512, windowed and scaled;
* the dispatch (``dft_kernel.stage_form`` / ``plane_forms``) by shape;
* every wrapper's launch path, with ``csrc/fft.cu`` and ``csrc/dft2.cu``
  replaced by numpy emulations of their C entries that read and write
  the operands through the pointers the wrapper passes: the argument
  lists, radix codes, windows, scales and stores (straight, transposed,
  swapped), and the per-form launch counts, against the plain versions
  within 2e-6;
* the local and distributed plans hand a ``DftMats`` to every complex
  stage (and the fused z kernels), and their results against
  ``spfft_tpu`` stay within 2e-6.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import _build, dft, dft_kernel, fused_kernel
from spfft_tpu_torch.utils import workloads

from test_util import (dense_cube_from_values, hermitian_triplets,
                       random_sparse_triplets, random_values, sample_cube)

torch.set_num_threads(2)

TOL = 2e-6
SMOOTH = [n for n in range(1, 513) if dft.fft_factors(n) is not None]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    den = np.linalg.norm(want)
    return np.linalg.norm(got - want) / den if den else \
        np.linalg.norm(got)


# -- DftMats ------------------------------------------------------------------

def _window(n, x0, w):
    return tuple(int(i) for i in (x0 + np.arange(w)) % n)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11, 12, 13, 60, 100, 256, 512])
@pytest.mark.parametrize("sign", [dft.BACKWARD, dft.FORWARD])
def test_device_c2c_equals_the_matrix_builders(n, sign):
    for scale in (1.0, 1.0 / n):
        m = dft.device_c2c(n, sign, scale)
        assert isinstance(m, dft.DftMats) and isinstance(m, tuple)
        cr, ci = m
        for got, want in zip((cr, ci), dft.c2c_mats(n, sign, scale)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert (m.n, m.sign, m.scale) == (n, sign, scale)
        assert m.rows == (0, n) and m.cols == (0, n)
        for x0, w in ((0, n), (n - 1, n), (n // 2, max(1, n // 3)),
                      (n - 1, max(1, n // 2))):
            rows = dft.device_c2c(n, sign, scale, rows=(x0, w))
            want = dft.sub_rows_mats(n, sign, _window(n, x0, w), scale)
            for got, wm in zip(rows, want):
                np.testing.assert_array_equal(got.numpy(), wm)
            assert rows.rows == (x0 % n, w) and rows.cols == (0, n)
            cols = dft.device_c2c(n, sign, scale, cols=(x0, w))
            want = dft.sub_cols_mats(n, sign, _window(n, x0, w), scale)
            for got, wm in zip(cols, want):
                np.testing.assert_array_equal(got.numpy(), wm)
            assert cols.cols == (x0 % n, w) and cols.rows == (0, n)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11, 12, 13, 60, 100, 256, 512])
def test_device_c2c_twiddles_and_factors(n):
    m = dft.device_c2c(n, dft.FORWARD)
    f = dft.fft_factors(n)
    if n in (11, 13):
        assert f is None and m.twiddles is None
        return
    assert int(np.prod(f, dtype=np.int64)) == n and m.factors == f
    assert set(f) <= {2, 3, 4, 5} and f.count(2) <= 1
    assert list(f) == sorted(f, key=(4, 2, 3, 5).index)
    t = dft.fft_twiddles(n, dft.FORWARD)
    np.testing.assert_array_equal(
        m.twiddles.numpy(), np.stack([t.real, t.imag]).astype(np.float32))
    code = dft.radix_code(f)
    assert [(code >> (3 * i)) & 7 for i in range(len(f))] == list(f)
    assert code >> (3 * len(f)) == 0


def test_device_c2c_rejects_windows_past_the_length():
    with pytest.raises(sp.InvalidParameterError):
        dft.device_c2c(8, dft.FORWARD, rows=(0, 9))


def test_fft_factors_cover_the_smooth_lengths():
    assert dft.fft_factors(1) == ()
    assert dft.fft_factors(256) == (4, 4, 4, 4)
    assert dft.fft_factors(512) == (4, 4, 4, 4, 2)
    assert dft.fft_factors(360) == (4, 2, 3, 3, 5)
    assert dft.fft_factors(513) is None and dft.fft_factors(7) is None
    assert len(SMOOTH) == 68


# -- the numpy mirror of csrc/fft_tile.cuh -----------------------------------

_S3 = np.sqrt(3.0) / 2
_C5 = (np.cos(2 * np.pi / 5), np.cos(4 * np.pi / 5))
_S5 = (np.sin(2 * np.pi / 5), np.sin(4 * np.pi / 5))


def _small_dft(v, p, s, real):
    """``small_dft<P>`` of fft_tile.cuh on complex arrays ``v[t]``."""
    j = 1j * s
    if p == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if p == 4:
        t0, t1 = v[0] + v[2], v[0] - v[2]
        t2, t3 = v[1] + v[3], (v[1] - v[3]) * j
        return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
    if p == 3:
        t, d = v[1] + v[2], v[1] - v[2]
        m = v[0] - real(0.5) * t
        e = d * (j * real(_S3))
        return [v[0] + t, m + e, m - e]
    c1, c2 = real(_C5[0]), real(_C5[1])
    s1, s2 = real(_S5[0]), real(_S5[1])
    b1, b2 = v[1] + v[4], v[2] + v[3]
    d1, d2 = v[1] - v[4], v[2] - v[3]
    m1 = v[0] + c1 * b1 + c2 * b2
    m2 = v[0] + c2 * b1 + c1 * b2
    e1 = (s1 * d1 + s2 * d2) * j
    e2 = (s2 * d1 - s1 * d2) * j
    return [v[0] + b1 + b2, m1 + e1, m2 + e2, m2 - e2, m1 - e1]


def stockham(x, sign, factors, tw):
    """The Stockham FFT of fft_tile.cuh along the rows of ``x`` (..., n),
    with ``factors`` and the table ``tw`` (n,) in ``x``'s dtype."""
    x = np.array(x)
    n = x.shape[-1]
    real = np.float32 if x.dtype == np.complex64 else np.float64
    ns = 1
    for p in factors:
        q = n // p
        j = np.arange(q)
        k = j % ns
        v = [x[..., j + t * q] * (tw[t * k * (n // (ns * p))] if t else 1)
             for t in range(p)]
        v = _small_dft(v, p, sign, real)
        y = np.empty_like(x)
        base = (j - k) * p + k
        for t in range(p):
            y[..., base + t * ns] = v[t]
        x, ns = y, ns * p
    return x


def fft_stage(x, m_n, sign, scale, rows, cols, dtype=np.complex128):
    """The FFT form's function: the inputs at the window's positions of a
    zeroed length-n row, the FFT, the output window times the scale."""
    tw = dft.fft_twiddles(m_n, sign).astype(dtype)
    buf = np.zeros(x.shape[:-1] + (m_n,), dtype)
    buf[..., (rows[0] + np.arange(rows[1])) % m_n] = x
    y = stockham(buf, sign, dft.fft_factors(m_n), tw)
    return y[..., (cols[0] + np.arange(cols[1])) % m_n] * scale


@pytest.mark.parametrize("sign", [dft.BACKWARD, dft.FORWARD])
def test_stockham_matches_numpy_for_every_smooth_length(sign):
    rng = np.random.default_rng(0)
    for n in SMOOTH:
        x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        want = np.fft.ifft(x) * n if sign == dft.BACKWARD else np.fft.fft(x)
        got = fft_stage(x, n, sign, 1.0, (0, n), (0, n))
        assert _rel(got, want) < 1e-13, n
        got32 = fft_stage(x.astype(np.complex64), n, sign, 1.0, (0, n),
                          (0, n), np.complex64)
        assert got32.dtype == np.complex64
        assert _rel(got32, want) < 1e-6, n


@pytest.mark.parametrize("n,rows,cols,scale", [
    (24, (20, 9), (0, 24), 1.0), (24, (0, 24), (17, 6), 0.25),
    (100, (90, 30), (5, 40), 1.0 / 100), (60, (59, 1), (59, 2), 1.0),
    (512, (500, 100), (0, 512), 1.0), (1, (0, 1), (0, 1), 0.5),
    (45, (40, 10), (30, 20), 1.0 / 45)])
def test_windowed_stockham_matches_the_matrices(n, rows, cols, scale):
    rng = np.random.default_rng(1)
    for sign in (dft.BACKWARD, dft.FORWARD):
        m = dft.device_c2c(n, sign, scale, rows=rows, cols=cols)
        x = rng.standard_normal((4, rows[1])) \
            + 1j * rng.standard_normal((4, rows[1]))
        want = x @ (m[0].double().numpy() + 1j * m[1].double().numpy())
        got = fft_stage(x, n, sign, scale, rows, cols)
        assert _rel(got, want) < 1e-6  # the matrices are f32
        got32 = fft_stage(x.astype(np.complex64), n, sign, scale, rows,
                          cols, np.complex64)
        assert _rel(got32, want) < 1e-6


# -- dispatch -----------------------------------------------------------------

def test_dispatch_by_shape():
    c = dft.device_c2c
    assert dft_kernel.stage_form(c(256, 1)) == "fft"
    assert dft_kernel.stage_form(c(11, 1)) == "matrix"
    assert dft_kernel.stage_form(dft.device_mats(dft.c2c_mats(256, 1),
                                                 "cpu")) == "matrix"
    assert dft_kernel.stage_form(dft.device_mats(dft.r2c_mats(256),
                                                 "cpu")) == "matrix"
    f = dft_kernel.plane_forms
    assert f(c(256, 1), c(256, 1), 256) == ("cluster",)
    # the split window the plans make: w of 256 x rows in, all out
    assert f(c(256, 1), c(256, 1, rows=(230, 100)), 100) == ("cluster",)
    assert f(c(256, -1, cols=(230, 100)), c(256, -1), 256) == ("cluster",)
    assert f(c(24, 1), c(20, -1), 20) == ("cluster",)
    assert f(c(512, 1, cols=(0, 9)), c(40, 1), 40) == ("cluster",)
    assert f(c(512, 1), c(512, 1), 512) == ("fft", "fft")
    assert f(c(13, 1), c(11, 1), 11) == ("matrix", "matrix")
    assert f(c(300, -1), c(7, -1), 7) == ("fft", "matrix")


# -- the launch path, with the C entries emulated -----------------------------

def _view(ptr, count, real=np.float32):
    """A writable numpy view of ``count`` reals of type ``real`` (float32
    or float64) at a CPU tensor's address."""
    if count == 0:
        return np.zeros(0, real)
    ctype = ctypes.c_float if real == np.float32 else ctypes.c_double
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _store(yr, yi, y, plane_rows):
    """Write ``y`` (M, N) as the kernels store it."""
    if plane_rows:
        m, nn = y.shape
        y = y.reshape(m // plane_rows, plane_rows, nn).transpose(0, 2, 1)
    yr[:] = y.real.reshape(-1)
    if yi is not None:
        yi[:] = y.imag.reshape(-1)


def entry_real(symbol):
    """A C entry's base name and the numpy type of its operands: the
    suffix ``_f64`` marks the float64 instance of a kernel."""
    if symbol.endswith("_f64"):
        return symbol[:-4], np.float64
    return symbol, np.float32


def _emulate(symbol, args):
    """numpy stand-ins for csrc/fft.cu and csrc/dft2.cu's C entries (and
    csrc/rfft.cu's, emulated in test_torch_rfft), float32 and float64."""
    symbol, real = entry_real(symbol)

    def view(ptr, count):
        return _view(ptr, count, real)

    if symbol == "spfft_fft_stage":
        (xr, xi, yr, yi, tw, m, k, n_out, plane_rows, n, sign, scale, in0,
         out0, code) = args
        x = (view(xr, m * k) + 1j * view(xi, m * k)).reshape(m, k)
        y = _fft(x, n, sign, scale, (in0, k), (out0, n_out), code, tw, real)
        _store(view(yr, m * n_out), view(yi, m * n_out), y, plane_rows)
    elif symbol == "spfft_fft_plane":
        (xr, xi, yr, yi, tw1, tw2, p, a, b, b_out, a_out, n1, sign1, in1,
         out1, code1, n2, sign2, in2, out2, code2, scale, swap) = args
        x = (view(xr, p * a * b) + 1j * view(xi, p * a * b)).reshape(
            p, a, b)
        g = _fft(x, n1, sign1, 1.0, (in1, b), (out1, b_out), code1, tw1,
                 real)
        y = _fft(g.transpose(0, 2, 1), n2, sign2, scale, (in2, a),
                 (out2, a_out), code2, tw2, real)
        if swap:
            y = y.transpose(0, 2, 1)
        _store(view(yr, y.size), view(yi, y.size), y.reshape(-1, 1), 0)
    elif symbol == "spfft_rfft_stage":  # csrc/rfft.cu
        from test_torch_rfft import emulate_rfft
        emulate_rfft(args, real)
    else:
        assert symbol == "spfft_dft_stage"
        mode, xr, xi, cr, ci, yr, yi, m, k, n_out, plane_rows = args
        mat = (view(cr, k * n_out) + 1j * view(ci, k * n_out)).reshape(
            k, n_out).astype(np.complex128)
        xre = view(xr, m * k).reshape(m, k).astype(np.float64)
        if mode == 1:  # rc
            y = xre @ mat.real + 1j * (xre @ mat.imag)
        else:
            xim = view(xi, m * k).reshape(m, k).astype(np.float64)
            if mode == 0:
                y = (xre + 1j * xim) @ mat
            else:  # cr
                y = xre @ mat.real + xim @ mat.imag + 0j
        _store(view(yr, m * n_out),
               None if yi is None else view(yi, m * n_out), y, plane_rows)


def _fft(x, n, sign, scale, rows, cols, code, tw_ptr, real=np.float32):
    factors = []
    while code:
        factors.append(code & 7)
        code >>= 3
    assert tuple(factors) == dft.fft_factors(n)
    t = _view(tw_ptr, 2 * n, real).astype(np.float64)
    want_t = dft.fft_twiddles(n, sign)
    np.testing.assert_array_equal(t[:n], want_t.real.astype(real))
    np.testing.assert_array_equal(t[n:], want_t.imag.astype(real))
    buf = np.zeros(x.shape[:-1] + (n,), np.complex128)
    buf[..., (rows[0] + np.arange(rows[1])) % n] = x
    y = stockham(buf, sign, factors, t[:n] + 1j * t[n:])
    return y[..., (cols[0] + np.arange(cols[1])) % n] * scale


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers take their launch path on CPU tensors, each launch
    run by :func:`_emulate`; yields the list of launched symbols."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(_build, "function",
                        lambda source, symbol, argtypes: (source, symbol))
    assert dft_kernel._build is _build

    def launch(fn, what, device, *args):
        calls.append(fn[1])
        _emulate(fn[1], args)

    monkeypatch.setattr(_build, "launch", launch)
    for w in (dft_kernel.pdft_last, dft_kernel.pdft2,
              dft_kernel.pdft2_swapped, dft_kernel.prdft2,
              dft_kernel.pdft2_cr):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "form_launches",
                            dict.fromkeys(dft_kernel.FORMS, 0))
    yield calls


def _t(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)


@pytest.mark.parametrize("lead,n,window,plain", [
    ((37,), 12, {}, False), ((5,), 1, {}, False), ((9,), 384, {}, False),
    ((7,), 100, {"rows": (90, 30)}, False), ((3, 5), 60,
                                             {"cols": (50, 20)}, False),
    ((21,), 13, {}, False), ((4,), 16, {}, True), ((0,), 8, {}, False)])
def test_pdft_last_launch_path(emulated, lead, n, window, plain):
    rng = np.random.default_rng(3)
    for sign in (dft.BACKWARD, dft.FORWARD):
        m = dft.device_c2c(n, sign, 0.5, **window)
        if plain:
            m = dft.device_mats(tuple(t.numpy() for t in m), "cpu")
        x = (_t(rng, *lead, m[0].shape[0]), _t(rng, *lead, m[0].shape[0]))
        got = dft_kernel.pdft_last(*x, m)
        want = dft.pdft_last(*x, m)
        assert _rel(torch.stack(got), torch.stack(want)) < TOL
    form = "matrix" if plain or n == 13 else "fft"
    runs = 0 if lead == (0,) else 2
    assert dft_kernel.pdft_last.form_launches == dict(
        dict.fromkeys(dft_kernel.FORMS, 0), **{form: runs})
    assert dft_kernel.pdft_last.launches == runs


PLANES = [  # (P, A, B), mats1 over B, mats2 over A, forms
    ((3, 20, 24), (24, 1, {}), (20, -1, {}), ("cluster",)),
    ((5, 9, 16), (16, -1, {}), (24, 1, {"rows": (20, 9)}), ("cluster",)),
    ((4, 24, 20), (20, -1, {"cols": (17, 6)}), (24, -1, {}), ("cluster",)),
    ((2, 7, 300), (300, -1, {}), (7, -1, {}), ("fft", "matrix")),
    ((2, 512, 9), (9, 1, {}), (512, 1, {}), ("cluster",)),
    ((1, 48, 512), (512, 1, {}), (48, 1, {}), ("cluster",)),
    ((1, 512, 512), (512, 1, {}), (512, -1, {}), ("fft", "fft")),
    ((2, 11, 13), (13, 1, {}), (11, 1, {}), ("matrix", "matrix")),
    ((1, 3, 5), (5, 1, {}), (3, 1, {}), ("cluster",))]


@pytest.mark.parametrize("case", range(len(PLANES)))
def test_plane_wrappers_launch_path(emulated, case):
    (p, a, b), (n1, s1, w1), (n2, s2, w2), forms = PLANES[case]
    rng = np.random.default_rng(4)
    m1 = dft.device_c2c(n1, s1, 1.0 / n1, **w1)
    m2 = dft.device_c2c(n2, s2, 2.0, **w2)
    assert dft_kernel.plane_forms(m1, m2, a) == forms
    x = (_t(rng, p, a, b), _t(rng, p, a, b))
    for wrapper, plain in ((dft_kernel.pdft2, dft.pdft2_minor),
                           (dft_kernel.pdft2_swapped, dft.cdft2_xy)):
        got, want = wrapper(*x, m1, m2), plain(*x, m1, m2)
        assert got[0].shape == want[0].shape
        assert _rel(torch.stack(got), torch.stack(want)) < TOL
        counts = dict.fromkeys(dft_kernel.FORMS, 0)
        for f in forms:
            counts[f] += 1
        assert wrapper.form_launches == counts
        assert wrapper.launches == len(forms)


def test_real_plane_wrappers_take_the_fft_form_for_their_cc_half(emulated):
    rng = np.random.default_rng(5)
    nx, ny, pp = 24, 20, 3
    xf = nx // 2 + 1
    x = _t(rng, pp, ny, nx)
    r2c = dft.device_mats(dft.r2c_mats(nx), "cpu")
    yf = dft.device_c2c(ny, dft.FORWARD)
    got = dft_kernel.prdft2(x, r2c, yf)
    assert _rel(torch.stack(got), torch.stack(dft.prdft2_minor(x, r2c, yf))) \
        < TOL
    yb = dft.device_c2c(ny, dft.BACKWARD)
    c2r = dft.device_mats(dft.c2r_mats(nx), "cpu")
    g = (_t(rng, pp, xf, ny), _t(rng, pp, xf, ny))
    got = dft_kernel.pdft2_cr(*g, yb, c2r)
    assert _rel(got, dft.pdft2_minor_cr(*g, yb, c2r)) < TOL
    for w in (dft_kernel.prdft2, dft_kernel.pdft2_cr):
        assert w.form_launches == {"matrix": 1, "fft": 1, "cluster": 0}
    assert emulated == ["spfft_dft_stage", "spfft_fft_stage",
                        "spfft_fft_stage", "spfft_dft_stage"]


# -- the plans hand a spec to every complex stage -----------------------------

def _record(monkeypatch):
    """Wrap the complex-stage wrappers (and the fused z kernels) so that
    each call records which of its matrix arguments carry their
    function; returns the list of ``(name, [DftMats?...])``."""
    seen = []

    def wrap(mod, name, picks):
        fn = getattr(mod, name)

        def rec(*args, **kw):
            seen.append((name, [isinstance(args[i], dft.DftMats)
                                for i in picks]))
            return fn(*args, **kw)

        monkeypatch.setattr(mod, name, rec)

    wrap(dft_kernel, "pdft_last", [2])
    wrap(dft_kernel, "pdft2", [2, 3])
    wrap(dft_kernel, "pdft2_swapped", [2, 3])
    wrap(dft_kernel, "prdft2", [2])       # its complex second stage
    wrap(dft_kernel, "pdft2_cr", [2])     # its complex first stage
    wrap(fused_kernel, "decompress_zdft", [2])
    wrap(fused_kernel, "zdft_compress", [2])
    return seen


def _sphere(dims, radius):
    def c(d):
        a = np.arange(d)
        return np.where(a > d // 2, a - d, a)
    X, Y, Z = np.meshgrid(c(dims[0]), c(dims[1]), c(dims[2]), indexing="ij")
    m = X * X + Y * Y + Z * Z <= radius * radius
    return np.stack([X[m], Y[m], Z[m]], axis=1).astype(np.int32)


LOCAL = {"c2c": ((16, 16, 16), 8, "C2C"),
         "c2c_split": ((24, 20, 16), 4, "C2C"),
         "r2c": ((12, 11, 13), None, "R2C")}


@pytest.mark.parametrize("name", sorted(LOCAL))
@pytest.mark.parametrize("fused", [True, False])
def test_local_plans_hand_a_spec_to_every_complex_stage(monkeypatch, name,
                                                        fused):
    dims, radius, tt = LOCAL[name]
    rng = np.random.default_rng(6)
    if radius is None:
        trip = hermitian_triplets(rng, dims)
    else:
        trip = _sphere(dims, radius)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    if tt == "R2C":  # a real field's spectrum, consistent hermitian values
        cube = np.fft.fftn(np.fft.ifftn(cube).real)
    vals = sample_cube(cube, trip, dims).astype(np.complex64)
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType[tt], *dims, trip,
                                   precision="single", use_pallas=False)
    want_b = np.asarray(jp.backward(vals))
    want_f = np.asarray(jp.forward(want_b, spfft_tpu.Scaling.FULL))
    seen = _record(monkeypatch)
    tp = sp.make_local_plan(sp.TransformType[tt], *dims, trip, device="cpu",
                            fused=fused)
    assert (tp.split_x is not None) == (name == "c2c_split")
    got_b = tp.backward(vals).numpy()
    got_f = tp.forward(torch.from_numpy(want_b), sp.Scaling.FULL).numpy()
    assert seen and all(all(flags) for _, flags in seen), seen
    names = {n for n, _ in seen}
    assert ("pdft2" in names) == (tt == "C2C")
    assert ("pdft_last" in names) == (not fused)
    assert _rel(got_b, want_b) < TOL and _rel(got_f, want_f) < TOL


DIST = {"c2c": ((12, 11, 13), "C2C", None),
        "c2c_split": ((24, 24, 24), "C2C", 6),
        "r2c": ((12, 11, 13), "R2C", None)}


@pytest.mark.parametrize("name", sorted(DIST))
def test_distributed_plans_hand_a_spec_to_every_complex_stage(monkeypatch,
                                                              name):
    dims, tt, radius = DIST[name]
    rng = np.random.default_rng(7)
    if tt == "R2C":
        trip = hermitian_triplets(rng, dims)
    elif radius is None:
        trip = random_sparse_triplets(rng, dims)
    else:
        trip = workloads.spherical_cutoff_triplets(dims[0], radius=radius)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    if tt == "R2C":
        cube = np.fft.fftn(np.fft.ifftn(cube).real)
    st = np.where(trip < 0, trip + np.array(dims), trip)
    owner = (st[:, 0] * 7 + st[:, 1]) % 3
    parts = [trip[owner == r] for r in range(3)]
    planes = [dims[2] - 2 * (dims[2] // 3), dims[2] // 3, dims[2] // 3]
    vals = [sample_cube(cube, p, dims).astype(np.complex64) for p in parts]
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType[tt], *dims,
                                    parts, planes, mesh=jpar.make_mesh(3),
                                    precision="single")
    want_b = np.array(jp.backward(vals))
    want_f = np.asarray(jp.forward(jax.device_put(want_b, jp._sharded),
                                   spfft_tpu.Scaling.FULL))
    for fused in (True, False):
        seen = _record(monkeypatch)
        tp = sp.make_distributed_plan(sp.TransformType[tt], *dims, parts,
                                      planes, device="cpu", fused=fused)
        assert (tp.split_x is not None) == (name == "c2c_split")
        got_b = tp.backward(vals).numpy()
        got_f = tp.forward(torch.from_numpy(want_b),
                           sp.Scaling.FULL).numpy()
        assert seen and all(all(flags) for _, flags in seen), seen
        assert _rel(got_b, want_b) < TOL and _rel(got_f, want_f) < TOL
        monkeypatch.undo()
