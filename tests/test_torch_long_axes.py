"""The port's long axes (above ``ops.dft.MATMUL_DFT_MAX`` = 512) against
the JAX package, on the CPU.

The JAX package runs on ``JAX_PLATFORMS=cpu`` with ``use_pallas=False``,
where its long axes are pocketfft (``jnp.fft``); the port's plans run
with ``device="cpu"``, every kernel wrapper on its plain version (the
two-stage product, a matrix product or ``torch.fft``). Cases:

* the builders: ``two_stage_factor``, ``mdft_coverable`` and the JAX
  package's routing predicate ``mdft_axes`` (with ``direct=`` /
  ``direct_any=``, read off the port's ``c2c_form`` / ``real_form``)
  equal the JAX package's for every n in 1..2100; each plain form against
  ``np.fft`` at 520, 521, 600, 768, 1000, 1024 and 1031;
* local C2C and R2C plans with one long axis and sparse sticks, single
  and double, against the JAX plan and the dense oracle; a distributed
  plan over 3 shards with a long z;
* a shrunk cap (as the JAX package's ``tiny_cap`` fixture,
  tests/test_dft_two_stage.py): a 12^3 plan whose every axis takes the
  two-pass form, on the plain versions and on the launch path;
* the launch path with the C entries emulated in numpy: the two-pass
  kernel (``csrc/fft_long.cu``) block by block, as its index arithmetic
  runs on the card, the long matrix form and the ``torch.fft`` form, each
  counted by form.

Tolerance: 2e-6 relative l2 against the JAX package in single precision,
1e-12 in double; the dense oracle within ``predicted_rel_error``.
"""

import functools
import math
import re

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.ops import dft as jdft

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import _build, dft, dft_kernel, fused_kernel

from test_torch_fft import _emulate, _view, entry_real, stockham

torch.set_num_threads(2)

TOL = {"single": 2e-6, "double": 1e-12}
LENGTHS = (520, 521, 600, 768, 1000, 1024, 1031)


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _c(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1].astype(np.float64)


# -- builders and the routing predicate ---------------------------------------

def _mdft_axes(*dims, direct=(), direct_any=()):
    """The JAX package's routing predicate (``mdft_axes``) in the port's
    forms: every axis in ``dims`` off ``torch.fft``, every axis in
    ``direct`` with a dense complex pair, every axis in ``direct_any``
    with a real form off ``torch.fft``."""
    return (all(dft.c2c_form(d) != "library" for d in dims)
            and all(dft.c2c_form(d) in ("fft", "matrix", "long_matrix")
                    for d in direct)
            and all(dft.real_form(d) != "library" for d in direct_any))


def test_two_stage_factor_and_predicate_match_jax(monkeypatch):
    monkeypatch.setenv("SPFFT_TPU_FORCE_MATMUL_DFT", "1")
    for n in range(1, 2101):
        assert dft.two_stage_factor(n) == jdft.two_stage_factor(n), n
        for kw in ({}, {"direct": (n,)}, {"direct_any": (n,)}):
            assert _mdft_axes(n, **kw) == \
                jdft.mdft_axes(np.float32, n, **kw), (n, kw)
        assert dft.mdft_coverable((n,)) == jdft.mdft_coverable((n,))
        assert dft.mdft_coverable((n, 8), True) == \
            jdft.mdft_coverable((n, 8), True)


def test_forms_by_length():
    assert [dft.c2c_form(n) for n in (512, 11, 520, 521, 768, 1024, 1031,
                                      2048, 1033)] == \
        ["fft", "matrix", "two_pass", "long_matrix", "two_pass", "two_pass",
         "library", "two_pass", "library"]
    assert [dft.real_form(n) for n in (512, 11, 768, 1000, 1022, 1024,
                                       1031, 2048)] == \
        ["rfft", "matrix", "rfft", "rfft", "long_matrix", "rfft", "library",
         "library"]
    m = dft.device_c2c(768, dft.BACKWARD)
    assert len(m) == 0 and m.split == (24, 32) and m.shape == (768, 768)
    assert tuple(m.twiddles.shape) == (2, 768)
    assert isinstance(dft.c2c_mats(768, dft.FORWARD), dft.TwoStageMats)


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("n", LENGTHS)
def test_plain_forms_match_numpy(n, precision):
    """The plain version of each form (the two-stage product, the long
    matrix, ``torch.fft``) against ``np.fft``: complex both ways, real
    to the half spectrum and back, with windows."""
    dtype = torch.float32 if precision == "single" else torch.float64
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    xt = x.astype(np.complex64 if precision == "single" else np.complex128)
    tol = TOL[precision]
    for sign in (dft.BACKWARD, dft.FORWARD):
        m = dft.device_c2c(n, sign, 0.5, dtype=dtype)
        assert m.form == dft.c2c_form(n)
        got = dft.pdft_last(torch.from_numpy(xt.real.copy()),
                            torch.from_numpy(xt.imag.copy()), m)
        want = 0.5 * (np.fft.ifft(xt) * n if sign == dft.BACKWARD
                      else np.fft.fft(xt))
        assert got[0].dtype == dtype
        assert _rel(got[0].numpy() + 1j * got[1].numpy(), want) <= tol
    # windows: input positions (x0 + k) % n, output (y0 + j) % n
    rows, cols = (n - 7, 40), (n - 3, 9)
    m = dft.device_c2c(n, dft.FORWARD, rows=rows, cols=cols, dtype=dtype)
    xw = xt[:, :40]
    full = np.zeros((3, n), xt.dtype)
    full[:, (rows[0] + np.arange(40)) % n] = xw
    want = np.fft.fft(full)[:, (cols[0] + np.arange(9)) % n]
    got = dft.pdft_last(torch.from_numpy(xw.real.copy()),
                        torch.from_numpy(xw.imag.copy()), m)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), want) <= tol
    # the real forms
    xf = n // 2 + 1
    r = xt.real.copy()
    mr = dft.device_r2c(n, cols=(2, xf - 3), dtype=dtype)
    assert mr.form == dft.real_form(n)
    got = dft.prdft_last(torch.from_numpy(r), mr)
    want = np.fft.rfft(r)[:, 2:xf - 1]
    assert _rel(got[0].numpy() + 1j * got[1].numpy(), want) <= tol
    spec = np.fft.rfft(r)
    spec[:, 0] += 0.25j  # an imaginary DC part: dropped, as irfft drops it
    mc = dft.device_c2r(n, 2.0, dtype=dtype)
    got = dft.pirdft_last(torch.from_numpy(spec.real.astype(r.dtype)),
                          torch.from_numpy(spec.imag.astype(r.dtype)), mc)
    assert _rel(got.numpy(), 2.0 * n * r) <= tol


def test_matrix_builders_above_the_cap():
    """A dense pair exists only where the length has a direct form: the
    two-pass lengths return their TwoStageMats, the library lengths
    raise."""
    cr, ci = dft.c2c_mats(521, dft.BACKWARD)
    assert cr.shape == (521, 521)
    for call in (lambda: dft.c2c_mats(1031, dft.FORWARD),
                 lambda: dft.sub_rows_mats(768, dft.BACKWARD, (0, 1)),
                 lambda: dft.r2c_mats(1031), lambda: dft.c2r_mats(2048)):
        with pytest.raises(sp.InvalidParameterError, match="no dense DFT"):
            call()
    a, b = dft.r2c_mats(1022)
    assert a.shape == (1022, 512)


def test_two_pass_plain_refuses_reduced_fp32_matmul():
    mm = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    if mm is None or not hasattr(mm, "fp32_precision"):
        pytest.skip("this PyTorch has no oneDNN fp32_precision setting")
    m = dft.device_c2c(768, dft.BACKWARD)
    x = torch.zeros((2, 768))
    prev = mm.fp32_precision
    mm.fp32_precision = "bf16"
    try:
        with pytest.raises(sp.DeviceError, match="pdft_last"):
            dft.pdft_last(x, x, m)
    finally:
        mm.fp32_precision = prev


# -- plans against the JAX package --------------------------------------------

def _grid_triplets(dims, keep, seed):
    rng = np.random.default_rng(seed)
    g = [np.arange(d) for d in dims]
    t = np.stack(np.meshgrid(*g, indexing="ij"), -1).reshape(-1, 3)
    return t[rng.random(len(t)) < keep].astype(np.int32)


def _oracle(dims, trip, vals):
    nx, ny, nz = dims
    g = np.zeros((nz, ny, nx), np.complex128)
    t = np.where(trip < 0, trip + np.array(dims), trip)
    g[t[:, 2], t[:, 1], t[:, 0]] = vals
    return np.fft.ifftn(g) * (nx * ny * nz)


def _hermitian_values(dims, trip, seed):
    """Values of a seeded real field's spectrum at the half-set triplets:
    a consistent hermitian set."""
    nx, ny, nz = dims
    field = np.random.default_rng(seed).standard_normal((nz, ny, nx))
    spec = np.fft.fftn(field)
    return spec[trip[:, 2], trip[:, 1], trip[:, 0]], field * (nx * ny * nz)


C2C_PLANS = {"z1024": (8, 8, 1024), "x521": (521, 6, 4), "y768": (4, 768, 3),
             "z520": (6, 5, 520), "x1031": (1031, 3, 2)}
R2C_PLANS = {"x1000": (1000, 4, 3), "x1022": (1022, 3, 4),
             "x1031": (1031, 3, 2), "x768z520": (768, 2, 520)}


@functools.lru_cache(maxsize=None)
def _local_case(kind, name, precision):
    dims = (C2C_PLANS if kind == "c2c" else R2C_PLANS)[name]
    cdt = np.complex64 if precision == "single" else np.complex128
    if kind == "c2c":
        trip = _grid_triplets(dims, 0.3, 5)
        rng = np.random.default_rng(6)
        vals = (rng.standard_normal(len(trip))
                + 1j * rng.standard_normal(len(trip))).astype(cdt)
        oracle = _oracle(dims, trip, vals)
    else:
        trip = _grid_triplets((dims[0] // 2 + 1,) + dims[1:], 1.0, 5)
        vals, oracle = _hermitian_values(dims, trip, 7)
        vals = vals.astype(cdt)
    tt = kind.upper()
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType[tt], *dims, trip,
                                   precision=precision, use_pallas=False)
    tp = sp.make_local_plan(sp.TransformType[tt], *dims, trip,
                            precision=precision, device="cpu")
    return dims, trip, vals, oracle, jp, tp


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("kind,name", [("c2c", n) for n in C2C_PLANS]
                         + [("r2c", n) for n in R2C_PLANS])
def test_local_plan_matches_jax_and_oracle(kind, name, precision):
    dims, trip, vals, oracle, jp, tp = _local_case(kind, name, precision)
    tb = tp.backward(vals).numpy()
    jb = np.asarray(jp.backward(vals))
    space = (lambda a: a) if kind == "r2c" else _c
    assert tb.shape == jb.shape
    assert _rel(space(tb), space(jb)) <= TOL[precision]
    assert _rel(space(tb), oracle) <= tp.predicted_error
    for scaling in ("none", "full"):
        tf = tp.forward(jb, sp.Scaling(scaling)).numpy()
        jf = np.asarray(jp.forward(jb, spfft_tpu.Scaling(scaling)))
        assert _rel(_c(tf), _c(jf)) <= TOL[precision]
    rt = tp.forward(tb, sp.Scaling.FULL).numpy()
    assert _rel(_c(rt), vals) <= 1e-6 if precision == "single" else 1e-12
    np.testing.assert_array_equal(tp.backward(vals).numpy(), tb)
    # the fused kernels decline a long z; every other plan keeps them
    long_z = dims[2] > fused_kernel.MAX_DIM_Z
    assert tp.fused_active is not long_z
    assert tp.fused_fallback_reasons == (
        {"dec": "dimz_over_cap", "cmp": "dimz_over_cap"} if long_z else {})


def test_predicted_error_takes_the_jax_rule():
    """The uncalibrated factor applies where the JAX package's matrix forms
    do not cover the axes (a C2C axis with neither split nor direct form,
    an R2C x axis above 1024)."""
    for kind, name, covered in (("c2c", "z1024", True),
                                ("c2c", "x1031", False),
                                ("r2c", "x1022", True),
                                ("r2c", "x1031", False)):
        dims = _local_case(kind, name, "single")[0]
        tp = _local_case(kind, name, "single")[5]
        assert tp.predicted_error == sp.predicted_rel_error(
            "single", max(dims), covered)
        assert covered == jdft.mdft_coverable(dims, kind == "r2c")


@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_distributed_plan_with_a_long_z_matches_jax(kind):
    dims = (6, 5, 520) if kind == "c2c" else (10, 4, 520)
    x_extent = dims[0] if kind == "c2c" else dims[0] // 2 + 1
    trip = _grid_triplets((x_extent,) + dims[1:], 0.5 if kind == "c2c"
                          else 1.0, 8)
    keys = trip[:, 0] * dims[1] + trip[:, 1]
    parts = [trip[keys % 3 == r] for r in range(3)]
    planes = [200, 160, 160]
    if kind == "c2c":
        rng = np.random.default_rng(9)
        vals = [(rng.standard_normal(len(p)) + 1j
                 * rng.standard_normal(len(p))).astype(np.complex64)
                for p in parts]
    else:
        vals = [_hermitian_values(dims, p, 10)[0].astype(np.complex64)
                for p in parts]
    tt = kind.upper()
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType[tt], *dims,
                                    parts, planes, mesh=jpar.make_mesh(3),
                                    precision="single")
    tp = sp.make_distributed_plan(sp.TransformType[tt], *dims, parts,
                                  planes, device="cpu")
    assert tp.fused_dist_fallback_reason == "dimz_over_cap"
    assert not tp.fused_dist_active
    jb = np.asarray(jp.backward(vals))
    tb = tp.backward(vals).numpy()
    space = (lambda a: a) if kind == "r2c" else _c
    assert _rel(space(tb), space(jb)) <= TOL["single"]
    tf = tp.forward(torch.from_numpy(jb), sp.Scaling.FULL).numpy()
    jf = np.asarray(jp.forward(jax.device_put(jb, jp._sharded),
                               spfft_tpu.Scaling.FULL))
    assert _rel(_c(tf), _c(jf)) <= TOL["single"]


# -- the launch path, with the C entries emulated -----------------------------

#: buffer rows of one emulated block (small, so that blocks straddle the
#: rows of the length-n view and the planes of a transposed store)
EMU_ROWS = 7


def _cu_constant(name):
    """An ``int`` constant of csrc/fft_long.cu, read from the source."""
    src = (_build.CSRC / "fft_long.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


#: the longest row of the one-launch kernel, as the source sets it
#: (WHOLE_THREADS x WHOLE_EPT): what ``spfft_fft_long_whole_n`` returns
WHOLE_N = _cu_constant("WHOLE_THREADS") * _cu_constant("WHOLE_EPT")


def _pass_dft(buf, L, n, sign, code, tw):
    """One pass's transform of the buffer rows ``buf`` (R, L): the
    Stockham FFT of fft_tile.cuh for a 2^a 3^b 5^c factor (``code`` its
    radices), else the direct DFT in slices of 16 terms (``dft_rows``),
    both on the sub-table ``tw[m n / L]``."""
    sub = tw[np.arange(L) * (n // L)]
    if code:
        factors = []
        while code:
            factors.append(code & 7)
            code >>= 3
        return stockham(buf, sign, factors, sub)
    k = np.arange(L)
    w = sub[np.outer(k, k) % L]
    out = np.zeros_like(buf)
    for j0 in range(0, L, 16):
        out = out + buf[:, j0:j0 + 16] @ w[j0:j0 + 16]
    return out


def emulate_long(args, real):
    """``spfft_fft_long`` (``_f64``) block by block, with the kernel's own
    index arithmetic: buffer row b of block q0 is row q0 + b of the pass's
    (M G, L) view, (m0 + (r0 + b) // G, (r0 + b) % G)."""
    (pas, xr, xi, yr, yi, tw, m, n, n1, n2, plane_rows, sign, scale,
     code1, code2) = args
    if pas == 0:
        emulate_whole(args, real)
        return
    code = code1 if pas == 1 else code2
    cdt = np.complex64 if real == np.float32 else np.complex128
    x = (_view(xr, m * n, real) + 1j * _view(xi, m * n, real)).astype(cdt)
    ydr, ydi = _view(yr, m * n, real), _view(yi, m * n, real)
    t = _view(tw, 2 * n, real)
    table = (t[:n] + 1j * t[n:]).astype(cdt)
    np.testing.assert_array_equal(t[:n], dft.fft_twiddles(n, sign)
                                  .real.astype(real))
    L, G = (n1, n2) if pas == 1 else (n2, n1)
    assert code == dft.radix_code(dft.fft_factors(L))
    total = m * G
    for q0 in range(0, total, EMU_ROWS):
        valid = min(EMU_ROWS, total - q0)
        m0, r0 = divmod(q0, G)
        b = np.arange(valid)
        d, g = np.divmod(r0 + b, G)
        rows = m0 + d
        i = np.arange(L)
        if pas == 1:
            src = rows[:, None] * n + i[None, :] * n2 + g[:, None]
        else:
            src = q0 * L + b[:, None] * L + i[None, :]
        buf = _pass_dft(x[src], L, n, sign, code, table)
        if pas == 1:
            out = buf * table[g[:, None] * i[None, :]]
            dst = src
        elif plane_rows == 0:
            out = buf * real(scale)
            dst = rows[:, None] * n + i[None, :] * n1 + g[:, None]
        else:
            out = buf * real(scale)
            nm = (q0 + valid - 1) // G - m0 + 1
            bb = np.arange(nm)[:, None] * G + np.arange(G)[None, :] - r0
            ok = (bb >= 0) & (bb < valid)
            col, gg = np.nonzero(ok)
            # every buffer row is stored exactly once
            assert sorted(bb[ok].tolist()) == b.tolist()
            p, a = np.divmod(m0 + col, plane_rows)
            dst = (p[:, None] * n + i[None, :] * n1 + gg[:, None]) \
                * plane_rows + a[:, None]
            out = out[bb[ok]]
        ydr[dst.reshape(-1)] = out.real.reshape(-1)
        ydi[dst.reshape(-1)] = out.imag.reshape(-1)


def emulate_whole(args, real):
    """``spfft_fft_long`` pass 0 (``fft_long_whole_kernel``) block by
    block, with the kernel's index arithmetic: a block's R = 4096 // n
    rows load into sub-rows (r, i2) of n1, pass 1, move to sub-rows (r,
    k1) of n2 times W_n^(i2 k1), pass 2, and store straight or transposed
    within planes."""
    (_, xr, xi, yr, yi, tw, m, n, n1, n2, plane_rows, sign, scale, code1,
     code2) = args
    assert n <= WHOLE_N
    cdt = np.complex64 if real == np.float32 else np.complex128
    x = (_view(xr, m * n, real) + 1j * _view(xi, m * n, real)).astype(cdt)
    ydr, ydi = _view(yr, m * n, real), _view(yi, m * n, real)
    t = _view(tw, 2 * n, real)
    table = (t[:n] + 1j * t[n:]).astype(cdt)
    assert code1 == dft.radix_code(dft.fft_factors(n1))
    assert code2 == dft.radix_code(dft.fft_factors(n2))
    rows = WHOLE_N // n
    for m0 in range(0, m, rows):
        valid = min(rows, m - m0)
        total = valid * n
        f = np.arange(total)
        r, q = np.divmod(f, n)
        i1, i2 = np.divmod(q, n2)
        a = np.zeros((valid * n2, n1), cdt)
        a[r * n2 + i2, i1] = x[m0 * n + f]
        a = _pass_dft(a, n1, n, sign, code1, table)
        i2, k1 = np.divmod(q, n1)
        b = np.zeros((valid * n1, n2), cdt)
        b[r * n1 + k1, i2] = a[r * n2 + i2, k1] * table[i2 * k1]
        b = _pass_dft(b, n2, n, sign, code2, table) * real(scale)
        if plane_rows == 0:
            k2, k1 = np.divmod(q, n1)
            dst, val = m0 * n + f, b[r * n1 + k1, k2]
        else:
            k, r = np.divmod(f, valid)
            k2, k1 = np.divmod(k, n1)
            p, a0 = np.divmod(m0, plane_rows)
            p, aa = p + (a0 + r) // plane_rows, (a0 + r) % plane_rows
            dst, val = (p * n + k) * plane_rows + aa, b[r * n1 + k1, k2]
        ydr[dst] = val.real
        ydi[dst] = val.imag


def _emulate_any(symbol, args):
    base, real = entry_real(symbol)
    if base == "spfft_fft_long":
        emulate_long(args, real)
    else:
        _emulate(symbol, args)


WRAPPERS = (dft_kernel.pdft_last, dft_kernel.pdft2, dft_kernel.pdft2_swapped,
            dft_kernel.prdft2, dft_kernel.pdft2_cr, dft_kernel.prdft_last,
            dft_kernel.pirdft_last)


@pytest.fixture
def emulated(monkeypatch):
    """The DFT wrappers take their launch path on CPU tensors (the gather
    and the fused kernels keep their plain versions), each launch run by
    its numpy emulation; yields the launched symbols."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda",
                        lambda t, what: what not in (
                            "gather", "decompress_zdft", "zdft_compress"))

    def function(source, symbol, argtypes):
        if symbol == "spfft_fft_long_whole_n":
            return lambda: WHOLE_N
        return source, symbol

    monkeypatch.setattr(_build, "function", function)

    def launch(fn, what, device, *args):
        calls.append(fn[1])
        _emulate_any(fn[1], args)

    monkeypatch.setattr(_build, "launch", launch)
    for w in WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "form_launches",
                            dict.fromkeys(dft_kernel.ALL_FORMS, 0))
    yield calls


def _counts(**forms):
    return dict(dict.fromkeys(dft_kernel.ALL_FORMS, 0), **forms)


def _t(rng, *shape, dtype=torch.float32):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,lead,window", [
    (520, (5,), {}), (768, (2, 3), {}), (600, (4,), {"rows": (590, 20)}),
    (1024, (3,), {"cols": (1000, 50)}), (521, (3,), {}), (9216, (2,), {}),
    (4096, (2,), {}),
    (521, (2,), {"rows": (500, 30), "cols": (7, 9)}), (1031, (3,), {}),
    (1031, (2,), {"rows": (1020, 20)})])
def test_pdft_last_long_launch_path(emulated, n, lead, window, dtype):
    rng = np.random.default_rng(n)
    tol = 2e-6 if dtype == torch.float32 else 1e-12
    form = dft.c2c_form(n)
    for sign in (dft.BACKWARD, dft.FORWARD):
        m = dft.device_c2c(n, sign, 0.25, dtype=dtype, **window)
        k = m.shape[0]
        x = (_t(rng, *lead, k, dtype=dtype), _t(rng, *lead, k, dtype=dtype))
        got = dft_kernel.pdft_last(*x, m)
        want = dft.pdft_last(*x, m)
        assert got[0].shape == want[0].shape == lead + (m.shape[1],)
        w = want[0].double().numpy() + 1j * want[1].double().numpy()
        assert _rel(got[0].numpy() + 1j * got[1].numpy(), w) <= tol
    per_call = 2 if form == "two_pass" and n > 4096 else 1
    assert dft_kernel.pdft_last.form_launches == _counts(
        **{form: 2 * per_call})
    # a torch.fft call launches no kernel of the package
    assert dft_kernel.pdft_last.launches == \
        (0 if form == "library" else 2 * per_call) == len(emulated)
    if form == "two_pass":
        assert all(c.startswith("spfft_fft_long") for c in emulated)


PLANES = [  # (P, A, B), (n1, sign1, window1) over B, (n2, ...) over A
    ((2, 6, 520), (520, 1, {}), (6, 1, {})),
    ((2, 520, 6), (6, -1, {}), (520, -1, {})),
    ((3, 5, 768), (768, 1, {"rows": (760, 5)}), (5, 1, {})),
    ((1, 600, 4), (4, 1, {}), (600, -1, {"cols": (590, 20)})),
    ((2, 7, 521), (521, 1, {}), (7, 1, {})),
    ((2, 3, 1031), (1031, 1, {}), (3, -1, {})),
    ((1, 520, 521), (521, -1, {}), (520, -1, {})),
    # above the one-launch kernel's rows: pass 1, then pass 2
    ((1, 3, 8192), (8192, 1, {}), (3, 1, {})),
    ((1, 4608, 2), (2, -1, {}), (4608, -1, {})),
    ((2, 3, 5200), (5200, 1, {"rows": (5190, 20)}), (3, 1, {})),
    ((1, 6000, 2), (2, 1, {}), (6000, -1, {"cols": (5990, 20)})),
    ((2, 4, 4097), (4097, -1, {}), (4, 1, {})),
    ((1, 2, 9216), (9216, 1, {}), (2, -1, {})),
    ((1, 2, 8192), (8192, -1, {"cols": (100, 50)}), (2, 1, {}))]


@pytest.mark.parametrize("case", range(len(PLANES)))
def test_plane_wrappers_long_launch_path(emulated, case):
    """Both launch forms of the two-pass kernel: one launch a stage where
    a row fits a block (4096), and pass 1 then pass 2 above it (a direct
    factor in 5200 = 65 x 80 and 4097 = 17 x 241); each stage counted
    where it launches."""
    (p, a, b), (n1, s1, w1), (n2, s2, w2) = PLANES[case]
    rng = np.random.default_rng(case)
    m1 = dft.device_c2c(n1, s1, 1.0 / n1, **w1)
    m2 = dft.device_c2c(n2, s2, 2.0, **w2)
    assert "cluster" not in dft_kernel.plane_forms(m1, m2, a)
    x = (_t(rng, p, a, m1.shape[0]), _t(rng, p, a, m1.shape[0]))
    for wrapper, plain in ((dft_kernel.pdft2, dft.pdft2_minor),
                           (dft_kernel.pdft2_swapped, dft.cdft2_xy)):
        before = len(emulated)
        got, want = wrapper(*x, m1, m2), plain(*x, m1, m2)
        assert got[0].shape == want[0].shape
        w = want[0].double().numpy() + 1j * want[1].double().numpy()
        assert _rel(got[0].numpy() + 1j * got[1].numpy(), w) <= 2e-6
        counts = _counts()
        for n in (n1, n2):
            f = dft.c2c_form(n)
            counts[f] += 2 if f == "two_pass" and n > 4096 else 1
        assert wrapper.form_launches == counts
        assert wrapper.launches == len(emulated) - before == \
            sum(v for f, v in counts.items() if f != "library")


@pytest.mark.parametrize("n", [1000, 768, 1022, 1031])
def test_real_wrappers_long_launch_path(emulated, n):
    """The real stages above 512: the real FFT form (1000, 768), the long
    matrix form (1022) and ``torch.fft`` (1031), alone and as the real
    halves of ``prdft2`` / ``pdft2_cr``."""
    rng = np.random.default_rng(n)
    xf = n // 2 + 1
    form = dft.real_form(n)
    r2c = dft.device_r2c(n, 0.5, cols=(1, xf - 2))
    c2r = dft.device_c2r(n, 2.0)
    x = _t(rng, 3, 4, n)
    got, want = dft_kernel.prdft_last(x, r2c), dft.prdft_last(x, r2c)
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                want[0].double().numpy() + 1j * want[1].double().numpy()) \
        <= 2e-6
    y = (_t(rng, 3, 4, xf), _t(rng, 3, 4, xf))
    got, want = dft_kernel.pirdft_last(*y, c2r), dft.pirdft_last(*y, c2r)
    assert _rel(got.numpy(), want.double().numpy()) <= 2e-6
    assert dft_kernel.prdft_last.form_launches == _counts(**{form: 1})
    my = dft.device_c2c(4, 1)
    got = dft_kernel.prdft2(x, r2c, dft.device_c2c(4, -1))
    want = dft.prdft2_minor(x, r2c, dft.device_c2c(4, -1))
    assert _rel(got[0].numpy() + 1j * got[1].numpy(),
                want[0].double().numpy() + 1j * want[1].double().numpy()) \
        <= 2e-6
    yy = (_t(rng, 3, xf, 4), _t(rng, 3, xf, 4))
    got = dft_kernel.pdft2_cr(*yy, my, c2r)
    want = dft.pdft2_minor_cr(*yy, my, c2r)
    assert _rel(got.numpy(), want.double().numpy()) <= 2e-6
    assert dft_kernel.pdft2_cr.form_launches == _counts(fft=1, **{form: 1})
    assert len(emulated) == sum(w.launches for w in WRAPPERS)


@pytest.fixture
def tiny_cap(monkeypatch):
    """Shrink the port's cap to 8, as the JAX package's ``tiny_cap`` does,
    so that a 12^3 plan takes the two-pass form on every axis (12 = 3 x
    4); the caches keyed on lengths are cleared before and after."""
    caches = (dft.two_stage_factor, dft.fft_factors, dft._two_stage_mats,
              dft._build_dft_mats)
    monkeypatch.setattr(dft, "MATMUL_DFT_MAX", 8)
    for c in caches:
        c.cache_clear()
    yield
    for c in caches:
        c.cache_clear()


@pytest.mark.parametrize("route", ["plain", "launch"])
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_tiny_cap_plan_runs_the_two_pass_form_on_every_axis(
        tiny_cap, request, kind, route):
    n = 12
    assert dft.c2c_form(n) == "two_pass"
    if route == "launch":
        request.getfixturevalue("emulated")
    dims = (n, n, n)
    if kind == "c2c":
        trip = _grid_triplets(dims, 0.4, 7)
        rng = np.random.default_rng(8)
        vals = (rng.standard_normal(len(trip))
                + 1j * rng.standard_normal(len(trip))).astype(np.complex64)
        oracle = _oracle(dims, trip, vals)
    else:
        trip = _grid_triplets((n // 2 + 1, n, n), 1.0, 7)
        vals, oracle = _hermitian_values(dims, trip, 9)
        vals = vals.astype(np.complex64)
    tp = sp.make_local_plan(sp.TransformType[kind.upper()], *dims, trip,
                            device="cpu", fused=False)
    tb = tp.backward(vals).numpy()
    space = (lambda a: a) if kind == "r2c" else _c
    assert _rel(space(tb), oracle) <= 1e-6
    rt = tp.forward(tb, sp.Scaling.FULL).numpy()
    assert _rel(_c(rt), vals) <= 1e-6
    if route == "launch":
        z = dft_kernel.pdft_last.form_launches
        assert z["two_pass"] == 2  # the z stage, one launch a direction
        xy = dft_kernel.pdft2.form_launches if kind == "c2c" else None
        if xy is not None:
            assert xy == _counts(two_pass=4)  # y and x, both directions
        else:
            assert dft_kernel.pdft2_cr.form_launches == _counts(two_pass=1,
                                                                rfft=1)
            assert dft_kernel.prdft2.form_launches == _counts(two_pass=1,
                                                              rfft=1)
        assert len(request.getfixturevalue("emulated")) == \
            sum(w.launches for w in WRAPPERS)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 15, 16, 33, 64, 97])
def test_stick_major_sphere_equals_the_sorted_jax_sphere(n):
    """``spherical_cutoff_triplets_stick_major`` (the 768^3 cell's set,
    built stick by stick) equals the JAX package's sphere sorted
    stick-major, for every radius form."""
    from spfft_tpu.utils import workloads as jwl
    from spfft_tpu_torch.utils import workloads
    for radius in (None, 0, 1, n // 3):
        got = workloads.spherical_cutoff_triplets_stick_major(n, radius)
        want = jwl.sort_triplets_stick_major(
            jwl.spherical_cutoff_triplets(n, radius), (n, n, n))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_library_counts_by_form_only():
    class W:
        launches = 0
        form_launches = {}
    _build.count(W, "library")
    _build.count(W, "two_pass")
    assert W.launches == 1
    assert W.form_launches == {"library": 1, "two_pass": 1}


def test_fused_kernels_decline_a_long_z():
    assert fused_kernel.eligible_dim(512) is None
    assert fused_kernel.eligible_dim(520) == "dimz_over_cap"
    m = dft.device_c2c(520, dft.BACKWARD)
    v = torch.zeros((4, 2))
    with pytest.raises(sp.InvalidParameterError, match="dimz_over_cap"):
        fused_kernel.decompress_zdft(v, torch.zeros(520, dtype=torch.int32),
                                     m, 520)
    tp = sp.make_local_plan(sp.TransformType.C2C, 2, 2, 520,
                            np.array([[0, 0, 0], [1, 1, 5]]), device="cpu",
                            fused=False)
    assert tp.fused_fallback_reasons == {} and not tp.fused_active


def test_long_axis_lengths_of_the_split_x_window():
    """A split window on a long C2C x axis: the plan's x stage expands the
    window to the whole axis (a two-pass axis has no rows to select), and
    the result matches the JAX plan."""
    dims = (768, 5, 3)
    trip = _grid_triplets((40, 4, 3), 0.6, 3)
    trip -= np.array([20, 2, 1], np.int32)  # centered: a wrapped x window
    rng = np.random.default_rng(4)
    vals = (rng.standard_normal(len(trip))
            + 1j * rng.standard_normal(len(trip))).astype(np.complex64)
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.C2C, *dims, trip,
                                   precision="single", use_pallas=False)
    tp = sp.make_local_plan(sp.TransformType.C2C, *dims, trip, device="cpu")
    assert tp.split_x is not None and tp.split_x[1] == 40
    assert _rel(_c(tp.backward(vals).numpy()),
                _c(np.asarray(jp.backward(vals)))) <= TOL["single"]
    assert math.isclose(tp.predicted_error,
                        sp.predicted_rel_error("single", 768, True))
