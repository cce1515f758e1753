"""Double precision in the port, on the CPU.

* Local plans (``precision="double"``): C2C and R2C at an odd size
  (17^3, a prime length: the matrix forms) and a 2·3·5 one (30^3: the
  FFT forms), the fused and the two-kernel route, the interleaved and
  the planar pair value layout. Every result is float64; the backward
  and the forward (NONE and FULL) lie within ``predicted_rel_error(
  "double", n)`` of a numpy float64 dense oracle and within twice that
  of the JAX package's float64 plan (XLA under x64, tests/conftest.py)
  on the same values; the routes agree bit for bit; a batch of B = 3
  and the pointwise calls equal the single calls bit for bit.
* Distributed plans over 3 shards (uneven, one empty), C2C and R2C,
  both routes: within twice the envelope of the JAX package's float64
  distributed plan, the routes bit for bit.
* Every float64 C entry through the wrappers' launch path, with the
  entries emulated in numpy through the pointers the wrappers pass (the
  emulations of test_torch_fft, test_torch_rfft, test_torch_zfft and
  test_torch_gather, which read ``_f64`` entries as float64): the FFT
  stage and cluster kernels, the real FFT stage, the matrix forms, both
  fused z kernels in both forms, and the gather, whose wide accesses
  are checked against 16-byte values; and whole double plans through
  that path against their plain versions.
* The wrappers refuse a mixture of float32 and float64 operands.
* ``convert.plan_from_arrays`` / ``distributed_plan_from_arrays`` build
  double plans from the JAX package's index-plan arrays.

Tolerances: the envelope ``predicted_rel_error("double", n)`` (about
4e-15 here) against the oracles, twice it against the JAX package (both
are float64 FFTs, summed in different orders); 1e-13 relative l2 for a
float64 kernel's emulation against its plain version (an FFT against a
matrix product in float64); the gather and the port against itself bit
for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu import plan as jplan_mod

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch import plan as tplan_mod
from spfft_tpu_torch.errors import InvalidParameterError
from spfft_tpu_torch.ops import (_build, dft, dft_kernel, fused_kernel,
                                 gather_kernel)

from test_distributed import split_by_sticks, split_planes
from test_torch_gather import emulated_gather  # noqa: F401 (a fixture)
from test_torch_zfft import _emulate as emulate_z
from test_util import (dense_backward, dense_cube_from_values,
                       dense_forward, hermitian_triplets,
                       random_sparse_triplets, random_values, sample_cube)

torch.set_num_threads(2)

F64 = torch.float64
B = 3
#: a float64 kernel's emulation against its plain version
EMU_TOL = 1e-13


def _pred(dims):
    return sp.predicted_rel_error("double", max(dims), True)


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _c(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1]


def _band_limited(dims, trip, seed):
    """(values, dense spectrum): a seeded real field's spectrum masked
    by the hermitian closure of ``trip`` (consistent R2C values)."""
    nx, ny, nz = dims
    field = np.random.default_rng(seed).standard_normal((nz, ny, nx))
    st = np.where(trip < 0, trip + np.array(dims), trip)
    mask = np.zeros((nz, ny, nx), bool)
    mask[st[:, 2], st[:, 1], st[:, 0]] = True
    mask[(-st[:, 2]) % nz, (-st[:, 1]) % ny, (-st[:, 0]) % nx] = True
    freq = dense_forward(field) * mask
    return sample_cube(freq, trip, dims), freq


#: (kind, dims): one odd size (17: the matrix forms) and one 2·3·5 size
#: (30: the FFT forms)
LOCAL = {"c2c_17": ("c2c", (17, 17, 17)), "c2c_30": ("c2c", (30, 30, 30)),
         "r2c_17": ("r2c", (17, 17, 17)), "r2c_30": ("r2c", (30, 30, 30))}


@functools.lru_cache(maxsize=None)
def _local_inputs(name):
    """(kind, dims, triplets, values, dense spectrum) from a numpy seed."""
    kind, dims = LOCAL[name]
    rng = np.random.default_rng(sum(dims) + len(kind))
    if kind == "c2c":
        trip = random_sparse_triplets(rng, dims, 0.6, 0.6)
        vals = random_values(rng, len(trip))
        return kind, dims, trip, vals, dense_cube_from_values(trip, vals,
                                                              dims)
    trip = hermitian_triplets(rng, dims)
    vals, freq = _band_limited(dims, trip, seed=len(trip))
    return kind, dims, trip, vals, freq


def _tt(kind):
    return (sp.TransformType.C2C, spfft_tpu.TransformType.C2C) \
        if kind == "c2c" else (sp.TransformType.R2C,
                               spfft_tpu.TransformType.R2C)


@functools.lru_cache(maxsize=None)
def _jax_local(name, pair):
    """The JAX package's float64 plan's backward and forward (NONE,
    FULL) of the case, in the layout ``pair`` asks for."""
    kind, dims, trip, vals, _ = _local_inputs(name)
    saved = jplan_mod.PAIR_IO_THRESHOLD
    jplan_mod.PAIR_IO_THRESHOLD = 0 if pair else saved
    try:
        jp = spfft_tpu.make_local_plan(_tt(kind)[1], *dims, trip,
                                       precision="double")
        assert jp.pair_values_io == pair
        jb = np.asarray(jp.backward(vals))
        return jb, {sc: np.asarray(jp.forward(jb, spfft_tpu.Scaling(sc)))
                    for sc in ("none", "full")}
    finally:
        jplan_mod.PAIR_IO_THRESHOLD = saved


def _values_of(out, pair):
    """Values in a public layout as complex."""
    out = np.asarray(out)
    return out[0] + 1j * out[1] if pair else _c(out)


@pytest.mark.parametrize("pair", [False, True], ids=["interleaved", "pair"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_kernel"])
@pytest.mark.parametrize("name", sorted(LOCAL))
def test_local_double_plan(monkeypatch, name, fused, pair):
    kind, dims, trip, vals, freq = _local_inputs(name)
    monkeypatch.setattr(tplan_mod, "PAIR_IO_THRESHOLD",
                        0 if pair else tplan_mod.PAIR_IO_THRESHOLD)
    tp = sp.make_local_plan(_tt(kind)[0], *dims, trip, precision="double",
                            device="cpu", fused=fused)
    assert tp.pair_values_io == pair and tp.real_dtype == F64
    pred = _pred(dims)
    jb, jf = _jax_local(name, pair)

    tb = tp.backward(vals)
    assert tb.dtype == F64 and tuple(tb.shape) == jb.shape
    space = dense_backward(freq)
    got_b = tb.numpy() if kind == "r2c" else _c(tb.numpy())
    want_b = space.real if kind == "r2c" else space
    assert _rel(got_b, want_b) <= pred
    assert _rel(got_b, jb if kind == "r2c" else _c(jb)) <= 2 * pred

    want_f = sample_cube(dense_forward(want_b), trip, dims)
    for sc, scale in (("none", 1.0), ("full", 1.0 / np.prod(dims))):
        tf = tp.forward(tb, sp.Scaling(sc))
        assert tf.dtype == F64
        got_f = _values_of(tf.numpy(), pair)
        assert _rel(got_f, want_f * scale) <= pred
        assert _rel(got_f, _values_of(jf[sc], pair)) <= 2 * pred


@pytest.mark.parametrize("name", sorted(LOCAL))
def test_local_double_routes_batches_and_pointwise_agree(name):
    """The two routes bit for bit; B = 3 bands and the pointwise calls
    against the single calls bit for bit."""
    kind, dims, trip, vals, _ = _local_inputs(name)
    plans = [sp.make_local_plan(_tt(kind)[0], *dims, trip,
                                precision="double", device="cpu",
                                fused=fused) for fused in (True, False)]
    full = sp.Scaling.FULL
    outs = [(p.backward(vals), p.forward(p.backward(vals), full))
            for p in plans]
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    tp = plans[0]
    bands = np.stack([vals * (1 + b / 2) for b in range(B)])
    space_b = tp.backward_batched(bands)
    out_b = tp.forward_batched(space_b, full)
    assert space_b.dtype == out_b.dtype == F64
    for b in range(B):
        one = tp.backward(bands[b])
        assert torch.equal(space_b[b], one)
        assert torch.equal(out_b[b], tp.forward(one, full))
    pot = torch.as_tensor(np.random.default_rng(1).random(dims[::-1]))

    def fn(space, w):
        return space * (w if kind == "r2c" else w[..., None])

    want = tp.forward(fn(tp.backward(vals), pot), full)
    assert torch.equal(tp.apply_pointwise(vals, fn, pot, scaling=full), want)
    want = tp.forward(fn(tp.backward(want), pot), full)
    assert torch.equal(tp.iterate_pointwise(
        tp.forward(fn(tp.backward(vals), pot), full), fn, pot, steps=1),
        want)


def test_double_grid_and_multi_transform_match_the_plan():
    kind, dims, trip, vals, _ = _local_inputs("c2c_30")
    tp = sp.make_local_plan(sp.TransformType.C2C, *dims, trip,
                            precision="double", device="cpu")
    grid = sp.Grid(*dims, 1000, precision="double", device="cpu")
    t = grid.create_transform(sp.ProcessingUnit.DEVICE,
                              sp.TransformType.C2C, *dims, indices=trip)
    assert t.precision == "double"
    want = tp.backward(vals)
    assert torch.equal(t.backward(vals), want)
    ts = [t, t.clone()]
    spaces = sp.multi_transform_backward(ts, [vals, vals])
    outs = sp.multi_transform_forward(ts, spaces, [sp.Scaling.FULL] * 2)
    want_f = tp.forward(want, sp.Scaling.FULL)
    for s_, o in zip(spaces, outs):
        assert torch.equal(s_, want) and torch.equal(o, want_f)


# -- distributed --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dist_inputs(kind):
    """3 shards, uneven, the second empty (no sticks, no planes)."""
    dims = (16, 15, 18)
    rng = np.random.default_rng(11)
    if kind == "c2c":
        trip = random_sparse_triplets(rng, dims, 0.6, 0.6)
        cube = dense_cube_from_values(trip, random_values(rng, len(trip)),
                                      dims)
    else:
        trip = hermitian_triplets(rng, dims)
        _, cube = _band_limited(dims, trip, 12)
    parts = split_by_sticks(trip, dims, [3, 0, 1])
    planes = split_planes(dims[2], [1, 0, 2])
    vals = [sample_cube(cube, p, dims) for p in parts]
    jp = jpar.make_distributed_plan(_tt(kind)[1], *dims, parts, planes,
                                    mesh=jpar.make_mesh(3),
                                    precision="double")
    jb = np.array(jp.backward(vals))
    jf = np.asarray(jp.forward(jax.device_put(jb, jp._sharded),
                               spfft_tpu.Scaling.FULL))
    return dims, parts, planes, vals, cube, jb, jf


@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_distributed_double_plan_matches_jax(kind):
    dims, parts, planes, vals, cube, jb, jf = _dist_inputs(kind)
    assert len(parts[1]) == 0 and planes[1] == 0
    pred = _pred(dims)
    outs = []
    for fused in (True, False):
        tp = sp.make_distributed_plan(_tt(kind)[0], *dims, parts, planes,
                                      device="cpu", fused=fused,
                                      precision="double")
        tb = tp.backward(vals)
        tf = tp.forward(tb, sp.Scaling.FULL)
        assert tb.dtype == tf.dtype == F64
        dp = tp.dist_plan  # 16-byte values on the wire
        assert tp.exchange_wire_bytes() == 3 * 2 * dp.max_sticks \
            * dp.max_planes * 16
        got_b = tb.numpy() if kind == "r2c" else _c(tb.numpy())
        assert _rel(got_b, jb if kind == "r2c" else _c(jb)) <= 2 * pred
        slabs = np.concatenate([got_b[r, :planes[r]] for r in range(3)])
        space = dense_backward(cube)
        assert _rel(slabs, space.real if kind == "r2c" else space) <= pred
        assert _rel(_c(tf.numpy()), _c(jf)) <= 2 * pred
        outs.append((tb, tf))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# -- the float64 C entries through the launch path ----------------------------

WRAPPERS = (dft_kernel.pdft_last, dft_kernel.prdft_last,
            dft_kernel.pirdft_last, dft_kernel.pdft2,
            dft_kernel.pdft2_swapped, dft_kernel.prdft2,
            dft_kernel.pdft2_cr, fused_kernel.decompress_zdft,
            fused_kernel.zdft_compress)


@pytest.fixture
def emulated(monkeypatch):
    """The DFT wrappers and the fused z kernels take their launch path on
    CPU tensors, each launch run by the numpy emulation of its C entry;
    yields the list of launched entries."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda", lambda t, what: what != "gather")
    monkeypatch.setattr(_build, "function",
                        lambda source, symbol, argtypes: (symbol, argtypes))

    def launch(fn, what, device, *args):
        symbol, argtypes = fn
        # every real scalar of a float64 entry is a double
        reals = {a for a in argtypes if a in _build.REAL_TYPES.values()}
        assert reals <= {_build.REAL_TYPES[F64 if symbol.endswith("_f64")
                                            else torch.float32]}
        calls.append(symbol)
        emulate_z(symbol, args)

    monkeypatch.setattr(_build, "launch", launch)
    for w in WRAPPERS:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "form_launches",
                            dict.fromkeys(dft_kernel.ALL_FORMS, 0))
    yield calls


def _t(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape), dtype=F64)


def _close(got, want, tol=EMU_TOL):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == F64 and g.shape == w.shape
        assert _rel(g.numpy(), w.numpy()) <= tol


@pytest.mark.parametrize("n,window", [(12, {}), (60, {"cols": (50, 20)}),
                                      (256, {}), (384, {"rows": (200, 100)}),
                                      (13, {})])
def test_f64_stage_entries(emulated, n, window):
    """``pdft_last`` (the FFT stage, or the matrix form at 13) and the
    plane wrappers (the cluster kernel) on float64 operands."""
    rng = np.random.default_rng(n)
    for sign in (dft.BACKWARD, dft.FORWARD):
        m = dft.device_c2c(n, sign, 0.5, dtype=F64, **window)
        assert m[0].dtype == F64
        assert m.twiddles is None or m.twiddles.dtype == F64
        x = (_t(rng, 7, m[0].shape[0]), _t(rng, 7, m[0].shape[0]))
        _close(dft_kernel.pdft_last(*x, m), dft.pdft_last(*x, m))
    want = "spfft_dft_stage_f64" if n == 13 else "spfft_fft_stage_f64"
    assert emulated == [want] * 2
    m1 = dft.device_c2c(n, dft.BACKWARD, dtype=F64)
    m2 = dft.device_c2c(24, dft.FORWARD, 1 / 24, dtype=F64)
    x = (_t(rng, 2, 24, n), _t(rng, 2, 24, n))
    _close(dft_kernel.pdft2(*x, m1, m2), dft.pdft2_minor(*x, m1, m2))
    _close(dft_kernel.pdft2_swapped(*x, m1, m2), dft.cdft2_xy(*x, m1, m2))
    if n != 13:
        assert emulated[2:] == ["spfft_fft_plane_f64"] * 2


@pytest.mark.parametrize("nx,win", [(24, None), (24, (3, 7)), (250, None),
                                    (256, (50, 79)), (14, None)])
def test_f64_real_entries(emulated, nx, win):
    """The real FFT stage (or the matrix form at 14: a 7 in the half) on
    float64 operands, straight and within ``prdft2`` / ``pdft2_cr``; the
    imaginary parts at DC and Nyquist never reach the real inverse."""
    rng = np.random.default_rng(nx)
    r2c = dft.device_r2c(nx, cols=win, device="cpu", dtype=F64)
    c2r = dft.device_c2r(nx, rows=win, device="cpu", dtype=F64)
    k = r2c[0].shape[1]
    x = _t(rng, 3, 5, nx)
    _close(dft_kernel.prdft_last(x, r2c), dft.prdft_last(x, r2c))
    hr, hi = _t(rng, 3, 5, k), _t(rng, 3, 5, k)
    got = dft_kernel.pirdft_last(hr, hi, c2r)
    _close(got, dft.pirdft_last(hr, hi, c2r))
    xf = nx // 2 + 1
    bins = [((win or (0,))[0] + j) % xf for j in range(k)]
    edge = [j for j, q in enumerate(bins) if q in (0, nx // 2)]
    hi2 = hi.clone()
    hi2[..., edge] += 1.0
    assert torch.equal(dft_kernel.pirdft_last(hr, hi2, c2r), got)
    y = dft.device_c2c(5, dft.FORWARD, dtype=F64)
    yb = dft.device_c2c(5, dft.BACKWARD, dtype=F64)
    _close(dft_kernel.prdft2(x, r2c, y), dft.prdft2_minor(x, r2c, y))
    g = (_t(rng, 3, k, 5), _t(rng, 3, k, 5))
    _close(dft_kernel.pdft2_cr(*g, yb, c2r), dft.pdft2_minor_cr(*g, yb, c2r))
    real = "spfft_dft_stage_f64" if nx == 14 else "spfft_rfft_stage_f64"
    assert set(emulated) == {real, "spfft_fft_stage_f64"}


def _slots(s, dz, rng):
    from spfft_tpu_torch.indexing import inverse_slot_map
    slots = np.flatnonzero(rng.random(s * dz) < 0.5)
    slots = np.concatenate([slots, slots[:3]])  # duplicate triplets
    rng.shuffle(slots)
    nv = len(slots)
    ss = torch.as_tensor(np.concatenate(
        [inverse_slot_map(slots, s * dz, nv),
         np.full(dz, nv, np.int32)]).astype(np.int32))
    csr = tuple(torch.as_tensor(t) for t in fused_kernel.compress_csr(
        slots, s, dz))
    return nv, ss, csr


@pytest.mark.parametrize("dz", [12, 13, 128])
@pytest.mark.parametrize("pair", [False, True])
def test_f64_z_entries(emulated, dz, pair):
    """Both fused z kernels on float64 values and sticks (FFT form, or
    the matrix form at 13), B = 3, the R2C zero stick, both layouts."""
    rng = np.random.default_rng(dz + pair)
    s = 9
    nv, ss, csr = _slots(s, dz, rng)
    zb = dft.device_c2c(dz, dft.BACKWARD, dtype=F64)
    zf = dft.device_c2c(dz, dft.FORWARD, 1.0 / dz, dtype=F64)
    for lead in ((), (B,)):
        vals = _t(rng, *lead, 2, nv) if pair else _t(rng, *lead, nv, 2)
        for zid in (-1, 0):
            _close(fused_kernel.decompress_zdft(vals, ss, zb, dz, pair, zid),
                   fused_kernel.decompress_zdft_plain(vals, ss, zb, dz, pair,
                                                      zid))
        sr, si = _t(rng, *lead, s, dz), _t(rng, *lead, s, dz)
        _close(fused_kernel.zdft_compress(sr, si, zf, csr, pair),
               fused_kernel.zdft_compress_plain(sr, si, zf, csr, pair))
    form = "" if dz == 13 else "_fft"
    assert set(emulated) == {f"spfft_decompress_zdft{form}_f64",
                             f"spfft_zdft_compress{form}_f64"}


def _offset(shape, off, rng):
    """A float64 view of ``shape`` starting ``off`` elements into a
    buffer (off = 1: 8 bytes off every 16-byte boundary)."""
    buf = torch.as_tensor(rng.standard_normal(int(np.prod(shape)) + 4))
    return buf[off:off + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("num_out", [1, 5, 13, 40])
@pytest.mark.parametrize("off", [0, 1])
def test_f64_gather_entry(emulated_gather, num_out, off):
    """``spfft_gather_f64`` against the plain version, exact: ragged
    groups, views one element (8 bytes) off their alignment, interleaved
    and planar values both ways, 3 shards of B = 5; its emulation checks
    every wide access against 16-byte pairs and 16-byte stores."""
    rng = np.random.default_rng(num_out + off)
    gk = gather_kernel
    n, shards, batch = 11, 3, 5
    idx = torch.as_tensor(rng.integers(-2, n + 3, shards * num_out + 1)
                          .astype(np.int32))[off:off + shards * num_out] \
        .view(shards, num_out)
    valid = torch.as_tensor(rng.random(shards * num_out + 1) < 0.8)[
        off:off + shards * num_out].view(shards, num_out)
    for il_src in (True, False):
        if il_src:
            t = _offset((shards, batch, n, 2), off, rng)
            src = t[..., 0], t[..., 1]
        else:
            t = _offset((shards, batch, 2, n), off, rng)
            src = t[:, :, 0], t[:, :, 1]
        outs = {}
        for how in ("kernel", "plain"):
            if il_src:  # planar output
                t = _offset((shards, batch, 2, num_out), off, rng)
                o = t[:, :, 0], t[:, :, 1]
            else:
                t = _offset((shards, batch, num_out, 2), off, rng)
                o = t[..., 0], t[..., 1]
            for p in o:
                p.fill_(np.nan)
            (gk.gather if how == "kernel" else gk.gather_plain)(
                src, idx, o, valid)
            outs[how] = o
        for g, w in zip(outs["kernel"], outs["plain"]):
            assert g.dtype == F64
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    if off:  # 8 bytes off: no pair and no 16-byte store is aligned
        assert not any(w & (gk.SRC_PAIR | gk.OUT_PAIR | gk.OUT_PLANAR)
                       for w in emulated_gather)
    else:  # interleaved (S, B, 11, 2) doubles: 16-byte pair loads
        assert [w & gk.SRC_PAIR for w in emulated_gather] == [gk.SRC_PAIR,
                                                              0]
        # and 16-byte pair stores (an axis of one element has no stride)
        assert bool(emulated_gather[1] & gk.OUT_PAIR) == (num_out > 1)


def test_f64_layout_word_reckons_in_the_element_size():
    """A double row 8 bytes off 16 takes no wide pair store; a float row
    8 bytes off 16 does (float2, float4s, float2)."""
    w = gather_kernel._layout_word
    st = (0, 0, 2)
    # interleaved output starting 8 bytes past a 16-byte boundary
    assert not w((0, 8), st, 0, 0, None, 0, (8, 16), st, 8) \
        & gather_kernel.OUT_PAIR
    assert w((0, 4), st, 0, 0, None, 0, (8, 12), st, 4) \
        & gather_kernel.OUT_PAIR
    assert w((0, 8), st, 0, 0, None, 0, (16, 24), st, 8) \
        & gather_kernel.OUT_PAIR
    # planar output: 16-byte stores need 2 doubles (not 4) a stride unit
    assert w((0, 8), st, 0, 0, None, 0, (0, 16), (2, 2, 1), 8) \
        & gather_kernel.OUT_PLANAR
    assert not w((0, 4), st, 0, 0, None, 0, (0, 16), (2, 2, 1), 4) \
        & gather_kernel.OUT_PLANAR


@pytest.mark.parametrize("kind,fused", [("c2c", True), ("r2c", True),
                                        ("c2c", False), ("r2c", False)])
def test_double_plan_through_the_launch_path(emulated, monkeypatch, kind,
                                             fused):
    """A whole double plan at 30^3 with every kernel through its emulated
    float64 entry, against the same plan on the plain versions: every
    entry launched is an ``_f64`` one, and the results agree."""
    if not fused:  # the gather through its emulation too
        from test_torch_gather import _Emulated
        monkeypatch.setattr(gather_kernel, "_build", _Emulated)
        monkeypatch.setattr(_Emulated, "calls", [])
    _, dims, trip, vals, _ = _local_inputs(f"{kind}_30")
    tp = sp.make_local_plan(_tt(kind)[0], *dims, trip, precision="double",
                            device="cpu", fused=fused)
    got_b = tp.backward(vals)
    got_f = tp.forward(got_b, sp.Scaling.FULL)
    assert emulated and all(c.endswith("_f64") for c in emulated)
    monkeypatch.undo()
    want_b = tp.backward(vals)
    _close(got_b, want_b)
    _close(got_f, tp.forward(want_b, sp.Scaling.FULL))


# -- refusals -----------------------------------------------------------------

def test_wrappers_refuse_a_mixture_of_real_types():
    m64 = dft.device_c2c(8, dft.FORWARD, dtype=F64)
    m32 = dft.device_c2c(8, dft.FORWARD)
    x64, x32 = torch.zeros((2, 8, 8), dtype=F64), torch.zeros((2, 8, 8))
    mix = "shares one real type"
    with pytest.raises(InvalidParameterError, match=mix):
        dft_kernel.pdft_last(x64, x64, m32)
    with pytest.raises(InvalidParameterError, match=mix):
        dft_kernel.pdft_last(x64, x32, m64)
    with pytest.raises(InvalidParameterError, match=mix):
        dft_kernel.pdft2(x32, x32, m64, m64)
    bad = dft.DftMats(*m64, n=8, sign=dft.FORWARD, scale=1.0, rows=(0, 8),
                      cols=(0, 8), twiddles=m32.twiddles)
    with pytest.raises(InvalidParameterError, match="twiddle"):
        dft_kernel.pdft_last(x64, x64, bad)
    r64 = dft.device_r2c(8, dtype=F64)
    with pytest.raises(InvalidParameterError, match=mix):
        dft_kernel.prdft_last(x32, r64)
    with pytest.raises(InvalidParameterError, match="float32 or"):
        dft_kernel.pdft_last(x64.half(), x64.half(), m64)
    ss = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(InvalidParameterError, match=mix):
        fused_kernel.decompress_zdft(torch.zeros((3, 2), dtype=F64), ss,
                                     m32, 8)
    csr = tuple(torch.as_tensor(a) for a in fused_kernel.compress_csr(
        np.array([0, 9]), 2, 8))
    with pytest.raises(InvalidParameterError, match=mix):
        fused_kernel.zdft_compress(torch.zeros((2, 8), dtype=F64),
                                   torch.zeros((2, 8)), m64, csr)
    src = (torch.zeros((2, 8), dtype=F64),) * 2
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(InvalidParameterError, match="one\\s+real type"):
        gather_kernel.gather(src, idx, (torch.zeros((2, 4)),) * 2)
    with pytest.raises(InvalidParameterError, match=mix):
        gather_kernel.compress(torch.zeros((2, 8), dtype=F64),
                               torch.zeros((2, 8)), idx)


# -- plans from the JAX package's arrays --------------------------------------

def test_double_plans_from_jax_index_plan_arrays():
    kind, dims, trip, vals, _ = _local_inputs("r2c_30")
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.R2C, *dims, trip,
                                   precision="double")
    tp = convert.plan_from_arrays(dataclasses.asdict(jp.index_plan),
                                  device="cpu", precision="double")
    assert tp.precision == "double" and tp.real_dtype == F64
    jb = np.asarray(jp.backward(vals))
    pred = _pred(dims)
    assert _rel(tp.backward(vals).numpy(), jb) <= 2 * pred

    dims, parts, planes, dvals, _, djb, _ = _dist_inputs("c2c")
    jd = jpar.make_distributed_plan(spfft_tpu.TransformType.C2C, *dims,
                                    parts, planes, mesh=jpar.make_mesh(3),
                                    precision="double")
    td = convert.distributed_plan_from_arrays(
        [dataclasses.asdict(p) for p in jd.dist_plan.shard_plans], planes,
        device="cpu", precision="double")
    assert td.precision == "double"
    tb = td.backward(dvals)
    assert tb.dtype == F64
    assert _rel(_c(tb.numpy()), _c(djb)) <= 2 * _pred(dims)


# -- the main path's size -----------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("kind", ["c2c", "r2c"])
def test_double_plan_at_256(kind):
    """The 256^3 sphere (C2C) or its half (R2C) in double on the plain
    versions against the numpy float64 oracle and the round trip."""
    from spfft_tpu_torch.utils import workloads
    n = 256
    dims = (n, n, n)
    trip = workloads.spherical_cutoff_triplets(n)
    if kind == "r2c":
        x, y, z = trip[:, 0], trip[:, 1], trip[:, 2]
        trip = trip[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))]
        vals, freq = _band_limited(dims, trip, 0)
    else:
        vals = random_values(np.random.default_rng(0), len(trip))
        freq = dense_cube_from_values(trip, vals, dims)
    tp = sp.make_local_plan(_tt(kind)[0], *dims, trip, precision="double",
                            device="cpu")
    tb = tp.backward(vals)
    space = dense_backward(freq)
    got = tb.numpy() if kind == "r2c" else _c(tb.numpy())
    pred = _pred(dims)
    assert _rel(got, space.real if kind == "r2c" else space) <= pred
    out = tp.forward(tb, sp.Scaling.FULL)
    assert _rel(_c(out.numpy()), vals) <= 3 * pred
