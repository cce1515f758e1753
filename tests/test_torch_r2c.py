"""The port's R2C path on the CPU (every kernel wrapper on its plain
version) against the JAX package on the same inputs, made from numpy
seeds: the real-transform matrix builders bit for bit; the plain
``prdft2`` / ``pdft2_cr`` and the completing ``decompress_zdft`` against
the Pallas kernels in interpret mode and against the XLA compositions
they replace; the R2C plan against ``spfft_tpu.make_local_plan(R2C,
precision="single", use_pallas=False)`` and a dense f64 oracle.

Tolerances: 2e-6 (relative l2, or rtol = atol for unit-variance data)
against the JAX package, whose f32 sums run in another order; the plan
within ``predicted_rel_error`` of the oracle. The oracle is a
band-limited real field: a seeded real field's spectrum masked by the
hermitian closure of the triplet set, so that the sparse values fully
determine a real space slab (random complex values would not: the
self-mirrored bins must agree with their mirrors)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spfft_tpu
from spfft_tpu import plan as jplan_mod
from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import dft_kernel as jdk
from spfft_tpu.ops import fused_kernel as jfk
from spfft_tpu.ops import gather_kernel as jgk
from spfft_tpu.ops import stages as jstages

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch import plan as tplan_mod
from spfft_tpu_torch.errors import InvalidParameterError
from spfft_tpu_torch.indexing import inverse_slot_map
from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel, stages

from test_util import (center_triplets, dense_forward, hermitian_triplets,
                       sample_cube)

torch.set_num_threads(2)

TOL = 2e-6


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _mats(m):
    """(a, b) tensors of a matrix pair, or of the first two of the JAX
    package's Karatsuba triple."""
    return dft.device_mats(m[:2], "cpu")


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _close_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= TOL * max(np.linalg.norm(want),
                                                   1e-30)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


# -- matrix builders ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 12, 13, 128, 256])
def test_real_mats_equal_jax(n):
    for s in (1.0, 1.0 / (3 * n)):
        for got, want in ((dft.r2c_mats(n, s), jdft.r2c_mats(n, s)),
                          (dft.c2r_mats(n, s), jdft.c2r_mats(n, s))):
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)
    rows = tuple(range(n // 2 + 1))[1:4] or (0,)
    for got, want in ((dft.sub_rows_c2r_mats(n, rows),
                       jdft.sub_rows_c2r_mats(n, rows)),
                      (dft.sub_cols_r2c_mats(n, rows),
                       jdft.sub_cols_r2c_mats(n, rows))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_real_mats_above_the_cap_raise():
    for build in (dft.r2c_mats, dft.c2r_mats):
        with pytest.raises(InvalidParameterError, match="MATMUL_DFT_MAX"):
            build(513)


# -- prdft2 / pdft2_cr --------------------------------------------------------

WINDOW = (3, 4, 5, 6, 7)


def _rc_mats(kind, n):
    """Stage-1 matrices of prdft2 over a real axis of length n."""
    if kind == "cols":
        return jdft.sub_cols_r2c_mats(n, WINDOW[:min(5, n // 2)])
    return jdft.r2c_mats(n)


def _cr_mats(kind, n):
    """Stage-2 matrices of pdft2_cr onto a real axis of length n."""
    if kind == "rows":
        return jdft.sub_rows_c2r_mats(n, WINDOW[:min(5, n // 2)])
    return jdft.c2r_mats(n)


@pytest.mark.parametrize("case", [
    ((5, 10, 12), "full"),
    ((3, 7, 15), "full"),     # odd real axis: no Nyquist bin
    ((2, 6, 24), "cols"),     # split-x window, x0 > 0
])
def test_prdft2_matches_jax_interpret(case):
    (p, a, b), kind = case
    x = _rand((p, a, b), 7)
    m1, m2 = _rc_mats(kind, b), jdft.c2c_mats(a, jdft.FORWARD)
    want = jdk.prdft2(jnp.asarray(x), m1, m2, interpret=True)
    got = dft_kernel.prdft2(_t(x), _mats(m1), _mats(m2))
    assert tuple(got[0].shape) == tuple(want[0].shape)
    _close_l2(got[0], want[0])
    _close_l2(got[1], want[1])


@pytest.mark.parametrize("case", [
    ((3, 12, 14), "full"),
    ((2, 15, 9), "full"),     # odd real axis
    ((4, 24, 10), "rows"),    # split-x window, x0 > 0
])
def test_pdft2_cr_matches_jax_interpret(case):
    (p, n, b), kind = case
    m2 = _cr_mats(kind, n)
    a = m2[0].shape[0]
    xr, xi = _rand((p, a, b), 8), _rand((p, a, b), 9)
    m1 = jdft.c2c_mats(b, jdft.BACKWARD)
    want = jdk.pdft2_cr(jnp.asarray(xr), jnp.asarray(xi), m1, m2,
                        interpret=True)
    got = dft_kernel.pdft2_cr(_t(xr), _t(xi), _mats(m1), _mats(m2))
    assert tuple(got.shape) == tuple(want.shape) == (p, b, n)
    _close_l2(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 24, 128])
def test_real_xy_stages_match_jax_composition(n):
    """prdft2 and pdft2_cr against the JAX package's XLA three-pass forms
    (``prdft2_minor`` / ``pdft2_minor_cr`` off the TPU), with a window of
    the half spectrum starting at 0 where n allows one."""
    p, a = 3, 6
    x = _rand((p, a, n), n)
    for m1 in (jdft.r2c_mats(n), jdft.sub_cols_r2c_mats(n, (0, 1))
               if n >= 2 else jdft.r2c_mats(n)):
        m2 = jdft.c2c_mats(a, jdft.FORWARD)
        want = jdft.prdft2_minor(jnp.asarray(x), m1, m2)
        got = dft_kernel.prdft2(_t(x), _mats(m1), _mats(m2))
        _close_l2(got[0], want[0])
        _close_l2(got[1], want[1])
    for m2 in (jdft.c2r_mats(n), jdft.sub_rows_c2r_mats(n, (0, 1))
               if n >= 2 else jdft.c2r_mats(n)):
        k = m2[0].shape[0]
        xr, xi = _rand((p, k, a), n + 1), _rand((p, k, a), n + 2)
        m1 = jdft.c2c_mats(a, jdft.BACKWARD)
        want = jdft.pdft2_minor_cr(jnp.asarray(xr), jnp.asarray(xi), m1, m2)
        _close_l2(dft_kernel.pdft2_cr(_t(xr), _t(xi), _mats(m1),
                                      _mats(m2)), want)


def test_real_xy_wrappers_check_operands():
    m = _mats(jdft.c2c_mats(8, jdft.FORWARD))
    r = _mats(jdft.r2c_mats(8))
    x = torch.zeros((2, 8, 8))
    with pytest.raises(InvalidParameterError, match="float32"):
        dft_kernel.prdft2(x.double(), r, m)
    with pytest.raises(InvalidParameterError, match="shape"):
        dft_kernel.prdft2(x, r, _mats(jdft.c2c_mats(7, jdft.FORWARD)))
    with pytest.raises(InvalidParameterError, match="shape"):
        dft_kernel.pdft2_cr(x, torch.zeros((2, 8, 7)), m, m)
    with pytest.raises(InvalidParameterError, match="contiguous"):
        dft_kernel.pdft2_cr(x.transpose(1, 2), x, m, m)


# -- hermitian completion -----------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_completion_matches_jax(n):
    rng = np.random.default_rng(n)
    v = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    v[rng.random((3, n)) < 0.4] = 0
    v[0, 0] = 0
    v = v.astype(np.complex64)
    want = np.stack([np.asarray(jstages.complete_stick_hermitian(
        jnp.asarray(row))) for row in v])
    gr, gi = stages.complete_stick_hermitian(_t(v.real), _t(v.imag))
    np.testing.assert_array_equal(gr.numpy() + 1j * gi.numpy(), want)
    grid = (rng.standard_normal((2, 3, n))
            + 1j * rng.standard_normal((2, 3, n))).astype(np.complex64)
    grid[:, 0, ::2] = 0
    want = np.asarray(jstages.complete_plane_hermitian_t(jnp.asarray(grid)))
    gr, gi = _t(grid.real).clone(), _t(grid.imag).clone()
    stages.complete_plane_hermitian_t(gr, gi)
    np.testing.assert_array_equal(gr.numpy() + 1j * gi.numpy(), want)


# -- decompress_zdft with the (0,0)-stick completion --------------------------

def test_decompress_zdft_completion_matches_jax_interpret():
    """The zero stick (stick 3) holds z in [0, 64] of 128 and z = 123,
    the mirror of z = 5, whose given value is an exact 0: completion by
    value fills it, completion of empty slots would not. Tables as
    tests/test_fused_kernel.py builds them."""
    rng = np.random.default_rng(2)
    s_pad, dim_z, zid = 32, 128, 3
    num_slots = s_pad * dim_z
    occ = rng.random(num_slots) < 0.6
    occ.reshape(s_pad, dim_z)[zid] = np.arange(dim_z) <= dim_z // 2
    occ.reshape(s_pad, dim_z)[zid, dim_z - 5] = True
    vi = np.flatnonzero(occ)
    (dec_idx, occupied), _ = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(dec_idx, occupied, len(vi))
    ft = jfk.build_fused_decompress_tables(nt, dim_z, s_pad,
                                           zero_stick_id=zid)
    assert not isinstance(ft, str), ft
    vals = (rng.standard_normal((len(vi), 2))
            / np.sqrt(dim_z)).astype(np.float32)
    vals[np.searchsorted(vi, zid * dim_z + 5)] = 0.0
    re, im = jgk.planar_from_interleaved(jnp.asarray(vals), nt.src_rows)
    mats = jdft.c2c_mats(dim_z, jdft.BACKWARD)
    wr, wi = jfk.run_decompress_zdft(
        re, im, jfk.decompress_device_tables(ft), jfk.commit_mats(mats),
        ft, interpret=True)
    slot_src = _t(inverse_slot_map(vi, num_slots, len(vi)))
    gr, gi = fused_kernel.decompress_zdft(_t(vals), slot_src, _mats(mats),
                                          dim_z, zero_stick=zid)
    _close(gr, np.asarray(wr)[:s_pad])
    _close(gi, np.asarray(wi)[:s_pad])


def _zero_stick_slots(s, dz, zid, kind, seed):
    """Occupied slots of s sticks (every third one empty) with the zero
    stick ``zid`` given as ``kind``: "half" (z in [0, dz//2]), "exact0"
    (the half and z = dz - 1, the mirror of z = 1), "empty" (no slot),
    or "all"."""
    rng = np.random.default_rng(seed)
    occ = rng.random((s, dz)) < 0.5
    occ[::3] = False
    if zid >= 0:
        occ[zid] = {"half": np.arange(dz) <= dz // 2,
                    "exact0": (np.arange(dz) <= dz // 2)
                    | (np.arange(dz) == dz - 1),
                    "empty": np.zeros(dz, bool),
                    "all": np.ones(dz, bool)}[kind]
    slots = np.flatnonzero(occ)
    return slots[rng.permutation(len(slots))]


@pytest.mark.parametrize("dz", [12, 13, 16])
@pytest.mark.parametrize("kind", ["half", "empty", "exact0", "absent"])
@pytest.mark.parametrize("pair", [False, True])
def test_decompress_zdft_completion_matches_jax_composition(dz, kind,
                                                            pair):
    s = 10
    zid = -1 if kind == "absent" else 4
    slots = _zero_stick_slots(s, dz, zid, kind, seed=dz)
    nv = len(slots)
    rng = np.random.default_rng(dz + 1)
    vals = (rng.standard_normal((nv, 2)) / np.sqrt(dz)).astype(np.float32)
    if kind == "exact0":  # a given exact 0 counts as missing: its mirror
        vals[np.flatnonzero(slots == zid * dz + 1)] = 0.0  # dz-1 is given
    ss = np.concatenate([inverse_slot_map(slots, s * dz, nv),
                         np.full(dz, nv, np.int32)])
    mats = jdft.c2c_mats(dz, jdft.BACKWARD)
    flat = jstages.gather_rows_with_sentinel(jnp.asarray(vals),
                                             jnp.asarray(ss))
    sticks = (flat[:, 0] + 1j * flat[:, 1]).reshape(s + 1, dz)
    if zid >= 0:
        sticks = sticks.at[zid].set(
            jstages.complete_stick_hermitian(sticks[zid]))
    if kind == "exact0":  # filled from its given mirror, not left at 0
        assert sticks[zid, 1] == np.conj(sticks[zid, dz - 1]) != 0
    wr, wi = jdft.pdft_last(jnp.real(sticks), jnp.imag(sticks), mats)
    v = _t(vals.T) if pair else _t(vals)
    gr, gi = fused_kernel.decompress_zdft(v, _t(ss), _mats(mats), dz, pair,
                                          zero_stick=zid)
    _close(gr, wr)
    _close(gi, wi)
    assert not gr[s].any() and not gi[s].any()  # the sentinel stick


def test_decompress_zdft_refuses_a_zero_stick_out_of_range():
    ss = torch.full((16,), 3, dtype=torch.int32)
    m = _mats(jdft.c2c_mats(8, jdft.BACKWARD))
    for zid in (-2, 2):
        with pytest.raises(InvalidParameterError, match="zero_stick"):
            fused_kernel.decompress_zdft(torch.zeros((3, 2)), ss, m, 8,
                                         zero_stick=zid)


# -- the R2C plan -------------------------------------------------------------

def _fold_some(trip, dims, rng):
    """Centered triplets with some x > 0 values given as their x < 0
    mirror (-x, -y, -z): the folded input ``value_conj`` marks."""
    t = center_triplets(trip, dims).astype(np.int64)
    flip = (t[:, 0] > 0) & (2 * t[:, 0] != dims[0]) \
        & (rng.random(len(t)) < 0.5)
    t[flip] = -t[flip]
    return t.astype(np.int32)


def _case_triplets(name):
    rng = np.random.default_rng(31)
    if name.startswith("herm"):
        dims = tuple(int(d) for d in name[4:].split("x"))
        return dims, hermitian_triplets(rng, dims)
    if name == "centered":
        dims = (8, 9, 10)
        return dims, center_triplets(hermitian_triplets(rng, dims), dims)
    if name == "folded":
        dims = (12, 10, 9)
        return dims, _fold_some(hermitian_triplets(rng, dims), dims, rng)
    if name == "split0":  # occupied x [0, 5) of 13: split (0, 5)
        dims = (24, 20, 18)
        return dims, np.array([[x, y, z] for x in range(5)
                               for y in range(dims[1])
                               for z in range(dims[2])], np.int32)
    if name == "split3":  # occupied x [3, 8) of 13: split (3, 5)
        dims = (24, 20, 18)
        return dims, np.array([[x, y, z] for x in range(3, 8)
                               for y in range(dims[1])
                               for z in range(dims[2])], np.int32)
    raise KeyError(name)


CASES = ("herm2x2x2", "herm11x12x13", "herm13x11x12", "herm32x32x32",
         "centered", "folded", "split0", "split3")


def _band_limited(dims, trip, seed):
    """(values, real space oracle of backward): a seeded real field's
    spectrum masked by the hermitian closure of ``trip``."""
    nx, ny, nz = dims
    field = np.random.default_rng(seed).standard_normal((nz, ny, nx))
    st = np.where(trip < 0, trip + np.array(dims), trip)
    mask = np.zeros((nz, ny, nx), bool)
    mask[st[:, 2], st[:, 1], st[:, 0]] = True
    mask[(-st[:, 2]) % nz, (-st[:, 1]) % ny, (-st[:, 0]) % nx] = True
    freq = dense_forward(field) * mask
    space = np.fft.ifftn(freq)
    assert np.abs(space.imag).max() < 1e-12
    return sample_cube(freq, trip, dims), space.real * space.size


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _c(a):
    a = np.asarray(a)
    return a[..., 0] + 1j * a[..., 1].astype(np.float64)


def _plans(dims, trip):
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType.R2C, *dims, trip,
                                   precision="single", use_pallas=False)
    tp = sp.make_local_plan(sp.TransformType.R2C, *dims, trip, device="cpu")
    return jp, tp


@functools.lru_cache(maxsize=None)
def _case(name):
    dims, trip = _case_triplets(name)
    vals, oracle = _band_limited(dims, trip, seed=len(trip))
    vals = vals.astype(np.complex64)
    jp, tp = _plans(dims, trip)
    jb = np.asarray(jp.backward(vals))
    tb = tp.backward(vals).numpy()
    out = {"dims": dims, "trip": trip, "vals": vals, "oracle": oracle,
           "jp": jp, "tp": tp, "jb": jb, "tb": tb}
    for sc in ("none", "full"):
        out["jf_" + sc] = np.asarray(jp.forward(jb, spfft_tpu.Scaling(sc)))
        out["tf_" + sc] = tp.forward(jb, sp.Scaling(sc)).numpy()
    return out


@pytest.mark.parametrize("name", CASES)
def test_r2c_backward_matches_jax_and_oracle(name):
    c = _case(name)
    assert c["tb"].dtype == np.float32
    assert c["tb"].shape == c["jb"].shape == c["dims"][::-1]
    assert _rel(c["tb"], c["jb"]) <= TOL
    pred = sp.predicted_rel_error("single", max(c["dims"]), True)
    assert _rel(c["tb"], c["oracle"]) <= pred


@pytest.mark.parametrize("scaling", ["none", "full"])
@pytest.mark.parametrize("name", CASES)
def test_r2c_forward_matches_jax_and_oracle(name, scaling):
    c = _case(name)
    got, want = c["tf_" + scaling], c["jf_" + scaling]
    assert got.shape == want.shape == (len(c["trip"]), 2)
    assert _rel(_c(got), _c(want)) <= TOL
    scale = 1.0 / np.prod(c["dims"]) if scaling == "full" else 1.0
    oracle = sample_cube(dense_forward(c["jb"].astype(np.float64)),
                         c["trip"], c["dims"]) * scale
    pred = sp.predicted_rel_error("single", max(c["dims"]), True)
    assert _rel(_c(got), oracle) <= pred


@pytest.mark.parametrize("name", CASES)
def test_r2c_backward_twice_is_identical(name):
    c = _case(name)
    np.testing.assert_array_equal(c["tp"].backward(c["vals"]).numpy(),
                                  c["tb"])


@pytest.mark.parametrize("name", CASES)
def test_r2c_plan_from_jax_index_arrays(name):
    c = _case(name)
    fields = dataclasses.asdict(c["jp"].index_plan)
    plan = convert.plan_from_arrays(fields, device="cpu")
    np.testing.assert_array_equal(plan.backward(c["vals"]).numpy(), c["tb"])
    np.testing.assert_array_equal(
        plan.forward(c["jb"], sp.Scaling.FULL).numpy(), c["tf_full"])


def test_r2c_plan_tables_match_jax():
    """Split window, zero stick and folding mask agree with the JAX
    plan's (split ``(0, 5)`` as tests/test_local_transform.py pins it)."""
    want = {"split0": (0, 5), "split3": (3, 5)}
    for name in CASES:
        c = _case(name)
        jp, tp = c["jp"], c["tp"]
        assert tp.split_x == jp._split_x == want.get(name)
        assert tp.index_plan.zero_stick_id == jp.index_plan.zero_stick_id
        jc, tc = jp.index_plan.value_conj, tp.index_plan.value_conj
        assert (jc is None) == (tc is None)
        if name == "folded":
            assert tc.any()
            np.testing.assert_array_equal(tc, jc)
    assert _case("split3")["tp"].index_plan.zero_stick_id is None


def test_r2c_pair_layout_matches_jax(monkeypatch):
    """Folded values in the planar pair layout (2, N): the ±1 of
    ``value_conj`` applies in that layout too."""
    monkeypatch.setattr(jplan_mod, "PAIR_IO_THRESHOLD", 0)
    monkeypatch.setattr(tplan_mod, "PAIR_IO_THRESHOLD", 0)
    c = _case("folded")
    jp, tp = _plans(c["dims"], c["trip"])
    assert jp.pair_values_io and tp.pair_values_io
    vals = c["vals"]
    pair_in = np.stack([vals.real, vals.imag]).astype(np.float32)
    tb = tp.backward(pair_in).numpy()
    assert _rel(tb, np.asarray(jp.backward(pair_in))) <= TOL
    np.testing.assert_array_equal(tb, c["tb"])
    tf = tp.forward(tb, sp.Scaling.FULL).numpy()
    jf = np.asarray(jp.forward(tb, spfft_tpu.Scaling.FULL))
    assert tf.shape == jf.shape == (2, len(vals))
    assert _rel(tf[0] + 1j * tf[1], jf[0] + 1j * jf[1]) <= TOL


def test_r2c_real_slab_io():
    """Backward returns the real slab; forward takes a real tensor or
    array and refuses a complex one or a wrong shape, as the JAX package
    does."""
    c = _case("herm11x12x13")
    tp = c["tp"]
    space = torch.from_numpy(c["tb"])
    np.testing.assert_array_equal(tp.forward(space).numpy(),
                                  tp.forward(c["tb"]).numpy())
    np.testing.assert_array_equal(tp.forward(space.double()).numpy(),
                                  tp.forward(c["tb"]).numpy())
    for bad in (space.to(torch.complex64), c["tb"].astype(np.complex64),
                c["tb"][..., None].repeat(2, axis=-1)):
        with pytest.raises(sp.InvalidParameterError, match="real"):
            tp.forward(bad)
    with pytest.raises(spfft_tpu.InvalidParameterError):
        c["jp"].forward(c["tb"][..., None].repeat(2, axis=-1))
