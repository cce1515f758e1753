"""The port's batched execution, pointwise round trip, two-kernel route
(``fused=False``), ``Grid`` / ``Transform`` and multi-transform API on
the CPU (every kernel wrapper on its plain version), against the JAX
package on the same inputs made from numpy seeds:

* the batched grids of the fused z kernels against the JAX Pallas
  kernels' batched grids in interpret mode (tables as
  tests/test_fused_kernel.py builds them), the R2C (0,0)-stick
  completion included;
* ``backward_batched``, ``forward_batched`` (NONE and FULL),
  ``apply_pointwise`` (identity, and a potential through ``fn_args``)
  and ``iterate_pointwise(steps=3)`` against ``spfft_tpu``'s
  ``TransformPlan(precision="single")``, for C2C and R2C, split-x,
  folded negative-x input and the pair layout; every band of a batched
  result equal to the port's own single result;
* the two-kernel route against the JAX plan and the port's fused route;
* ``multi_transform_*``, ``Grid`` / ``Transform`` (errors with the same
  classes and ``ErrorCode``) against ``spfft_tpu.multi`` /
  ``spfft_tpu.grid``, and a ``Transform`` over a plan carried across
  with ``convert.plan_from_arrays``.

Tolerance: 2e-6 relative l2 against the JAX package (the two sum f32
products in different orders); equality where the port compares with
itself (a batch runs each band's arithmetic unchanged)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spfft_tpu
from spfft_tpu import multi as jmulti
from spfft_tpu import plan as jplan_mod
from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import fused_kernel as jfk
from spfft_tpu.ops import gather_kernel as jgk

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert, multi, timing
from spfft_tpu_torch import plan as tplan_mod
from spfft_tpu_torch.indexing import inverse_slot_map
from spfft_tpu_torch.ops import dft, fused_kernel

from test_util import (center_triplets, dense_forward, hermitian_triplets,
                       sample_cube)

torch.set_num_threads(2)

TOL = 2e-6
B = 3


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _mats(m):
    return dft.device_mats(m[:2], "cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- the batched grids of the fused z kernels ---------------------------------

def _interpret_decompress(vals_b, vi, s_pad, dim_z, zid=None):
    """The JAX batched decompress grid in interpret mode: (B, s_pad, dz)."""
    num_slots = s_pad * dim_z
    (dec_idx, occupied), _ = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(dec_idx, occupied, len(vi))
    ft = jfk.build_fused_decompress_tables(nt, dim_z, s_pad,
                                           zero_stick_id=zid)
    assert not isinstance(ft, str), ft
    re, im = jgk.planar_from_interleaved(jnp.asarray(vals_b), nt.src_rows)
    wr, wi = jfk.run_decompress_zdft(
        re, im, jfk.decompress_device_tables(ft),
        jfk.commit_mats(jdft.c2c_mats(dim_z, jdft.BACKWARD)), ft,
        interpret=True)
    return np.asarray(wr)[:, :s_pad], np.asarray(wi)[:, :s_pad]


@pytest.mark.parametrize("zero_stick", [None, 3])
@pytest.mark.parametrize("pair", [False, True])
def test_batched_decompress_zdft_matches_jax_interpret(zero_stick, pair):
    """B = 3 bands, one call; with an R2C zero stick (stick 3: z in
    [0, 64] of 128 given) the completion runs in every band."""
    rng = np.random.default_rng(10)
    s_pad, dim_z = 32, 128
    occ = rng.random(s_pad * dim_z) < 0.6
    if zero_stick is not None:
        occ.reshape(s_pad, dim_z)[zero_stick] = \
            np.arange(dim_z) <= dim_z // 2
    vi = np.flatnonzero(occ)
    vals = (rng.standard_normal((B, len(vi), 2))
            / np.sqrt(dim_z)).astype(np.float32)
    wr, wi = _interpret_decompress(vals, vi, s_pad, dim_z, zero_stick)
    slot_src = _t(inverse_slot_map(vi, s_pad * dim_z, len(vi)))
    v = _t(np.swapaxes(vals, 1, 2)) if pair else _t(vals)
    gr, gi = fused_kernel.decompress_zdft(
        v, slot_src, _mats(jdft.c2c_mats(dim_z, jdft.BACKWARD)), dim_z, pair,
        -1 if zero_stick is None else zero_stick)
    assert tuple(gr.shape) == (B, s_pad, dim_z)
    _close(gr, wr)
    _close(gi, wi)
    for b in range(B):  # each band as its own single call
        one = fused_kernel.decompress_zdft(
            v[b].contiguous(), slot_src,
            _mats(jdft.c2c_mats(dim_z, jdft.BACKWARD)), dim_z, pair,
            -1 if zero_stick is None else zero_stick)
        assert torch.equal(one[0], gr[b]) and torch.equal(one[1], gi[b])


@pytest.mark.parametrize("pair", [False, True])
def test_batched_zdft_compress_matches_jax_interpret(pair):
    rng = np.random.default_rng(11)
    s_pad, dim_z = 32, 128
    num_slots = s_pad * dim_z
    vi = np.flatnonzero(rng.random(num_slots) < 0.5)
    _, (cmp_idx, cmp_valid) = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(cmp_idx, cmp_valid, num_slots)
    ct = jfk.build_fused_compress_tables(nt, dim_z, s_pad)
    sr, si = (rng.standard_normal((2, B, s_pad, dim_z))
              / np.sqrt(dim_z)).astype(np.float32)
    mats = jdft.c2c_mats(dim_z, jdft.FORWARD, scale=1.0 / num_slots)
    psr, psi = jfk.pad_sticks_planar(jnp.asarray(sr), jnp.asarray(si),
                                     ct.src_sticks)
    fo_re, fo_im = jfk.run_zdft_compress(
        psr, psi, jfk.compress_device_tables(ct), jfk.commit_mats(mats), ct,
        interpret=True)
    want = np.stack([np.asarray(fo_re).reshape(B, -1)[:, :ct.num_out],
                     np.asarray(fo_im).reshape(B, -1)[:, :ct.num_out]], -1)
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(vi, s_pad, dim_z))
    got = fused_kernel.zdft_compress(_t(sr), _t(si), _mats(mats), csr, pair)
    assert tuple(got.shape) == ((B, 2, len(vi)) if pair else (B, len(vi), 2))
    _close(got.transpose(1, 2) if pair else got, want)


# -- the plan ----------------------------------------------------------------

def _sphere(dims, radius):
    def c(d):
        a = np.arange(d)
        return np.where(a > d // 2, a - d, a)
    X, Y, Z = np.meshgrid(c(dims[0]), c(dims[1]), c(dims[2]), indexing="ij")
    m = X * X + Y * Y + Z * Z <= radius * radius
    return np.stack([X[m], Y[m], Z[m]], axis=1).astype(np.int32)


def _fold_some(trip, dims, rng):
    """Centered triplets with some x > 0 values given as their x < 0
    mirror: the folded input that ``value_conj`` marks."""
    t = center_triplets(trip, dims).astype(np.int64)
    flip = (t[:, 0] > 0) & (2 * t[:, 0] != dims[0]) \
        & (rng.random(len(t)) < 0.5)
    t[flip] = -t[flip]
    return t.astype(np.int32)


def _case_triplets(name):
    rng = np.random.default_rng(41)
    if name == "c2c_odd":
        return "c2c", (12, 13, 11), _sphere((12, 13, 11), 5)
    if name == "c2c_split":
        return "c2c", (24, 20, 16), _sphere((24, 20, 16), 4)
    if name == "r2c_odd":
        dims = (12, 13, 11)
        return "r2c", dims, hermitian_triplets(rng, dims)
    if name == "r2c_folded":
        dims = (12, 10, 9)
        return "r2c", dims, _fold_some(hermitian_triplets(rng, dims), dims,
                                       rng)
    if name == "r2c_split3":  # occupied x [3, 8) of 13: split (3, 5)
        dims = (24, 10, 9)
        return "r2c", dims, np.array([[x, y, z] for x in range(3, 8)
                                      for y in range(dims[1])
                                      for z in range(dims[2])], np.int32)
    raise KeyError(name)


CASES = ("c2c_odd", "c2c_split", "r2c_odd", "r2c_folded", "r2c_split3")


def _band_values(kind, dims, trip, seed):
    """One band's values: random complex for C2C; for R2C a seeded real
    field's spectrum masked by the hermitian closure of the set, so the
    values describe a real slab."""
    rng = np.random.default_rng(seed)
    n = len(trip)
    if kind == "c2c":
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    nx, ny, nz = dims
    st = np.where(trip < 0, trip + np.array(dims), trip)
    mask = np.zeros((nz, ny, nx), bool)
    mask[st[:, 2], st[:, 1], st[:, 0]] = True
    mask[(-st[:, 2]) % nz, (-st[:, 1]) % ny, (-st[:, 0]) % nx] = True
    freq = dense_forward(rng.standard_normal((nz, ny, nx))) * mask
    return sample_cube(freq, trip, dims).astype(np.complex64)


def _jtype(kind):
    return spfft_tpu.TransformType.C2C if kind == "c2c" \
        else spfft_tpu.TransformType.R2C


def _ttype(kind):
    return sp.TransformType.C2C if kind == "c2c" else sp.TransformType.R2C


def _potential(dims, seed=5):
    nx, ny, nz = dims
    return np.random.default_rng(seed).random((nz, ny, nx)) \
        .astype(np.float32)


def _fn_c2c(space, w):
    return space * w[..., None]


def _fn_r2c(space, w):
    return space * w


@functools.lru_cache(maxsize=None)
def _case(name):
    kind, dims, trip = _case_triplets(name)
    jp = spfft_tpu.make_local_plan(_jtype(kind), *dims, trip,
                                   precision="single", use_pallas=False)
    tp = sp.make_local_plan(_ttype(kind), *dims, trip, device="cpu")
    tk = sp.make_local_plan(_ttype(kind), *dims, trip, device="cpu",
                            fused=False)
    vb = np.stack([_band_values(kind, dims, trip, s) for s in range(B)])
    return {"kind": kind, "dims": dims, "trip": trip, "jp": jp, "tp": tp,
            "tk": tk, "vb": vb,
            "jb": np.asarray(jp.backward_batched(vb)),
            "fn": _fn_c2c if kind == "c2c" else _fn_r2c,
            "pot": _potential(dims)}


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("route", ["fused", "two-kernel"])
def test_backward_batched_matches_jax(name, route):
    c = _case(name)
    plan = c["tp"] if route == "fused" else c["tk"]
    got = plan.backward_batched(c["vb"])
    assert tuple(got.shape) == c["jb"].shape
    assert _rel(got.numpy(), c["jb"]) <= TOL
    for b in range(B):
        assert torch.equal(got[b], plan.backward(c["vb"][b]))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("scaling", ["none", "full"])
@pytest.mark.parametrize("route", ["fused", "two-kernel"])
def test_forward_batched_matches_jax(name, scaling, route):
    c = _case(name)
    plan = c["tp"] if route == "fused" else c["tk"]
    want = np.asarray(c["jp"].forward_batched(c["jb"],
                                              spfft_tpu.Scaling(scaling)))
    got = plan.forward_batched(c["jb"], sp.Scaling(scaling))
    assert tuple(got.shape) == want.shape == (B, len(c["trip"]), 2)
    assert _rel(got.numpy(), want) <= TOL
    for b in range(B):
        assert torch.equal(got[b],
                           plan.forward(c["jb"][b], sp.Scaling(scaling)))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("potential", [False, True])
def test_apply_pointwise_matches_jax(name, potential):
    c = _case(name)
    v = c["vb"][0]
    if potential:
        want = c["jp"].apply_pointwise(v, c["fn"], jnp.asarray(c["pot"]),
                                       scaling=spfft_tpu.Scaling.FULL)
        got = c["tp"].apply_pointwise(v, c["fn"], _t(c["pot"]),
                                      scaling=sp.Scaling.FULL)
        seq = c["tp"].forward(c["fn"](c["tp"].backward(v), _t(c["pot"])),
                              sp.Scaling.FULL)
    else:
        want = c["jp"].apply_pointwise(v)
        got = c["tp"].apply_pointwise(v)
        seq = c["tp"].forward(c["tp"].backward(v))
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    assert torch.equal(got, seq)


@pytest.mark.parametrize("name", CASES)
def test_iterate_pointwise_matches_jax(name):
    c = _case(name)
    v = c["vb"][1]
    want = c["jp"].iterate_pointwise(v, c["fn"], jnp.asarray(c["pot"]),
                                     steps=3)
    got = c["tp"].iterate_pointwise(v, c["fn"], _t(c["pot"]), steps=3)
    assert _rel(got.numpy(), np.asarray(want)) <= TOL
    seq = v
    for _ in range(3):
        seq = c["tp"].apply_pointwise(seq, c["fn"], _t(c["pot"]),
                                      scaling=sp.Scaling.FULL)
    assert torch.equal(got, seq)
    assert torch.equal(c["tp"].iterate_pointwise(v, c["fn"], _t(c["pot"]),
                                                 steps=0),
                       c["tp"]._coerce_values(v))


@pytest.mark.parametrize("name", CASES)
def test_two_kernel_route_matches_jax_and_fused(name):
    c = _case(name)
    tk, tp = c["tk"], c["tp"]
    assert tk.fused_active is False and tk.fused_fallback_reasons == {}
    assert tp.fused_active is True and tp.fused_fallback_reasons == {}
    v = c["vb"][2]
    jb = np.asarray(c["jp"].backward(v))
    kb = tk.backward(v)
    assert _rel(kb.numpy(), jb) <= TOL
    assert _rel(kb.numpy(), tp.backward(v).numpy()) <= TOL
    jf = np.asarray(c["jp"].forward(jb, spfft_tpu.Scaling.FULL))
    kf = tk.forward(jb, sp.Scaling.FULL)
    assert _rel(kf.numpy(), jf) <= TOL
    assert _rel(kf.numpy(), tp.forward(jb, sp.Scaling.FULL).numpy()) <= TOL


@pytest.mark.parametrize("name", ["c2c_odd", "r2c_folded"])
def test_pair_layout_batched_matches_jax(name, monkeypatch):
    """Pair-layout plans take ``(B, 2, N)`` batches and return them."""
    monkeypatch.setattr(jplan_mod, "PAIR_IO_THRESHOLD", 0)
    monkeypatch.setattr(tplan_mod, "PAIR_IO_THRESHOLD", 0)
    kind, dims, trip = _case_triplets(name)
    jp = spfft_tpu.make_local_plan(_jtype(kind), *dims, trip,
                                   precision="single", use_pallas=False)
    c = _case(name)
    pair_in = np.stack([c["vb"].real, c["vb"].imag], axis=1) \
        .astype(np.float32)
    for fused in (True, False):
        tp = sp.make_local_plan(_ttype(kind), *dims, trip, device="cpu",
                                fused=fused)
        assert tp.pair_values_io and jp.pair_values_io
        assert tp.batch_row_template("values") == ((2, len(trip)),
                                                   np.float32)
        tb = tp.backward_batched(pair_in)
        assert _rel(tb.numpy(), np.asarray(jp.backward_batched(pair_in))) \
            <= TOL
        tf = tp.forward_batched(tb, sp.Scaling.FULL)
        jf = np.asarray(jp.forward_batched(np.asarray(tb),
                                           spfft_tpu.Scaling.FULL))
        assert tuple(tf.shape) == jf.shape == (B, 2, len(trip))
        assert _rel(tf.numpy(), jf) <= TOL
        for b in range(B):
            assert torch.equal(tb[b], tp.backward(pair_in[b]))
            assert torch.equal(tf[b], tp.forward(tb[b], sp.Scaling.FULL))
        out = tp.apply_pointwise(pair_in[0], scaling=sp.Scaling.FULL)
        want = jp.apply_pointwise(pair_in[0], scaling=spfft_tpu.Scaling.FULL)
        assert tuple(out.shape) == (2, len(trip))
        assert _rel(out.numpy(), np.asarray(want)) <= TOL


def test_batch_inputs_in_every_form():
    """A prestaged host buffer, a tensor, a complex array, and lists of
    numpy rows or tensors all give the same batch."""
    c = _case("c2c_odd")
    tp, vb = c["tp"], c["vb"]
    shape, dtype = tp.batch_row_template("values")
    assert (shape, dtype) == c["jp"].batch_row_template("values")
    assert tp.batch_row_template("space") \
        == c["jp"].batch_row_template("space")
    staged = np.empty((B,) + shape, dtype)
    for b in range(B):
        staged[b] = tp._coerce_values(vb[b]).numpy()
    want = tp.backward_batched(staged)
    for form in (vb, list(vb), [torch.from_numpy(v) for v in vb],
                 torch.view_as_real(torch.from_numpy(vb)),
                 torch.from_numpy(staged)):
        assert torch.equal(tp.backward_batched(form), want)
    spaces = list(want.numpy())
    assert torch.equal(tp.forward_batched(spaces), tp.forward_batched(want))
    with pytest.raises(sp.InvalidParameterError):
        tp.batch_row_template("grid")
    with pytest.raises(sp.InvalidParameterError):
        tp.backward_batched([])
    with pytest.raises(sp.InvalidParameterError):
        tp.backward_batched([vb[0][:-1]])


def test_donate_inputs_is_not_in_this_slice():
    """``donate_inputs=True`` is ported now: the round trips write their
    result into the values tensor given (bit for bit the non-donating
    plan's result); a numpy input is left as it was."""
    kind, dims, trip = _case_triplets("c2c_odd")
    keep = sp.make_local_plan(_ttype(kind), *dims, trip, device="cpu")
    give = sp.make_local_plan(_ttype(kind), *dims, trip, device="cpu",
                              donate_inputs=True)
    vals = np.random.default_rng(2).standard_normal(
        (keep.index_plan.num_values, 2)).astype(np.float32)
    want = keep.apply_pointwise(vals)
    t = torch.from_numpy(vals.copy())
    got = give.apply_pointwise(t)
    assert got.data_ptr() == t.data_ptr() and torch.equal(got, want)
    host = vals.copy()
    assert torch.equal(give.iterate_pointwise(host, None, steps=2),
                       keep.iterate_pointwise(vals, None, steps=2))
    np.testing.assert_array_equal(host, vals)


# -- Grid, Transform, multi-transform -----------------------------------------

def _grids(max_sticks=1000, dims=(12, 13, 11)):
    jg = spfft_tpu.Grid(*dims, max_sticks, precision="single")
    tg = sp.Grid(*dims, max_sticks, device="cpu")
    return jg, tg


def _both_raise(jcall, tcall):
    with pytest.raises(spfft_tpu.GenericError) as je:
        jcall()
    with pytest.raises(sp.GenericError) as te:
        tcall()
    assert type(te.value).__name__ == type(je.value).__name__
    assert int(te.value.error_code()) == int(je.value.error_code())


def test_grid_errors_match_jax():
    kind, dims, trip = _case_triplets("c2c_odd")
    jg, tg = _grids()
    du = spfft_tpu.ProcessingUnit.DEVICE
    tu = sp.ProcessingUnit.DEVICE
    for kw in ({"indices": trip, "dim_x": 13},
               {"indices": trip.reshape(-1)[:-1]},
               {"indices": trip, "num_local_elements": len(trip) + 1},
               {"indices": trip, "local_z_length": 5},
               {"indices": None}):
        args = dict({"dim_x": dims[0], "dim_y": dims[1], "dim_z": dims[2]},
                    **kw)
        _both_raise(
            lambda: jg.create_transform(du, spfft_tpu.TransformType.C2C,
                                        **args),
            lambda: tg.create_transform(tu, sp.TransformType.C2C, **args))
    jsmall, tsmall = _grids(max_sticks=3)
    _both_raise(
        lambda: jsmall.create_transform(du, spfft_tpu.TransformType.C2C,
                                        *dims, indices=trip),
        lambda: tsmall.create_transform(tu, sp.TransformType.C2C, *dims,
                                        indices=trip))
    _both_raise(lambda: spfft_tpu.Grid(0, 4, 4, 10),
                lambda: sp.Grid(0, 4, 4, 10, device="cpu"))
    _both_raise(lambda: spfft_tpu.Grid(4, 4, 4, -1),
                lambda: sp.Grid(4, 4, 4, -1, device="cpu"))
    jt = jg.create_transform(du, spfft_tpu.TransformType.C2C, *dims,
                             indices=trip)
    tt = tg.create_transform(tu, sp.TransformType.C2C, *dims, indices=trip)
    _both_raise(jt.forward, tt.forward)
    with pytest.raises(sp.InvalidParameterError, match="distributed"):
        sp.Grid(*dims, 10, mesh=object(), device="cpu")
    with pytest.raises(sp.InvalidParameterError, match="distributed"):
        tg.create_transform(tu, sp.TransformType.C2C, *dims,
                            triplets_per_shard=[trip], planes_per_shard=[11])


def test_transform_matches_jax():
    kind, dims, trip = _case_triplets("c2c_odd")
    jg, tg = _grids()
    flat = trip.reshape(-1)  # the reference C API's interleaved form
    jt = jg.create_transform(spfft_tpu.ProcessingUnit.DEVICE,
                             spfft_tpu.TransformType.C2C, *dims, indices=flat)
    tt = tg.create_transform(sp.ProcessingUnit.DEVICE, sp.TransformType.C2C,
                             *dims, indices=flat,
                             num_local_elements=len(trip))
    for attr in ("type", "dim_x", "dim_y", "dim_z", "global_size",
                 "num_global_elements", "distributed", "num_shards",
                 "precision"):
        a, b = getattr(tt, attr), getattr(jt, attr)
        assert getattr(a, "value", a) == getattr(b, "value", b), attr
    for method in ("local_z_length", "local_z_offset", "local_slice_size",
                   "num_local_elements"):
        assert getattr(tt, method)() == getattr(jt, method)()
    assert tt.device_id == -1 and tt.exchange_type is sp.ExchangeType.DEFAULT
    v = _case("c2c_odd")["vb"][0]
    assert tt.space_domain_data() is None
    got = tt.backward(v)
    assert _rel(got.numpy(), np.asarray(jt.backward(v))) <= TOL
    snap = tt.space_domain_data(sp.ProcessingUnit.HOST)
    assert isinstance(snap, np.ndarray) and not snap.flags.writeable
    np.testing.assert_array_equal(snap, got.numpy())
    assert tt.space_domain_data(sp.ProcessingUnit.DEVICE) is got
    out = tt.forward(scaling=sp.Scaling.FULL)
    want = jt.forward(scaling=spfft_tpu.Scaling.FULL)
    assert _rel(out.numpy(), np.asarray(want)) <= TOL
    clone = tt.clone()
    assert clone.plan is tt.plan and clone.space_domain_data() is None
    copy = tg.copy()
    assert (copy.max_dim_x, copy.max_num_local_z_columns, copy.device) \
        == (tg.max_dim_x, tg.max_num_local_z_columns, tg.device)


@pytest.mark.parametrize("shared", [True, False])
def test_multi_transform_matches_jax(shared):
    """Clones of one plan run as one batched execution; transforms over
    different plans run one at a time."""
    kind, dims, trip = _case_triplets("c2c_odd")
    jg, tg = _grids()
    du, tu = spfft_tpu.ProcessingUnit.DEVICE, sp.ProcessingUnit.DEVICE
    jt = [jg.create_transform(du, spfft_tpu.TransformType.C2C, *dims,
                              indices=trip)]
    tt = [tg.create_transform(tu, sp.TransformType.C2C, *dims,
                              indices=trip)]
    for _ in range(B - 1):
        if shared:
            jt.append(jt[0].clone())
            tt.append(tt[0].clone())
        else:
            jt.append(jg.create_transform(du, spfft_tpu.TransformType.C2C,
                                          *dims, indices=trip))
            tt.append(tg.create_transform(tu, sp.TransformType.C2C, *dims,
                                          indices=trip))
    assert (multi._shared_plan(tt) is not None) == shared
    vb = _case("c2c_odd")["vb"]
    got = sp.multi_transform_backward(tt, list(vb))
    want = jmulti.multi_transform_backward(jt, list(vb))
    for g, w, t, v in zip(got, want, tt, vb):
        assert _rel(g.numpy(), np.asarray(w)) <= TOL
        assert t.space_domain_data() is g
        assert torch.equal(g, t.plan.backward(v))
    scal = [sp.Scaling.FULL] * B
    out = sp.multi_transform_forward(tt, scalings=scal)
    jout = jmulti.multi_transform_forward(jt, scalings=[
        spfft_tpu.Scaling.FULL] * B)
    for o, w in zip(out, jout):
        assert _rel(o.numpy(), np.asarray(w)) <= TOL
    with pytest.raises(sp.InvalidParameterError):
        sp.multi_transform_backward(tt, list(vb)[:-1])


def test_batching_policy_matches_jax_where_it_does_not_rest_on_a_device():
    for b, cap in ((1, 8), (2, 8), (3, 8), (5, 8), (9, 8), (17, 64)):
        assert multi.planned_batch_size(b, cap) \
            == jmulti.planned_batch_size(b, cap)
    plan = _case("c2c_odd")["tp"]
    assert not multi.fusion_eligible(plan, 1)
    assert multi.fusion_eligible(plan, 2)
    limit = multi.FUSED_BATCH_MAX_GRID // plan.global_size
    assert multi.fusion_eligible(plan, limit)
    assert not multi.fusion_eligible(plan, limit + 1)
    assert not multi.fusion_eligible(object(), 4)


@pytest.mark.parametrize("fused", [True, False])
def test_transform_from_jax_plan_arrays(fused):
    c = _case("r2c_folded")
    fields = dataclasses.asdict(c["jp"].index_plan)
    t = sp.Transform(convert.plan_from_arrays(fields, device="cpu",
                                              fused=fused))
    assert t.plan.fused_active is fused
    v = c["vb"][0]
    np.testing.assert_array_equal(t.backward(v).numpy(),
                                  c["tp"].backward(v).numpy())
    np.testing.assert_array_equal(
        t.forward(scaling=sp.Scaling.FULL).numpy(),
        c["tp"].forward(c["tp"].backward(v), sp.Scaling.FULL).numpy())


def test_timing_records_scopes_only_when_enabled():
    c = _case("c2c_odd")
    timing.GlobalTimer.reset()
    c["tp"].backward(c["vb"][0])
    assert "backward" not in timing.GlobalTimer.process().json()
    timing.enable()
    try:
        c["tp"].backward_batched(c["vb"])
        c["tp"].apply_pointwise(c["vb"][0])
        with timing.suppressed():
            c["tp"].forward(c["jb"][0])
    finally:
        timing.disable()
    text = timing.GlobalTimer.process().json()
    assert "backward_batched" in text and "apply_pointwise" in text
    assert '"forward"' not in text
    timing.GlobalTimer.reset()
