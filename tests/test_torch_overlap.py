"""The port's chunked exchange (``overlap_chunks``) and its R2C and double
plans on the CPU, against the JAX package's on the same numpy-seeded
inputs; JAX on the 8 virtual CPU devices of tests/conftest.py.

* ``chunk_bounds`` / ``chunk_bounds_aligned`` equal the JAX functions on
  random counts, extents, K and alignments, and refuse what they refuse;
* ``build_overlap_schedule`` of every kind (block, ragged, compact), K in
  {1, 2, 3, 4}, with and without the split-x window, for uniform, skewed
  and empty shards: every chunk's bounds, counts, ops and tables and the
  late unpack tables exactly, with the accounting;
* R2C plans (the trimmed stick half, the plane completion after the
  exchange) under every lossless kind and K in {1, 2, 4}: backward and
  forward NONE / FULL within 2e-6 of the JAX plan, bit for bit the port's
  own ``BUFFERED`` plan, and the batched bands bit for bit the single
  calls;
* double plans of every lossless kind at K = 1 and 2 within twice
  ``predicted_rel_error("double", n)`` of the JAX plan;
* the knob: the environment default, the clamp to max_sticks /
  max_planes, one shard, K < 1 refused.
"""

import functools

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.parallel import overlap as jov

import spfft_tpu_torch as sp
from spfft_tpu_torch.parallel import dist as tdist
from spfft_tpu_torch.parallel import overlap

from test_distributed import split_by_sticks, split_planes
from test_torch_exchange import KINDS, SKEWS, WINDOW, _c, _parts, _rel, _same
from test_util import hermitian_triplets

torch.set_num_threads(2)

TOL = 2e-6
DIMS = (11, 12, 13)


# -- the chunk bounds ---------------------------------------------------------

def test_chunk_bounds_match_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        s = int(rng.integers(1, 7))
        padded = int(rng.integers(1, 40))
        counts = [int(c) for c in rng.integers(0, padded + 1, s)]
        k = int(rng.integers(1, padded + 1))
        w = float(rng.choice([0.0, 0.5, 1.0, 2.0]))
        assert overlap.chunk_bounds(counts, padded, k, w) == \
            jov.chunk_bounds(counts, padded, k, w)
        a = int(rng.integers(1, 9))
        assert overlap.chunk_bounds_aligned(counts, padded, k, a, w) == \
            jov.chunk_bounds_aligned(counts, padded, k, a, w)
    for bad in ((0, 5), (6, 5)):
        with pytest.raises(sp.InvalidParameterError):
            overlap.chunk_bounds([1, 2], bad[1], bad[0])
        with pytest.raises(spfft_tpu.InvalidParameterError):
            jov.chunk_bounds([1, 2], bad[1], bad[0])


# -- the schedules ------------------------------------------------------------

def _index_plans(skew, window, kind="C2C"):
    _, parts, planes = _parts(skew, window=window)
    return (jpar.build_distributed_plan(spfft_tpu.TransformType[kind],
                                        *DIMS, parts, planes),
            sp.parallel.build_distributed_plan(sp.TransformType[kind],
                                               *DIMS, parts, planes))


_CHUNK_FIELDS = {
    "block": ("stick_lo", "stick_hi", "plane_lo", "plane_hi", "n_bwd",
              "n_fwd"),
    "ragged": ("stick_lo", "stick_hi", "plane_lo", "plane_hi", "send_cap",
               "recv_cap", "bwd_offsets", "fwd_offsets", "bwd_pack",
               "fwd_pack", "emu_bwd", "emu_fwd", "n_bwd", "n_fwd"),
    "compact": ("stick_lo", "stick_hi", "plane_lo", "plane_hi", "bwd_ops",
                "fwd_ops", "bwd_pack", "fwd_pack", "n_bwd", "n_fwd",
                "bwd_total", "fwd_total"),
}


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("kind", ["block", "ragged", "compact"])
@pytest.mark.parametrize("skew", sorted(SKEWS))
def test_overlap_schedule_matches_jax_exactly(skew, kind, window):
    jd, td = _index_plans(skew, window)
    xw = None if kind == "block" else window
    for k in (1, 2, 3, 4):
        want = jov.build_overlap_schedule(jd, k, kind, x_window=xw)
        got = overlap.build_overlap_schedule(td, k, kind, x_window=xw)
        assert got.kind == want.kind and got.num_chunks == want.num_chunks
        for c, (g, w) in enumerate(zip(got.chunks, want.chunks)):
            for f in _CHUNK_FIELDS[kind]:
                _same(getattr(g, f), getattr(w, f), f"chunk {c} {f}")
        for f in ("bwd_unpack", "fwd_unpack"):
            _same(getattr(got, f), getattr(want, f), f)
        assert got.stick_bounds() == want.stick_bounds()
        assert got.plane_bounds() == want.plane_bounds()
        assert got.chunk_table_slices() == want.chunk_table_slices()
        for a, b in zip(got.device_tables(), want.device_tables()):
            _same(a, b, "device_tables")
        assert got.wire_elements() == want.wire_elements()
        assert got.busiest_link_elements() == want.busiest_link_elements()
        for fwd in (False, True):
            assert got.scale_rows(fwd) == want.scale_rows(fwd)
        if kind != "block":
            for c in range(got.num_chunks):
                for fn in ("bwd_pair_elements", "fwd_pair_elements"):
                    g, w = getattr(got, fn)(c), getattr(want, fn)(c)
                    assert g.keys() == w.keys()
                    for key in g:
                        _same(g[key], w[key], f"{fn} {c} {key}")
    with pytest.raises(sp.InvalidParameterError):
        overlap.build_overlap_schedule(td, 2, "ring")


# -- R2C and double plans -----------------------------------------------------

def _r2c_parts():
    rng = np.random.default_rng(5)
    trip = hermitian_triplets(rng, DIMS)
    parts = split_by_sticks(trip, DIMS, [1, 3, 2, 2])
    return parts, split_planes(DIMS[2], [2, 1, 3, 1])


def _r2c_values(parts):
    """A seeded real field's spectrum at each shard's triplets."""
    spec = np.fft.fftn(np.random.default_rng(56).standard_normal(DIMS[::-1]))
    out = []
    for p in parts:
        st = np.where(p < 0, p + np.array(DIMS), p)
        out.append(spec[st[:, 2], st[:, 1], st[:, 0]].astype(np.complex64))
    return out


def _set_ppermute(monkeypatch, kind):
    if KINDS[kind][1]:
        monkeypatch.setenv(tdist.COMPACT_PPERMUTE_ENV, "1")
    else:
        monkeypatch.delenv(tdist.COMPACT_PPERMUTE_ENV, raising=False)


@functools.lru_cache(maxsize=None)
def _r2c_buffered():
    parts, planes = _r2c_parts()
    tp = sp.make_distributed_plan(sp.TransformType.R2C, *DIMS, parts,
                                  planes, device="cpu")
    vals = _r2c_values(parts)
    tb = tp.backward(vals)
    return tb, tp.forward(tb, sp.Scaling.FULL)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_r2c_plans_match_jax_and_the_buffered_plan(monkeypatch, kind, k):
    _set_ppermute(monkeypatch, kind)
    name = KINDS[kind][0]
    parts, planes = _r2c_parts()
    jp = jpar.make_distributed_plan(
        spfft_tpu.TransformType.R2C, *DIMS, parts, planes,
        mesh=jpar.make_mesh(4), precision="single",
        exchange=spfft_tpu.ExchangeType[name], overlap_chunks=k)
    tp = sp.make_distributed_plan(sp.TransformType.R2C, *DIMS, parts,
                                  planes, device="cpu",
                                  exchange=sp.ExchangeType[name],
                                  overlap_chunks=k)
    assert tp.overlap_chunks == jp.overlap_chunks
    assert (tp._ragged is None) == (jp._ragged is None)
    assert (tp._compact is None) == (jp._compact is None)
    assert (tp._overlap is None) == (jp._overlap is None)
    vals = _r2c_values(parts)
    tb = tp.backward(vals)
    jb = np.asarray(jp.backward(vals))
    assert _rel(tb.numpy(), jb) <= TOL
    for sc in ("none", "full"):
        got = tp.forward(torch.from_numpy(jb.copy()), sp.Scaling(sc))
        want = jp.forward(jax.device_put(jb, jp._sharded),
                          spfft_tpu.Scaling(sc))
        assert _rel(_c(got.numpy()), _c(np.asarray(want))) <= TOL, sc
    b0, f0 = _r2c_buffered()
    assert torch.equal(tb, b0)
    assert torch.equal(tp.forward(tb, sp.Scaling.FULL), f0)
    if k == 2:
        bands = [[v * np.complex64(a) for v in vals] for a in (1.0, 3.0)]
        spaces = tp.backward_batched(bands)
        outs = tp.forward_batched(spaces, sp.Scaling.FULL)
        for b in range(2):
            one = tp.backward(bands[b])
            assert torch.equal(spaces[:, b], one)
            assert torch.equal(outs[:, b], tp.forward(one, sp.Scaling.FULL))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_double_plans_match_jax(monkeypatch, kind, k):
    """Double C2C plans: within twice ``predicted_rel_error("double",
    n)`` of the JAX package's float64 plans (x64, conftest)."""
    _set_ppermute(monkeypatch, kind)
    name = KINDS[kind][0]
    trip, parts, planes = _parts("plane_skew")
    rng = np.random.default_rng(9)
    vals = [(rng.standard_normal(len(p)) + 1j * rng.standard_normal(len(p)))
            for p in parts]
    jp = jpar.make_distributed_plan(
        spfft_tpu.TransformType.C2C, *DIMS, parts, planes,
        mesh=jpar.make_mesh(4), precision="double",
        exchange=spfft_tpu.ExchangeType[name], overlap_chunks=k)
    tp = sp.make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                  planes, device="cpu", precision="double",
                                  exchange=sp.ExchangeType[name],
                                  overlap_chunks=k)
    tol = 2 * sp.predicted_rel_error("double", max(DIMS), True)
    tb = tp.backward(vals)
    jb = np.asarray(jp.backward(vals))
    assert tb.dtype == torch.float64
    assert _rel(_c(tb.numpy()), _c(jb)) <= tol
    got = tp.forward(torch.from_numpy(jb.copy()), sp.Scaling.FULL)
    want = jp.forward(jax.device_put(jb, jp._sharded), spfft_tpu.Scaling.FULL)
    assert _rel(_c(got.numpy()), _c(np.asarray(want))) <= tol
    ref = sp.make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                   planes, device="cpu", precision="double")
    assert torch.equal(tb, ref.backward(vals))


# -- the knob -----------------------------------------------------------------

def test_overlap_knob_env_clamp_and_refusals(monkeypatch):
    """The environment default, the clamp to min(max_sticks, max_planes)
    (and to 1 on one shard), as the JAX plan resolves them; K < 1
    refused by both."""
    _, parts, planes = _parts("uniform")

    def both(**kw):
        jp = jpar.make_distributed_plan(
            spfft_tpu.TransformType.C2C, *DIMS, parts, planes,
            mesh=jpar.make_mesh(4), precision="single", **kw)
        tp = sp.make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                      planes, device="cpu", **kw)
        assert tp.overlap_chunks == jp.overlap_chunks
        return tp

    # the default is the process-global config's knob, the JAX package's
    from spfft_tpu_torch.control import KNOB_SPECS, global_config
    assert global_config().overlap_chunks == KNOB_SPECS[
        "overlap_chunks"].default == 1
    assert both().overlap_chunks == 1
    monkeypatch.setenv(tdist.OVERLAP_CHUNKS_ENV, "3")
    assert both().overlap_chunks == 3
    assert both(overlap_chunks=2).overlap_chunks == 2
    monkeypatch.delenv(tdist.OVERLAP_CHUNKS_ENV)
    clamped = both(overlap_chunks=99)
    dp = clamped.dist_plan
    assert clamped.overlap_chunks == min(dp.max_sticks, dp.max_planes) == 4
    one = sp.make_distributed_plan(sp.TransformType.C2C, *DIMS,
                                   [np.concatenate(parts)], [DIMS[2]],
                                   device="cpu", overlap_chunks=4)
    assert one.overlap_chunks == 1 and one._overlap is None
    for bad in (0, -2):
        with pytest.raises(sp.InvalidParameterError, match="overlap_chunks"):
            sp.make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                     planes, device="cpu",
                                     overlap_chunks=bad)
