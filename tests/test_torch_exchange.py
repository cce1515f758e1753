"""The port's exchanges of the distributed plan on the CPU (every kernel
wrapper on its plain version, or the gather kernel's launch path through
its emulated C entry), against the JAX package's on the same numpy-seeded
inputs; JAX on the 8 virtual CPU devices of tests/conftest.py.

* the exact-count schedules' tables exactly: ``build_compact_schedule``
  (ops, pack and unpack tables) and ``build_ragged_schedule`` (offsets,
  capacities, pack, unpack and emulation tables), with and without the
  split-x window, for uniform, skewed and empty shards; the bucket ladder
  and the size classes;
* the moves: the ring equals the transposing copy and the JAX ring on a
  4-device mesh; the ragged and op schedules run through the gather
  kernel's launch path (3 launches a direction for ragged, one per op and
  the unpack for the op schedule);
* ``exchange_wire_bytes`` / ``exchange_busiest_link_bytes`` of every kind,
  rung and K exactly;
* C2C plans under every lossless kind (``BUFFERED``, ``UNBUFFERED``,
  ``COMPACT_BUFFERED`` ragged and with ``SPFFT_TPU_COMPACT_PPERMUTE=1``)
  and K in {1, 2, 4}: backward, forward NONE and FULL, batched,
  pointwise and coalesced calls within 2e-6 relative l2 of the JAX plan,
  and bit for bit the port's own ``BUFFERED`` plan (these exchanges only
  move values). R2C, double and the chunked schedules are
  tests/test_torch_overlap.py's; the wire ladder tests/test_torch_wire.py's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.parallel import exchange as jex
from spfft_tpu.parallel.mesh import shard_map as j_shard_map

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import gather_kernel
from spfft_tpu_torch.parallel import dist as tdist
from spfft_tpu_torch.parallel import exchange

from test_distributed import split_by_sticks, split_planes
from test_torch_gather import emulated_gather  # noqa: F401 (a fixture)
from test_util import (dense_cube_from_values, random_sparse_triplets,
                       random_values, sample_cube)

torch.set_num_threads(2)

TOL = 2e-6
DIMS = (11, 12, 13)
#: (sticks weights, planes weights) over 4 shards
SKEWS = {
    "uniform": ([1, 1, 1, 1], [1, 1, 1, 1]),
    "stick_skew": ([5, 1, 2, 1], [1, 1, 1, 1]),
    "plane_skew": ([1, 1, 1, 1], [1, 4, 1, 2]),
    "empty_shards": ([1, 0, 2, 0], [0, 2, 0, 1]),
}
#: lossless kinds: (exchange name, compact through the op schedule)
KINDS = {"buffered": ("BUFFERED", False),
         "ring": ("UNBUFFERED", False),
         "ragged": ("COMPACT_BUFFERED", False),
         "compact": ("COMPACT_BUFFERED", True)}


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _c(a):
    a = np.asarray(a, np.float64)
    return a[..., 0] + 1j * a[..., 1]


#: the x window of the windowed stick sets: x in [3, 8) of 11
WINDOW = (3, 5)


def _parts(skew, dims=DIMS, seed=31, window=None):
    """A random stick set (every x, or only the window's when
    ``window``) split over 4 shards by ``skew``."""
    rng = np.random.default_rng(seed)
    trip = random_sparse_triplets(rng, dims)
    if window is not None:
        x0, w = window
        trip = trip[(trip[:, 0] >= x0) & (trip[:, 0] < x0 + w)]
    return (trip, split_by_sticks(trip, dims, SKEWS[skew][0]),
            split_planes(dims[2], SKEWS[skew][1]))


def _index_plans(skew, window=None):
    _, parts, planes = _parts(skew, window=window)
    return (jpar.build_distributed_plan(spfft_tpu.TransformType.C2C, *DIMS,
                                        parts, planes),
            sp.parallel.build_distributed_plan(sp.TransformType.C2C, *DIMS,
                                               parts, planes))


def _same(a, b, what):
    """Equal values and, for arrays, equal dtype and shape."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    else:
        assert a == b, what


# -- the schedules ------------------------------------------------------------

@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("skew", sorted(SKEWS))
def test_compact_schedule_matches_jax_exactly(skew, window):
    jd, td = _index_plans(skew, window)
    want = jex.build_compact_schedule(jd, x_window=window)
    got = exchange.build_compact_schedule(td, x_window=window)
    for f in ("num_shards", "ops", "bwd_pack", "bwd_unpack", "fwd_pack",
              "fwd_unpack"):
        _same(getattr(got, f), getattr(want, f), f)
    assert got.hop_sizes == want.hop_sizes
    assert got.total_recv == want.total_recv
    assert got.wire_elements() == want.wire_elements()
    assert got.busiest_link_elements() == want.busiest_link_elements()


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("skew", sorted(SKEWS))
def test_ragged_schedule_matches_jax_exactly(skew, window):
    jd, td = _index_plans(skew, window)
    want = jex.build_ragged_schedule(jd, x_window=window)
    got = exchange.build_ragged_schedule(td, x_window=window)
    for f in ("num_shards", "send_cap", "recv_cap", "bwd_offsets",
              "fwd_offsets", "bwd_pack", "bwd_unpack", "fwd_pack",
              "fwd_unpack", "emu_bwd", "emu_fwd"):
        _same(getattr(got, f), getattr(want, f), f)
    assert got.wire_elements() == want.wire_elements()
    assert got.busiest_link_elements() == want.busiest_link_elements()
    for a, b in zip(got.device_tables(), want.device_tables()):
        _same(a, b, "device_tables")


def test_bucketing_matches_jax():
    """The bucket ladder and the size classes, exact and bucketed (more
    than MAX_EXACT_CLASSES sizes in a hop)."""
    assert exchange.BUCKET_FACTOR == jex.BUCKET_FACTOR
    assert exchange.MAX_EXACT_CLASSES == jex.MAX_EXACT_CLASSES
    for m in (1, 2, 7, 100, 12345):
        assert exchange._bucket_ladder(m) == jex._bucket_ladder(m)
    rng = np.random.default_rng(3)
    for n in (3, 8, 9, 20):
        sizes = {j: int(e) for j, e in enumerate(rng.integers(1, 500, n))}
        assert exchange._size_classes(sizes) == jex._size_classes(sizes)


# -- the moves ----------------------------------------------------------------

@pytest.mark.parametrize("tail", [1, 2])
def test_ring_equals_the_transpose_and_the_jax_ring(tail):
    """The ring's S - 1 hops and its reversal and roll give the
    transposing copy's blocks, and the JAX ring's over a 4-device mesh."""
    s = 4
    shape = (2, s, s, 3, 5)[:3 + tail]
    t = torch.as_tensor(np.random.default_rng(1).standard_normal(shape),
                        dtype=torch.float32)
    got = exchange.ring_exchange_blocks(t, tail)
    assert torch.equal(got, exchange.all_to_all_blocks(t, tail))
    assert got.is_contiguous()
    if tail == 2:
        ring = jax.jit(j_shard_map(
            lambda b: jex.ring_exchange_blocks(b[0], "shards")[None],
            mesh=jpar.make_mesh(s), in_specs=P("shards"),
            out_specs=P("shards")))
        for b in range(shape[0]):
            np.testing.assert_array_equal(
                got[b].numpy(), np.asarray(ring(jnp.asarray(t[b].numpy()))))


def _plan_pair(kind, skew="stick_skew", k=1, monkeypatch=None, **kw):
    name, ppermute = KINDS[kind]
    if monkeypatch is not None:
        if ppermute:
            monkeypatch.setenv(tdist.COMPACT_PPERMUTE_ENV, "1")
        else:
            monkeypatch.delenv(tdist.COMPACT_PPERMUTE_ENV, raising=False)
    _, parts, planes = _parts(skew)
    tp = sp.make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                  planes, device="cpu",
                                  exchange=sp.ExchangeType[name],
                                  overlap_chunks=k, **kw)
    return tp, parts


@pytest.mark.parametrize("kind", ["ragged", "compact"])
def test_exact_count_exchange_launches_the_gather(emulated_gather,
                                                  monkeypatch, kind):
    """The exact-count exchanges through the gather kernel's launch path
    (the emulated C entry): the same results as the plain versions, bit
    for bit, and the launches a pair makes on the fused route — ragged 3
    a direction (pack, emulation, unpack), the op schedule one a pack of
    each op and the unpack."""
    tp, parts = _plan_pair(kind, monkeypatch=monkeypatch)
    vals = _values(parts)
    space = tp.backward(vals)
    out = tp.forward(space, sp.Scaling.FULL)
    launches = gather_kernel.gather.launches
    per = 3 if kind == "ragged" else len(tp._compact.ops) + 1
    assert launches == 2 * per
    monkeypatch.setattr(tdist, "gather_planes", _plain_gather_planes)
    monkeypatch.setattr(exchange, "gather_planes", _plain_gather_planes)
    assert torch.equal(tp.backward(vals), space)
    assert torch.equal(tp.forward(space, sp.Scaling.FULL), out)
    assert gather_kernel.gather.launches == launches


def _plain_gather_planes(src, idx):
    b, s = src[0].shape[:2]
    out = tuple(torch.empty((b, s, idx.shape[1]), dtype=src[0].dtype)
                for _ in range(2))
    gather_kernel.gather_plain(tuple(t.transpose(0, 1) for t in src), idx,
                               tuple(t.transpose(0, 1) for t in out))
    return out


# -- wire bytes ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_wire_bytes_match_jax_per_kind_rung_and_k(monkeypatch, kind, k):
    name, ppermute = KINDS[kind]
    if ppermute:
        monkeypatch.setenv(tdist.COMPACT_PPERMUTE_ENV, "1")
    _, parts, planes = _parts("plane_skew")
    for rung in range(4):
        kw = dict(overlap_chunks=k, wire_precision=rung,
                  wire_error_budget=1.0)
        jp = jpar.make_distributed_plan(
            spfft_tpu.TransformType.C2C, *DIMS, parts, planes,
            mesh=jpar.make_mesh(4), precision="single",
            exchange=spfft_tpu.ExchangeType[name], **kw)
        tp = sp.make_distributed_plan(
            sp.TransformType.C2C, *DIMS, parts, planes, device="cpu",
            exchange=sp.ExchangeType[name], **kw)
        assert tp.wire_rung_name == jp.wire_rung_name
        assert tp.overlap_chunks == jp.overlap_chunks
        for fwd in (False, True):
            assert tp.exchange_wire_bytes(fwd) == jp.exchange_wire_bytes(fwd)
            assert tp.exchange_busiest_link_bytes(fwd) == \
                jp.exchange_busiest_link_bytes(fwd)
        assert tp._wire_elem_bytes() == jp._wire_elem_bytes()


# -- plans under every lossless kind ------------------------------------------

def _values(parts, seed=7):
    rng = np.random.default_rng(seed)
    cube = dense_cube_from_values(np.concatenate(parts),
                                  random_values(rng, sum(map(len, parts))),
                                  DIMS)
    return [sample_cube(cube, p, DIMS).astype(np.complex64) for p in parts]


@functools.lru_cache(maxsize=None)
def _jax_results(kind, k):
    name, ppermute = KINDS[kind]
    _, parts, planes = _parts("stick_skew")
    import os
    old = os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
    if ppermute:
        os.environ[tdist.COMPACT_PPERMUTE_ENV] = "1"
    try:
        jp = jpar.make_distributed_plan(
            spfft_tpu.TransformType.C2C, *DIMS, parts, planes,
            mesh=jpar.make_mesh(4), precision="single",
            exchange=spfft_tpu.ExchangeType[name], overlap_chunks=k)
    finally:
        os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
        if old is not None:
            os.environ[tdist.COMPACT_PPERMUTE_ENV] = old
    vals = _values(parts)
    jb = np.asarray(jp.backward(vals))
    out = {"jb": jb}
    for sc in ("none", "full"):
        out[sc] = np.asarray(jp.forward(jax.device_put(jb, jp._sharded),
                                        spfft_tpu.Scaling(sc)))
    return out


@functools.lru_cache(maxsize=None)
def _buffered_port():
    tp, parts = _plan_pair("buffered")
    vals = _values(parts)
    jb = _jax_results("buffered", 1)["jb"]
    return (tp.backward(vals), tp.forward(torch.from_numpy(jb),
                                          sp.Scaling.FULL))


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_c2c_plans_match_jax_and_the_buffered_plan(monkeypatch, kind, k):
    """Backward, forward NONE and FULL within 2e-6 of the JAX plan of the
    same kind and K, and bit for bit the port's own BUFFERED plan; the
    plan reports the kind the JAX plan selected."""
    want = _jax_results(kind, k)
    tp, parts = _plan_pair(kind, k=k, monkeypatch=monkeypatch)
    assert tp.overlap_chunks == k
    assert tp.exchange_kind == {"buffered": "block", "ring": "ring",
                                "ragged": "ragged", "compact": "compact"
                                }[kind] + ("" if k == 1 else f"x{k}")
    vals = _values(parts)
    tb = tp.backward(vals)
    assert _rel(_c(tb.numpy()), _c(want["jb"])) <= TOL
    jb = torch.from_numpy(want["jb"])
    for sc in ("none", "full"):
        got = tp.forward(jb, sp.Scaling(sc)).numpy()
        assert _rel(_c(got), _c(want[sc])) <= TOL, sc
    b0, f0 = _buffered_port()
    assert torch.equal(tb, b0)
    assert torch.equal(tp.forward(jb, sp.Scaling.FULL), f0)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_batched_pointwise_and_coalesced_calls(monkeypatch, kind, k):
    """B = 3 bands (the values times 1, -0.5 and 2), the coalesced calls
    and ``apply_pointwise`` under each kind: every band and call within
    2e-6 of the JAX plan's single calls, and bit for bit the port's own
    single calls."""
    want = _jax_results(kind, k)
    tp, parts = _plan_pair(kind, k=k, monkeypatch=monkeypatch)
    vals = _values(parts)
    scales = (1.0, -0.5, 2.0)
    bands = [[v * np.complex64(a) for v in vals] for a in scales]
    spaces = tp.backward_batched(bands)
    outs = tp.forward_batched(spaces, sp.Scaling.FULL)
    for b, a in enumerate(scales):
        one = tp.backward(bands[b])
        assert torch.equal(spaces[:, b], one)
        assert torch.equal(outs[:, b], tp.forward(one, sp.Scaling.FULL))
        assert _rel(_c(spaces[:, b].numpy()), a * _c(want["jb"])) <= TOL
    co = tp.coalesce_backward(bands[:2])
    assert all(torch.equal(c, spaces[:, b]) for b, c in enumerate(co))
    cf = tp.coalesce_forward(co, sp.Scaling.NONE)
    assert _rel(_c(cf[1].numpy()), -0.5 * _c(want["none"])) <= TOL
    pw = tp.apply_pointwise(vals, scaling=sp.Scaling.FULL)
    assert torch.equal(pw, tp.forward(tp.backward(vals), sp.Scaling.FULL))
    assert _rel(_c(pw.numpy()), _c(tp.shard_values(vals).numpy())) <= TOL


# -- the multi-transform gate of distributed plans ----------------------------

def test_distributed_batches_run_as_one_batched_execution(monkeypatch):
    """Two transforms of one distributed plan (a ``Transform`` and its
    clone) run as one batched execution while B times the per-shard slab
    is within ``FUSED_BATCH_MAX_DIST_TOTAL`` (the JAX package's form of the
    gate), one at a time past it; the results equal the single calls bit
    for bit either way."""
    from spfft_tpu_torch import multi
    tp, parts = _plan_pair("ragged", monkeypatch=monkeypatch)
    dp = tp.dist_plan
    slab = dp.dim_x * dp.dim_y * dp.max_planes
    assert multi.fusion_eligible(tp, 2) and not multi.fusion_eligible(tp, 1)
    limit = multi.FUSED_BATCH_MAX_DIST_TOTAL // slab
    assert multi.fusion_eligible(tp, limit)
    assert not multi.fusion_eligible(tp, limit + 1)
    vals = _values(parts)
    t = sp.Transform(tp)
    pair = [t, t.clone()]
    want = tp.backward(vals)
    want_f = tp.forward(want, sp.Scaling.FULL)
    for cap, batched in ((multi.FUSED_BATCH_MAX_DIST_TOTAL, True),
                         (slab, False)):
        monkeypatch.setattr(multi, "FUSED_BATCH_MAX_DIST_TOTAL", cap)
        calls = []
        real = type(tp).backward_batched
        monkeypatch.setattr(type(tp), "backward_batched",
                            lambda self, v: calls.append(1) or real(self, v))
        spaces = sp.multi_transform_backward(pair, [vals, vals])
        outs = sp.multi_transform_forward(pair, spaces,
                                          [sp.Scaling.FULL] * 2)
        assert len(calls) == int(batched)
        for s_, o in zip(spaces, outs):
            assert torch.equal(s_, want) and torch.equal(o, want_f)
        monkeypatch.setattr(type(tp), "backward_batched", real)
