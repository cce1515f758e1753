"""The port's distributed plan on the CPU (every kernel wrapper on its
plain version), against the JAX package's distributed plan on the same
numpy-seeded inputs. JAX runs on the 8 virtual CPU devices of
tests/conftest.py with its ``make_mesh(S)``; the port holds the same S
shards in one process on the CPU.

* ``pdft2_swapped``'s plain version against the interpret-mode Pallas
  kernel and ``spfft_tpu.ops.dft.cdft2_xy``; the xy stages against
  ``spfft_tpu.ops.stages`` (C2C, R2C, split windows, wrapped);
* pack, unpack, the exchange and every plan table exactly;
* plans: the four scenarios of tests/test_distributed.py at (11, 12, 13)
  and (8, 8, 8), R2C (plain, centered, folded negative x), 8 shards
  with empty ones, the split wrapped sphere and the split R2C windows,
  one shard (the local collapse); backward, forward NONE and FULL, a
  second backward, the two-kernel route, padding rows, batched,
  coalesced and pointwise calls, the helpers, ``Grid`` / ``Transform``
  and ``convert.distributed_plan_from_arrays``;
* validation errors with the same classes and ``ErrorCode``; the modes
  outside this slice raise typed errors that name their slice.

Tolerance: 2e-6 relative l2 against the JAX package (both sides sum f32
products, in different orders); index tables and the exchange are
exact; the port against itself (batched bands, repeats) is bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.indexing import window_sub_cols as j_window_sub_cols
from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import dft_kernel as jdk
from spfft_tpu.ops import stages as jst
from spfft_tpu.parallel import exchange as jex
from spfft_tpu.parallel.mesh import shard_map as j_shard_map
from spfft_tpu.utils import workloads as jwl

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch.errors import ParameterMismatchError
from spfft_tpu_torch.indexing import window_sub_cols
from spfft_tpu_torch.ops import dft, dft_kernel, stages
from spfft_tpu_torch.parallel import exchange, mesh as tmesh
from spfft_tpu_torch.utils import workloads

from test_distributed import SCENARIOS, split_by_sticks, split_planes
from test_torch_gather import emulated_gather  # noqa: F401 (a fixture)
from test_util import (center_triplets, dense_backward,
                       dense_cube_from_values, dense_forward,
                       hermitian_triplets, random_sparse_triplets,
                       random_values, sample_cube)

torch.set_num_threads(2)

TOL = 2e-6
B = 3


def _mats(m):
    """(cr, ci) tensors of a matrix pair, or of the JAX package's
    Karatsuba triple (whose third matrix the 4-product form needs not)."""
    return dft.device_mats(m[:2], "cpu")


def _rel(got, want):
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _c(a):
    a = np.asarray(a, np.float64)
    return a[..., 0] + 1j * a[..., 1]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# -- the kernel: pdft2_swapped ------------------------------------------------

SWAP_SHAPES = {
    # (P, A, B), mats1 over B (B -> B'), mats2 over A (A -> A')
    "rect_p1": ((1, 12, 20), lambda: jdft.sub_rows_mats(
        24, jdft.BACKWARD, tuple(range(17, 24)) + tuple(range(13))),
        lambda: jdft.c2c_mats(12, jdft.BACKWARD)),
    "rect_p3": ((3, 20, 12), lambda: jdft.sub_cols_mats(
        12, jdft.FORWARD, (10, 11, 0, 1, 2)),
        lambda: jdft.c2c_mats(20, jdft.FORWARD)),
    "square_p3": ((3, 16, 16), lambda: jdft.c2c_mats(16, jdft.BACKWARD),
                  lambda: jdft.c2c_mats(16, jdft.BACKWARD)),
}


@pytest.mark.parametrize("name", sorted(SWAP_SHAPES))
def test_pdft2_swapped_matches_jax(name):
    """The plain version (what the wrapper runs on a CPU tensor) against
    the interpret-mode Pallas ``pdft2_swapped`` and against
    ``spfft_tpu.ops.dft.cdft2_xy``; ``(P, A, B) -> (P, A', B')``."""
    (p, a, b), m1f, m2f = SWAP_SHAPES[name]
    m1, m2 = m1f(), m2f()
    xr, xi = _rand((p, a, b), 1), _rand((p, a, b), 2)
    before = dft_kernel.pdft2_swapped.launches
    yr, yi = dft_kernel.pdft2_swapped(torch.from_numpy(xr),
                                      torch.from_numpy(xi), _mats(m1),
                                      _mats(m2))
    assert dft_kernel.pdft2_swapped.launches == before  # plain on the CPU
    assert tuple(yr.shape) == (p, m2[0].shape[1], m1[0].shape[1])
    assert yr.is_contiguous() and yi.is_contiguous()
    got = yr.numpy() + 1j * yi.numpy()
    wr, wi = jdk.pdft2_swapped(jnp.asarray(xr), jnp.asarray(xi), m1, m2,
                               interpret=True)
    assert _rel(got, np.asarray(wr) + 1j * np.asarray(wi)) <= TOL
    comp = jdft.cdft2_xy(jnp.asarray(xr + 1j * xi), m1, m2)
    assert _rel(got, np.asarray(comp)) <= TOL


# -- the xy stages in the plane layout (planes, dim_y, x) --------------------

def _xy_case(kind):
    """(dims (nx, ny), split window or None, r2c)."""
    return {"c2c": ((12, 10), None, False),
            "c2c_split_wrapped": ((24, 10), (18, 13), False),
            "r2c": ((12, 10), None, True),
            "r2c_split0": ((24, 20), (0, 5), True),
            "r2c_split3": ((24, 20), (3, 5), True)}[kind]


@pytest.mark.parametrize("kind", ["c2c", "c2c_split_wrapped", "r2c",
                                  "r2c_split0", "r2c_split3"])
def test_xy_stages_match_jax(kind):
    (nx, ny), win, r2c = _xy_case(kind)
    planes = 3
    xf = nx // 2 + 1 if r2c else nx
    x0, w = win or (0, xf)
    rows = tuple(int(r) for r in (x0 + np.arange(w)) % xf)
    rng = np.random.default_rng(7)
    grid = (rng.standard_normal((planes, ny, w))
            + 1j * rng.standard_normal((planes, ny, w))).astype(np.complex64)
    gr, gi = (torch.from_numpy(np.ascontiguousarray(grid.real)),
              torch.from_numpy(np.ascontiguousarray(grid.imag)))
    yb, yf = (_mats(dft.c2c_mats(ny, dft.BACKWARD)),
              _mats(dft.c2c_mats(ny, dft.FORWARD)))
    jg = jnp.asarray(grid)
    if r2c:
        space = rng.standard_normal((planes, ny, nx)).astype(np.float32)
        got_b = stages.xy_backward_r2c(
            gr, gi, yb, _mats(dft.sub_rows_c2r_mats(nx, rows))).numpy()
        fr, fi = stages.xy_forward_r2c(
            torch.from_numpy(space), _mats(dft.sub_cols_r2c_mats(nx, rows)),
            yf)
        if win is None:
            want_b = jst.xy_backward_r2c(jg, nx)
            want_f = jst.xy_forward_r2c(jnp.asarray(space))
        else:
            want_b = jst.xy_backward_r2c_split(jg, x0, nx, xf)
            want_f = jst.xy_forward_r2c_split(jnp.asarray(space), x0, w)
    else:
        space = (rng.standard_normal((planes, ny, nx))
                 + 1j * rng.standard_normal((planes, ny, nx))) \
            .astype(np.complex64)
        sr, si = (torch.from_numpy(np.ascontiguousarray(space.real)),
                  torch.from_numpy(np.ascontiguousarray(space.imag)))
        xb = _mats(dft.sub_rows_mats(nx, dft.BACKWARD, rows))
        xfm = _mats(dft.sub_cols_mats(nx, dft.FORWARD, rows))
        if win is None:
            br, bi = stages.xy_backward_c2c(gr, gi, xb, yb)
            fr, fi = stages.xy_forward_c2c(sr, si, xfm, yf)
            want_b = jst.xy_backward_c2c(jg)
            want_f = jst.xy_forward_c2c(jnp.asarray(space))
        else:
            br, bi = stages.xy_backward_c2c_split(gr, gi, yb, xb)
            fr, fi = stages.xy_forward_c2c_split(sr, si, xfm, yf)
            want_b = jst.xy_backward_c2c_split(jg, x0, nx)
            want_f = jst.xy_forward_c2c_split(jnp.asarray(space), x0, w)
        got_b = br.numpy() + 1j * bi.numpy()
    assert got_b.shape == (planes, ny, nx)
    assert _rel(got_b, np.asarray(want_b)) <= TOL
    got_f = fr.numpy() + 1j * fi.numpy()
    assert got_f.shape == (planes, ny, w)
    assert _rel(got_f, np.asarray(want_f)) <= TOL


def test_complete_plane_hermitian_matches_jax():
    rng = np.random.default_rng(8)
    grid = (rng.standard_normal((3, 10, 4))
            + 1j * rng.standard_normal((3, 10, 4))).astype(np.complex64)
    grid[:, rng.random(10) < 0.5, 0] = 0  # missing entries of x = 0
    gr = torch.from_numpy(np.ascontiguousarray(grid.real))
    gi = torch.from_numpy(np.ascontiguousarray(grid.imag))
    stages.complete_plane_hermitian(gr, gi)
    want = np.asarray(jst.complete_plane_hermitian(jnp.asarray(grid)))
    np.testing.assert_array_equal(gr.numpy() + 1j * gi.numpy(), want)


# -- the exchange -------------------------------------------------------------

def _blocks_case(seed=9):
    rng = np.random.default_rng(seed)
    s, ms, mp, dz, ny, xf = 4, 5, 3, 9, 6, 5
    sticks = (rng.standard_normal((s, ms, dz))
              + 1j * rng.standard_normal((s, ms, dz))).astype(np.complex64)
    zmap = np.full((s, mp), dz, np.int32)
    zmap[0, :3], zmap[1, :2], zmap[2, :3], zmap[3, :1] = \
        [0, 1, 2], [3, 4], [5, 6, 7], [8]
    col_inv = rng.permutation(np.concatenate(
        [np.arange(s * ms - 3), np.full(ny * xf - s * ms + 3, s * ms)])) \
        .astype(np.int32)
    return sticks, zmap, col_inv, (s, ms, mp, dz, ny, xf)


def _planar(fn, z):
    """Run a port exchange function on the real and imaginary planes."""
    return fn(torch.from_numpy(np.ascontiguousarray(z.real))).numpy() \
        + 1j * fn(torch.from_numpy(np.ascontiguousarray(z.imag))).numpy()


def test_block_exchange_matches_jax_exactly():
    """Pack and unpack per shard, both directions, and the exchange as the
    JAX package's ``all_to_all`` over a 4-device mesh computes it."""
    sticks, zmap, col_inv, (s, ms, mp, dz, ny, xf) = _blocks_case()
    blocks = _planar(lambda t: exchange.pack_freq_to_blocks(
        t, torch.from_numpy(zmap).long()), sticks)
    want = np.stack([np.asarray(jex.pack_freq_to_blocks(
        jnp.asarray(sticks[r]), jnp.asarray(zmap))) for r in range(s)])
    np.testing.assert_array_equal(blocks, want)

    recv = _planar(exchange.all_to_all_blocks, blocks)
    mesh = jpar.make_mesh(s)
    a2a = jax.jit(j_shard_map(
        lambda b: jex.all_to_all_blocks(b[0], "shards")[None], mesh=mesh,
        in_specs=P("shards"), out_specs=P("shards")))
    np.testing.assert_array_equal(recv, np.asarray(a2a(jnp.asarray(want))))

    grid = _planar(lambda t: exchange.unpack_blocks_to_grid(
        t, torch.from_numpy(col_inv).long(), ny, xf), recv)
    want = np.stack([np.asarray(jex.unpack_blocks_to_grid(
        jnp.asarray(recv[r]), jnp.asarray(col_inv), ny, xf))
        for r in range(s)])
    np.testing.assert_array_equal(grid, want)

    cols = np.full(s * ms, ny * xf, np.int32)
    cols[:s * ms - 3] = np.random.default_rng(10).permutation(
        ny * xf)[:s * ms - 3]
    fblocks = _planar(lambda t: exchange.pack_space_to_blocks(
        t, torch.from_numpy(cols).long(), s, ms), grid)
    want = np.stack([np.asarray(jex.pack_space_to_blocks(
        jnp.asarray(grid[r]), jnp.asarray(cols), s, ms)) for r in range(s)])
    np.testing.assert_array_equal(fblocks, want)
    z_src = np.argsort(np.where(zmap < dz, zmap, 2 * dz), axis=None)[:dz]
    sticks_back = _planar(lambda t: exchange.unpack_blocks_to_sticks(
        exchange.all_to_all_blocks(t), torch.from_numpy(z_src).long()),
        fblocks)
    frecv = np.asarray(a2a(jnp.asarray(want)))
    want = np.stack([np.asarray(jex.unpack_blocks_to_sticks(
        jnp.asarray(frecv[r]), jnp.asarray(z_src.astype(np.int32))))
        for r in range(s)])
    np.testing.assert_array_equal(sticks_back, want)


def test_workload_helpers_match_jax():
    trip = jwl.spherical_cutoff_triplets(12, radius=4)
    for s in (1, 3, 4):
        for a, b in zip(workloads.round_robin_stick_partition(
                trip, (12, 12, 12), s),
                jwl.round_robin_stick_partition(trip, (12, 12, 12), s)):
            np.testing.assert_array_equal(a, b)
    for dz, s in ((13, 4), (8, 8), (5, 7)):
        assert workloads.even_plane_split(dz, s) == \
            jwl.even_plane_split(dz, s)
    rng = np.random.default_rng(11)
    cols = rng.integers(0, 10 * 7, 50)
    for x0, w in ((0, 7), (3, 4), (5, 4)):
        np.testing.assert_array_equal(window_sub_cols(cols, 7, x0, w),
                                      j_window_sub_cols(cols, 7, x0, w))


# -- plans --------------------------------------------------------------------

def _c2c_case(scenario, dims):
    rng = np.random.default_rng(42)
    stick_w, plane_w = SCENARIOS[scenario]
    trip = random_sparse_triplets(rng, dims)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    parts = split_by_sticks(trip, dims, stick_w)
    planes = split_planes(dims[2], plane_w)
    return "c2c", dims, parts, planes, cube


def _r2c_values(dims, parts, seed):
    """A seeded real field's spectrum masked by the hermitian closure of
    the stick set: consistent hermitian values."""
    nx, ny, nz = dims
    trip = np.concatenate(parts)
    field = np.random.default_rng(seed).standard_normal((nz, ny, nx))
    st = np.where(trip < 0, trip + np.array(dims), trip)
    mask = np.zeros((nz, ny, nx), bool)
    mask[st[:, 2], st[:, 1], st[:, 0]] = True
    mask[(-st[:, 2]) % nz, (-st[:, 1]) % ny, (-st[:, 0]) % nx] = True
    return dense_forward(field) * mask


def _fold_some(trip, dims, rng):
    """Centered triplets with some x > 0 given as their x < 0 mirror."""
    t = center_triplets(trip, dims).astype(np.int64)
    flip = (t[:, 0] > 0) & (2 * t[:, 0] != dims[0]) \
        & (rng.random(len(t)) < 0.5)
    t[flip] = -t[flip]
    return t.astype(np.int32)


def _case_inputs(name):
    """(kind, dims, per-shard triplets, slab heights, dense spectrum)."""
    if name.startswith("c2c_"):
        scenario, d = name[4:].rsplit("_", 1)
        return _c2c_case(scenario, tuple(int(x) for x in d.split("x")))
    rng = np.random.default_rng(5)
    if name in ("r2c", "r2c_centered", "r2c_folded"):
        dims = (12, 11, 13)
        trip = hermitian_triplets(rng, dims)
        if name == "r2c_centered":
            trip = center_triplets(trip, dims)
        parts = split_by_sticks(trip, dims, [1, 3, 2, 2])
        if name == "r2c_folded":  # a folded value stays on its stick
            parts = [_fold_some(p, dims, rng) for p in parts]
        planes = split_planes(dims[2], [2, 1, 1, 1])
        return "r2c", dims, parts, planes, _r2c_values(dims, parts, 5)
    if name == "eight_empty":
        dims = (16, 16, 16)
        trip = random_sparse_triplets(rng, dims)
        cube = dense_cube_from_values(trip, random_values(rng, len(trip)),
                                      dims)
        return ("c2c", dims,
                split_by_sticks(trip, dims, [2, 0, 1, 0, 3, 0, 1, 1]),
                split_planes(16, [0, 1, 0, 3, 1, 0, 2, 1]), cube)
    if name == "split_sphere":  # wrapped window (18, 13)
        dims = (24, 24, 24)
        trip = jwl.spherical_cutoff_triplets(24, radius=6)
        cube = dense_cube_from_values(trip, random_values(rng, len(trip)),
                                      dims)
        return ("c2c", dims, split_by_sticks(trip, dims, [2, 1, 0, 1]),
                split_planes(24, [1, 2, 1, 2]), cube)
    if name in ("split_r2c0", "split_r2c3"):  # windows (0, 5), (3, 5)
        dims = (24, 20, 18)
        x_lo = 0 if name == "split_r2c0" else 3
        trip = np.array([[x, y, z] for x in range(x_lo, x_lo + 5)
                         for y in range(dims[1]) for z in range(dims[2])],
                        np.int32)
        parts = split_by_sticks(trip, dims, [1, 2, 1, 1])
        return ("r2c", dims, parts, split_planes(18, [2, 1, 2, 1]),
                _r2c_values(dims, parts, 56))
    if name == "single":  # one shard: the local collapse
        dims = (10, 9, 8)
        trip = random_sparse_triplets(rng, dims)
        cube = dense_cube_from_values(trip, random_values(rng, len(trip)),
                                      dims)
        return "c2c", dims, [trip], [dims[2]], cube
    raise KeyError(name)


C2C_CASES = tuple(f"c2c_{s}_{d}" for s in sorted(SCENARIOS)
                  for d in ("11x12x13", "8x8x8"))
CASES = C2C_CASES + ("r2c", "r2c_centered", "r2c_folded", "eight_empty",
                     "split_sphere", "split_r2c0", "split_r2c3", "single")
SPLITS = {"split_sphere": (18, 13), "split_r2c0": (0, 5),
          "split_r2c3": (3, 5)}


def _plans(kind, dims, parts, planes, **kw):
    tt = {"c2c": "C2C", "r2c": "R2C"}[kind]
    s = len(parts)
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType[tt], *dims,
                                    parts, planes, mesh=jpar.make_mesh(s),
                                    precision="single")
    tp = sp.make_distributed_plan(sp.TransformType[tt], *dims, parts,
                                  planes, device="cpu", **kw)
    return jp, tp


@functools.lru_cache(maxsize=None)
def _case(name):
    kind, dims, parts, planes, cube = _case_inputs(name)
    jp, tp = _plans(kind, dims, parts, planes)
    vals = [sample_cube(cube, p, dims).astype(np.complex64) for p in parts]
    jb = np.array(jp.backward(vals))
    tb = tp.backward(vals).numpy()
    out = {"kind": kind, "dims": dims, "parts": parts, "planes": planes,
           "cube": cube, "vals": vals, "jp": jp, "tp": tp, "jb": jb,
           "tb": tb}
    for sc in ("none", "full"):
        out["jf_" + sc] = np.asarray(jp.forward(jax.device_put(
            jb, jp._sharded), spfft_tpu.Scaling(sc)))
        out["tf_" + sc] = tp.forward(torch.from_numpy(jb),
                                     sp.Scaling(sc)).numpy()
    return out


def _space(c, a):
    return a if c["kind"] == "r2c" else _c(a)


@pytest.mark.parametrize("name", CASES)
def test_backward_matches_jax_and_oracle(name):
    c = _case(name)
    tb, jb = c["tb"], c["jb"]
    assert tb.dtype == np.float32 and tb.shape == jb.shape
    assert _rel(_space(c, tb), _space(c, jb)) <= TOL
    oracle = dense_backward(c["cube"])
    if c["kind"] == "r2c":
        assert np.abs(oracle.imag).max() < 1e-9 * np.abs(oracle).max()
    got = np.concatenate(c["tp"].unshard_space(tb))
    pred = sp.predicted_rel_error("single", max(c["dims"]), True)
    assert _rel(got, oracle) <= pred
    # a second backward equals the first: nothing stale survives
    np.testing.assert_array_equal(c["tp"].backward(c["vals"]).numpy(), tb)


@pytest.mark.parametrize("scaling", ["none", "full"])
@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax(name, scaling):
    c = _case(name)
    got, want = c["tf_" + scaling], c["jf_" + scaling]
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel(_c(got), _c(want)) <= TOL
    if scaling == "full":  # the round trip gives the values back
        for g, v in zip(c["tp"].unshard_values(got), c["vals"]):
            assert _rel(g, v) <= TOL


@pytest.mark.parametrize("name", CASES)
def test_plan_tables_match_jax_exactly(name):
    c = _case(name)
    jp, tp = c["jp"], c["tp"]
    assert tp.split_x == jp._split_x == SPLITS.get(name)
    for t in ("_vi", "_slot_src", "_cols_flat", "_col_inv", "_zmap",
              "_z_src", "_onehot"):
        np.testing.assert_array_equal(getattr(tp, t), getattr(jp, t),
                                      err_msg=t)
    assert tp._has_conj == jp._has_conj == (name == "r2c_folded")
    np.testing.assert_array_equal(tp._conj_mult, jp._conj_mult)
    assert (tp._local1 is not None) == (jp._local1 is not None) \
        == (name == "single")


@pytest.mark.parametrize("name", ["c2c_uniform_11x12x13", "r2c_folded",
                                  "eight_empty", "split_sphere",
                                  "split_r2c0"])
def test_two_kernel_route_matches_fused(name):
    """``fused=False`` (the gather kernel per shard, one ``pdft_last``)
    against the fused route and the JAX plan."""
    c = _case(name)
    _, tp2 = _plans(c["kind"], c["dims"], c["parts"], c["planes"],
                    fused=False)
    assert not tp2.fused_dist_active and c["tp"].fused_dist_active
    assert tp2.fused_dist_fallback_reason is None
    tb = tp2.backward(c["vals"]).numpy()
    assert _rel(_space(c, tb), _space(c, c["tb"])) <= TOL
    assert _rel(_space(c, tb), _space(c, c["jb"])) <= TOL
    got = tp2.forward(torch.from_numpy(c["jb"]), sp.Scaling.FULL).numpy()
    assert _rel(_c(got), _c(c["jf_full"])) <= TOL


@pytest.mark.parametrize("name", ["c2c_random_nonuniform_11x12x13",
                                  "r2c_folded", "eight_empty", "single"])
def test_stacked_value_indices_match_each_shard(name):
    """The two-kernel route's stacked gather tables: row r of ``_t_vi``
    is shard r's ``value_indices`` exactly, padded with ``max_sticks *
    dim_z`` (past every shard's slots, read as 0). Each shard's indices
    stay inside its own rows, and every padding index (``_t_vi``'s, and
    ``_t_slot_src``'s sentinel ``max_values``) is at or past the stacked
    source's extent, so the padding needs no per-shard extent."""
    c = _case(name)
    _, tp2 = _plans(c["kind"], c["dims"], c["parts"], c["planes"],
                    fused=False)
    dp = tp2.dist_plan
    vi = tp2._t_vi.numpy()
    assert vi.shape == (dp.num_shards, dp.max_values) and vi.dtype == np.int32
    assert tp2._t_vi.stride() == (-(-dp.max_values // 4) * 4, 1)  # 16 bytes
    for r, p in enumerate(dp.shard_plans):
        np.testing.assert_array_equal(vi[r, :p.num_values], p.value_indices)
        assert (vi[r, p.num_values:] == dp.max_sticks * dp.dim_z).all()
        assert (vi[r, :p.num_values] < p.num_sticks * dp.dim_z).all()
    ss = tp2._t_slot_src.numpy()
    for r, p in enumerate(dp.shard_plans):
        live = ss[r] < dp.max_values
        assert (ss[r][live] < p.num_values).all()
        assert not live[p.num_sticks * dp.dim_z:].any()
        assert (ss[r][~live] == dp.max_values).all()
    assert c["tp"]._t_vi is None  # the fused route keeps CSRs instead


@pytest.mark.parametrize("name", ["c2c_random_nonuniform_11x12x13",
                                  "r2c_folded", "eight_empty"])
def test_two_kernel_route_writes_every_value_slot(monkeypatch, request,
                                                  name):
    """One gather launch a direction over every shard, through the
    wrapper's launch path (``csrc/gather.cu``'s C entry emulated), with
    every ``torch.empty`` filled with NaN: the forward's padding value
    rows come out as 0, and the pair equals the plain route's bit for
    bit (batched too)."""
    c = _case(name)
    _, tp2 = _plans(c["kind"], c["dims"], c["parts"], c["planes"],
                    fused=False)
    want_b = tp2.backward(c["vals"])
    want_f = tp2.forward(want_b, sp.Scaling.FULL)
    bands = tp2.shard_values_batch(_bands(c))
    want_bb = tp2.backward_batched(bands)
    empty = torch.empty

    def nan_empty(*a, **k):
        t = empty(*a, **k)
        return t.fill_(np.nan) if t.is_floating_point() else t

    emulated_gather = request.getfixturevalue("emulated_gather")
    monkeypatch.setattr(torch, "empty", nan_empty)
    got_b = tp2.backward(c["vals"])
    got_f = tp2.forward(got_b, sp.Scaling.FULL)
    assert len(emulated_gather) == 2  # one launch a direction
    assert torch.equal(got_b, want_b) and torch.equal(got_f, want_f)
    for r, p in enumerate(tp2.dist_plan.shard_plans):
        assert not got_f[r, p.num_values:].any()
    assert torch.equal(tp2.backward_batched(bands), want_bb)
    assert len(emulated_gather) == 3


def test_forward_ignores_padding_rows():
    """Garbage in the rows past a shard's slab height changes nothing
    (tests/test_distributed.py's test of the same name)."""
    c = _case("c2c_random_nonuniform_11x12x13")
    poisoned = c["jb"].copy()
    for r, n in enumerate(c["tp"].dist_plan.num_planes):
        poisoned[r, n:] = 1e30
    got = c["tp"].forward(torch.from_numpy(poisoned)).numpy()
    np.testing.assert_array_equal(got, c["tf_none"])


def _bands(c):
    """B value sets: band b the values times 1 + b / 2 (a scale keeps R2C
    values hermitian)."""
    return [[v * np.float32(1 + b / 2) for v in c["vals"]]
            for b in range(B)]


@pytest.mark.parametrize("name", ["c2c_uniform_11x12x13", "r2c_folded",
                                  "single"])
def test_batched_bands_equal_single_calls(name):
    c = _case(name)
    tp, jp = c["tp"], c["jp"]
    bands = _bands(c)
    got = tp.backward_batched(bands)
    assert got.shape[:2] == (len(c["parts"]), B)
    for b in range(B):
        assert torch.equal(got[:, b], tp.backward(bands[b]))
    if name != "single":  # the JAX local delegate has no batched body
        want = np.asarray(jp.backward_batched(bands))
        assert _rel(_space(c, got.numpy()), _space(c, want)) <= TOL
    for sc in (sp.Scaling.NONE, sp.Scaling.FULL):
        out = tp.forward_batched(got, sc)
        assert out.shape == (len(c["parts"]), B, tp.dist_plan.max_values, 2)
        for b in range(B):
            assert torch.equal(out[:, b], tp.forward(got[:, b], sc))
    back = tp.unshard_values_batch(out)
    for b in range(B):
        for g, v in zip(back[b], bands[b]):
            assert _rel(g, v) <= TOL
    stacked = tp.shard_values_batch(bands)
    assert torch.equal(tp.backward_batched(stacked), got)


def test_coalesce_matches_single_calls():
    c = _case("r2c")
    tp = c["tp"]
    bands = _bands(c)
    spaces = tp.coalesce_backward(bands)
    for s, v in zip(spaces, bands):
        assert torch.equal(s, tp.backward(v))
    outs = tp.coalesce_forward(spaces, sp.Scaling.FULL)
    for o, s in zip(outs, spaces):
        assert torch.equal(o, tp.forward(s, sp.Scaling.FULL))
    assert len(tp.coalesce_backward(bands[:1])) == 1


@pytest.mark.parametrize("name", ["c2c_random_nonuniform_11x12x13",
                                  "r2c_centered", "single"])
def test_apply_pointwise_matches_jax_and_two_calls(name):
    c = _case(name)
    tp, jp = c["tp"], c["jp"]
    full = sp.Scaling.FULL
    got = tp.apply_pointwise(c["vals"]).numpy()
    np.testing.assert_array_equal(got, tp.forward(tp.backward(c["vals"]))
                                  .numpy())
    assert _rel(_c(got), _c(jp.apply_pointwise(c["vals"]))) <= TOL
    for g, v in zip(tp.unshard_values(tp.apply_pointwise(
            c["vals"], scaling=full)), c["vals"]):
        assert _rel(g, v) <= TOL
    # a potential as padded stacked slabs, through fn_args
    dp = tp.dist_plan
    pot = np.random.default_rng(3).uniform(
        0.5, 1.5, (dp.num_shards, dp.max_planes, dp.dim_y, dp.dim_x))
    r2c = c["kind"] == "r2c"

    def fn(space, w):
        return space * (w if r2c else w[..., None])

    tpot = torch.from_numpy(pot.astype(np.float32))
    got = tp.apply_pointwise(c["vals"], fn, tpot, scaling=full)
    want = tp.forward(fn(tp.backward(c["vals"]), tpot), full)
    assert torch.equal(got, want)
    jwant = jp.apply_pointwise(c["vals"], fn,
                               jax.device_put(pot.astype(np.float32),
                                              jp._sharded)
                               if jp._local1 is None else
                               jnp.asarray(pot.astype(np.float32)),
                               scaling=spfft_tpu.Scaling.FULL)
    assert _rel(_c(got.numpy()), _c(jwant)) <= TOL


def test_iterate_pointwise_matches_steps_and_jax():
    c = _case("c2c_uniform_8x8x8")
    tp, jp = c["tp"], c["jp"]

    def damp(space):
        return 0.5 * space

    got = tp.iterate_pointwise(c["vals"], damp, steps=3)
    seq = tp.shard_values(c["vals"])
    for _ in range(3):
        seq = tp.apply_pointwise(seq, damp, scaling=sp.Scaling.FULL)
    assert torch.equal(got, seq)
    assert _rel(_c(got.numpy()),
                _c(jp.iterate_pointwise(c["vals"], damp, steps=3))) <= TOL
    assert torch.equal(tp.iterate_pointwise(c["vals"], damp, steps=0),
                       tp.shard_values(c["vals"]))
    with pytest.raises(sp.InvalidParameterError):
        tp.iterate_pointwise(c["vals"], damp, steps=-1)


@pytest.mark.parametrize("name", ["eight_empty", "r2c_folded"])
def test_helpers_getters_and_wire_bytes_match_jax(name):
    c = _case(name)
    tp, jp = c["tp"], c["jp"]
    s = len(c["parts"])
    for attr in ("dim_x", "dim_y", "dim_z", "global_size",
                 "num_global_elements"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.transform_type.value == jp.transform_type.value
    for r in range(s):
        for m in ("local_z_length", "local_z_offset", "local_slice_size",
                  "num_local_elements"):
            assert getattr(tp, m)(r) == getattr(jp, m)(r), (m, r)
    for fwd in (False, True):
        assert tp.exchange_wire_bytes(fwd) == jp.exchange_wire_bytes(fwd)
        assert tp.exchange_busiest_link_bytes(fwd) \
            == jp.exchange_busiest_link_bytes(fwd)
    assert tp.estimated_device_bytes() > 0
    sv = tp.shard_values(c["vals"])
    np.testing.assert_array_equal(sv.numpy(),
                                  np.asarray(jp.shard_values(c["vals"])))
    for a, b in zip(tp.unshard_values(sv), c["vals"]):
        np.testing.assert_array_equal(a, b)
    slabs = jp.unshard_space(c["jb"])
    np.testing.assert_array_equal(tp.shard_space(slabs).numpy(),
                                  np.asarray(jp.shard_space(slabs)))
    for a, b in zip(tp.unshard_space(c["tb"]), c["tp"].unshard_space(
            torch.from_numpy(c["tb"]))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(sp.InvalidParameterError):
        tp.shard_values(c["vals"][:-1])
    with pytest.raises(sp.InvalidParameterError):
        tp.shard_space(slabs[:-1])
    with pytest.raises(sp.InvalidParameterError):
        tp.backward(sv[:, :-1])


def test_distributed_grid_and_transform_match_jax():
    c = _case("c2c_uniform_11x12x13")
    dims, parts, planes = c["dims"], c["parts"], c["planes"]
    jg = spfft_tpu.Grid(*dims, 1000, mesh=jpar.make_mesh(4),
                        max_local_z_length=dims[2], precision="single")
    tg = sp.Grid(*dims, 1000, mesh=sp.make_mesh(4, "cpu"),
                 max_local_z_length=dims[2])
    assert tg.distributed and tg.mesh.num_shards == 4
    assert tg.device == torch.device("cpu") and tg.copy().distributed
    du, tu = spfft_tpu.ProcessingUnit.DEVICE, sp.ProcessingUnit.DEVICE
    jt = jg.create_transform(du, spfft_tpu.TransformType.C2C, *dims,
                             triplets_per_shard=parts,
                             planes_per_shard=planes)
    tt = tg.create_transform(tu, sp.TransformType.C2C, *dims,
                             triplets_per_shard=parts,
                             planes_per_shard=planes)
    for attr in ("dim_x", "dim_y", "dim_z", "global_size",
                 "num_global_elements", "distributed", "num_shards",
                 "precision"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    assert tt.exchange_type.value == jt.exchange_type.value
    for r in range(4):
        for m in ("local_z_length", "local_z_offset", "local_slice_size",
                  "num_local_elements"):
            assert getattr(tt, m)(r) == getattr(jt, m)(r)
    got = tt.backward(c["vals"])
    assert _rel(_c(got.numpy()), _c(jt.backward(c["vals"]))) <= TOL
    out = tt.forward(scaling=sp.Scaling.FULL)
    assert _rel(_c(out.numpy()),
                _c(jt.forward(scaling=spfft_tpu.Scaling.FULL))) <= TOL
    # the JAX package's distributed create_transform checks, error for error
    for kw in ({"triplets_per_shard": None},
               {"num_local_elements": 5}, {"local_z_length": 5},
               {"planes_per_shard": [dims[2], 0, 0, 0]}):
        args = dict({"triplets_per_shard": parts,
                     "planes_per_shard": planes}, **kw)
        jsmall = spfft_tpu.Grid(*dims, 1000, mesh=jpar.make_mesh(4),
                                max_local_z_length=4)
        tsmall = sp.Grid(*dims, 1000, mesh=sp.make_mesh(4, "cpu"),
                         max_local_z_length=4)
        _both_raise(lambda: jsmall.create_transform(
            du, spfft_tpu.TransformType.C2C, *dims, **args),
            lambda: tsmall.create_transform(
                tu, sp.TransformType.C2C, *dims, **args))
    _both_raise(lambda: spfft_tpu.Grid(*dims, 2, mesh=jpar.make_mesh(4))
                .create_transform(du, spfft_tpu.TransformType.C2C, *dims,
                                  triplets_per_shard=parts,
                                  planes_per_shard=planes),
                lambda: sp.Grid(*dims, 2, mesh=sp.make_mesh(4, "cpu"))
                .create_transform(tu, sp.TransformType.C2C, *dims,
                                  triplets_per_shard=parts,
                                  planes_per_shard=planes))


@pytest.mark.parametrize("name", ["c2c_sticks_first_planes_last_8x8x8",
                                  "r2c_folded"])
def test_distributed_plan_from_jax_arrays(name):
    c = _case(name)
    fields = [dataclasses.asdict(p) for p in c["jp"].dist_plan.shard_plans]
    plan = convert.distributed_plan_from_arrays(
        fields, c["jp"].dist_plan.num_planes, device="cpu")
    np.testing.assert_array_equal(plan.backward(c["vals"]).numpy(), c["tb"])
    np.testing.assert_array_equal(
        plan.forward(torch.from_numpy(c["jb"]), sp.Scaling.FULL).numpy(),
        c["tf_full"])
    with pytest.raises(ParameterMismatchError):
        convert.distributed_plan_from_arrays(fields, [1] * len(fields),
                                             device="cpu")


# -- errors -------------------------------------------------------------------

def _both_raise(jcall, tcall):
    with pytest.raises(spfft_tpu.GenericError) as je:
        jcall()
    with pytest.raises(sp.GenericError) as te:
        tcall()
    assert type(te.value).__name__ == type(je.value).__name__
    assert int(te.value.error_code()) == int(je.value.error_code())


def test_plan_validation_matches_jax():
    dims = (8, 8, 8)
    t0 = np.array([[0, 0, 0]])
    c2c_j, c2c_t = spfft_tpu.TransformType.C2C, sp.TransformType.C2C
    for parts, planes in (([t0, t0 + 1], [4, 3]),      # plane sum
                          ([t0, t0], [4, 4]),          # duplicate stick
                          ([t0, t0 + 1], [8]),         # length mismatch
                          ([], []),                    # no shard
                          ([t0, t0 + 1], [9, -1]),     # negative planes
                          ([t0 + 9, t0 + 1], [4, 4])):  # bad index
        _both_raise(
            lambda: jpar.make_distributed_plan(
                c2c_j, *dims, parts, planes,
                mesh=jpar.make_mesh(max(len(parts), 1))),
            lambda: sp.make_distributed_plan(c2c_t, *dims, parts, planes,
                                             device="cpu"))
    _both_raise(
        lambda: jpar.make_distributed_plan(c2c_j, *dims, [t0, t0 + 1],
                                           [4, 4], mesh=jpar.make_mesh(3)),
        lambda: sp.make_distributed_plan(c2c_t, *dims, [t0, t0 + 1], [4, 4],
                                         mesh=sp.make_mesh(3, "cpu")))


OUT_OF_SLICE = {
    "compact": ({"exchange": sp.ExchangeType.COMPACT_BUFFERED}, "ring"),
    "compact_float": ({"exchange": sp.ExchangeType.COMPACT_BUFFERED_FLOAT},
                      "ring"),
    "ring": ({"exchange": sp.ExchangeType.UNBUFFERED}, "ring"),
    "buffered_float": ({"exchange": sp.ExchangeType.BUFFERED_FLOAT},
                       "wire"),
    "overlap": ({"overlap_chunks": 2}, "overlap"),
    "wire_precision": ({"wire_precision": 3}, "wire"),
    "wire_budget": ({"wire_error_budget": 1e-3}, "wire"),
}


@pytest.mark.parametrize("mode", sorted(OUT_OF_SLICE))
def test_modes_outside_the_slice_raise_typed_errors(mode):
    kw, later = OUT_OF_SLICE[mode]
    t0 = np.array([[0, 0, 0]])
    with pytest.raises(sp.InvalidParameterError,
                       match=f"not in this slice.*{later}"):
        sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                 [t0, t0 + 1], [4, 4], device="cpu", **kw)


def test_mesh_and_valid_modes(monkeypatch):
    t0 = np.array([[0, 0, 0]])
    for kw in ({"exchange": sp.ExchangeType.BUFFERED},
               {"overlap_chunks": 1}, {"wire_precision": 0}):
        plan = sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                        [t0, t0 + 1], [4, 4], device="cpu",
                                        **kw)
        assert plan.mesh.num_shards == 2 and plan.device.type == "cpu"
    for kw in ({"overlap_chunks": 0}, {"wire_precision": 4}):
        with pytest.raises(sp.InvalidParameterError):
            sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                     [t0, t0 + 1], [4, 4], device="cpu",
                                     **kw)
    mesh = sp.make_mesh(2, "cpu")
    assert (mesh.num_shards, mesh.device, mesh.axis_name) == \
        (2, torch.device("cpu"), "shards")
    assert sp.make_mesh(2, ["cpu", "cpu"]) == mesh
    with pytest.raises(sp.InvalidParameterError):
        sp.make_mesh(2, ["cpu", "meta"])
    for bad in (0, -1, 2.0, True):
        with pytest.raises(sp.InvalidParameterError):
            sp.make_mesh(bad, "cpu")
    with pytest.raises(sp.InvalidParameterError, match="mesh"):
        sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                 [t0, t0 + 1], [4, 4], mesh=object())
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(sp.DeviceError):
            sp.make_mesh(2)
        with pytest.raises(sp.DeviceError):
            sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                     [t0, t0 + 1], [4, 4])
        with pytest.raises(sp.DeviceError):
            sp.make_distributed_plan(sp.TransformType.C2C, 8, 8, 8,
                                     [t0, t0 + 1], [4, 4], mesh=mesh,
                                     device="cuda")
    # a mesh over two cards is the multi-GPU slice's
    monkeypatch.setattr(tmesh, "resolve_device", torch.device)
    with pytest.raises(sp.InvalidParameterError,
                       match="not in this slice.*multi-GPU"):
        sp.make_mesh(2, ["cuda:0", "cuda:1"])


# -- the stage methods and the FP32 x stage -----------------------------------

@pytest.mark.parametrize("name", ["c2c_uniform_11x12x13", "r2c_folded",
                                  "split_sphere"])
@pytest.mark.parametrize("fused", [True, False])
def test_stage_methods_compose_to_the_pair(name, fused):
    """The plan's six stage methods, run one after another (as
    ``chip_smoke.py`` times them), give the public pair's results bit for
    bit; the exchange's steps are pack, transpose, unpack."""
    c = _case(name)
    _, tp = _plans(c["kind"], c["dims"], c["parts"], c["planes"],
                   fused=fused)
    v = tp.shard_values(c["vals"])[:, None]
    for forward in (False, True):
        assert [n for n, _ in tp._exchange_steps(forward)] == \
            ["pack", "transpose", "unpack"]
    space = tp._xy_backward(tp._exchange(tp._z_backward(v)))
    out = tp._z_forward(tp._exchange(tp._xy_forward(space), forward=True),
                        True)
    np.testing.assert_array_equal(tp._public_space(space)[:, 0].numpy(),
                                  tp.backward(c["vals"]).numpy())
    np.testing.assert_array_equal(
        out[:, 0].numpy(),
        tp.forward(tp.backward(c["vals"]), sp.Scaling.FULL).numpy())


def test_r2c_x_stage_refuses_reduced_fp32_matmul():
    """The R2C x stage is ``torch.matmul``: under a reduced float32
    precision (here oneDNN's bf16, which ``set_float32_matmul_precision
    ("medium")`` also sets) it refuses instead of losing the accuracy
    contract, and so does a distributed R2C plan that runs it."""
    c = _case("r2c")
    x = torch.from_numpy(_rand((3, 10, 12), 1))
    prev = torch.backends.mkldnn.matmul.fp32_precision
    torch.backends.mkldnn.matmul.fp32_precision = "bf16"
    try:
        with pytest.raises(sp.DeviceError, match="bf16"):
            dft.prdft_last(x, _mats(dft.r2c_mats(12)))
        with pytest.raises(sp.DeviceError, match="bf16"):
            dft.pirdft_last(x[..., :7], x[..., :7], _mats(dft.c2r_mats(12)))
        with pytest.raises(sp.DeviceError, match="fp32_precision"):
            c["tp"].backward(c["vals"])
    finally:
        torch.backends.mkldnn.matmul.fp32_precision = prev
    np.testing.assert_array_equal(c["tp"].backward(c["vals"]).numpy(),
                                  c["tb"])


def test_reduced_fp32_matmul_reads_the_cuda_setting():
    """TF32 for cuBLAS is seen without a card; the CPU's products (oneDNN)
    are not affected by it, and a distributed R2C plan on the CPU gives
    the same result as before."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    c = _case("r2c")
    assert dft.reduced_fp32_matmul(cuda) is None
    assert dft.reduced_fp32_matmul(cpu) is None
    prev = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        assert dft.reduced_fp32_matmul(cuda) == "tf32"
        assert dft.reduced_fp32_matmul(cpu) is None
        np.testing.assert_array_equal(c["tp"].backward(c["vals"]).numpy(),
                                      c["tb"])
    finally:
        torch.backends.cuda.matmul.fp32_precision = prev
    assert dft.reduced_fp32_matmul(cuda) is None
