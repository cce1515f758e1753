"""The port's gather (``spfft_tpu_torch.ops.gather_kernel``, the kernel of
rows 8-9 of PERF.md's table) and ``pdft_last`` (row 7) on the CPU, where
each wrapper runs its plain version, against the JAX package on the same
inputs made from numpy seeds: the Pallas gathers in interpret mode
(``run_gather`` over narrow ``build_monotone_gather_tables`` and wide
``build_wide_gather_tables`` tables from ``compression_gather_inputs``,
as the JAX plan builds them) and the single-stage Pallas DFT kernel in
interpret mode.

The gather's shard axis: stacked per-shard tables, padded to the largest
shard as the distributed plan stacks them (uneven shards, an empty one),
against the JAX gathers run shard by shard; and the wrapper's launch
path, with ``csrc/gather.cu``'s C entry replaced by a numpy emulation
that reads and writes the operands through the pointers, strides and
extents the wrapper passes and checks that every wide access the layout
word allows is aligned (ragged ends, views off by one float, both
values layouts).

Tolerances: the gather moves values and computes nothing, so it is held
exact (atol 0) in both directions, batched and unbatched, in both value
layouts. ``pdft_last`` sums f32 products in another order than the JAX
kernel's Karatsuba form: within 2e-6 of the largest value."""

import ctypes
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import dft_kernel as jdk
from spfft_tpu.ops import gather_kernel as jgk

from spfft_tpu_torch.errors import DeviceError, InvalidParameterError
from spfft_tpu_torch.indexing import inverse_slot_map
from spfft_tpu_torch.ops import _build, dft, dft_kernel, gather_kernel

torch.set_num_threads(2)

TOL = 2e-6
S, DZ, B = 64, 16, 3


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _slots():
    """Occupied slots of S sticks x DZ (every fifth stick empty) in a
    shuffled value order, with duplicated triplets: the forms the JAX
    table builders and the port's inverse map must agree on."""
    rng = np.random.default_rng(3)
    occ = rng.random(S * DZ) < 0.5
    occ.reshape(S, DZ)[::5] = False
    vi = np.flatnonzero(occ)
    vi = np.concatenate([vi, vi[:7]])
    blocks = np.array_split(vi, 12)
    order = rng.permutation(len(blocks))
    return np.concatenate([blocks[i] for i in order])


@functools.lru_cache(maxsize=None)
def _jax_gather(kind: str, direction: str):
    """(source, idx, valid, want): the batched source ``(B, n, 2)``, the
    JAX tables' (idx, valid) and the interpret-mode Pallas gather's
    output ``(B, num_out, 2)``."""
    vi = _slots()
    nv, ns = len(vi), S * DZ
    (dec_idx, occupied), (cmp_idx, cmp_valid) = \
        jgk.compression_gather_inputs(vi, ns)
    idx, valid, n_src = ((dec_idx, occupied, nv) if direction == "dec"
                         else (cmp_idx, cmp_valid, ns))
    build = {"narrow": jgk.build_monotone_gather_tables,
             "wide": jgk.build_wide_gather_tables}[kind]
    t = build(idx, valid, n_src)
    assert t is not None and not t.segs
    src = np.random.default_rng(len(direction) + len(kind)) \
        .standard_normal((B, n_src, 2)).astype(np.float32)
    re, im = jgk.planar_from_interleaved(jnp.asarray(src), t.src_rows)
    out_re, out_im = jgk.run_gather(re, im, jgk.gather_device_tables(t), t,
                                    interpret=True)
    want = np.asarray(jgk.interleaved_from_planar(out_re, out_im, t.num_out))
    return src, idx, valid, want


def _layout(a, pair):
    """Interleaved ``(..., n, 2)`` numpy -> the port's layout."""
    return _t(np.swapaxes(a, -1, -2) if pair else a)


def _rows(out, pair):
    """The port's value layout -> interleaved rows, numpy."""
    return (out.transpose(-1, -2) if pair else out).numpy()


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("batch", [None, B])
@pytest.mark.parametrize("pair", [False, True])
def test_decompress_matches_jax_interpret(kind, batch, pair):
    """Values -> sticks: the port's sentinel map ``slot_src`` against the
    JAX tables' forward-filled ``(idx, occupied)``; the wrapper (plain
    version on the CPU) and its independent twin both exact."""
    src, _, _, want = _jax_gather(kind, "dec")
    vi = _slots()
    ss = _t(np.concatenate([inverse_slot_map(vi, S * DZ, len(vi)),
                            np.full(DZ, len(vi), np.int32)]))
    sel = slice(None) if batch else 0
    v = _layout(src[sel], pair)
    for sr, si in (gather_kernel.decompress(v, ss, DZ, pair),
                   gather_kernel.decompress_plain(v, ss, DZ, pair)):
        lead = (B,) if batch else ()
        assert tuple(sr.shape) == lead + (S + 1, DZ)
        got = np.stack([sr.numpy(), si.numpy()], axis=-1)
        np.testing.assert_array_equal(got[..., :S, :, :].reshape(
            lead + (S * DZ, 2)), want[sel])
        assert not got[..., S, :, :].any()  # the sentinel stick


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("batch", [None, B])
@pytest.mark.parametrize("pair", [False, True])
def test_compress_matches_jax_interpret(kind, batch, pair):
    """Sticks -> values through ``value_indices`` (every duplicate gets
    its value)."""
    src, _, _, want = _jax_gather(kind, "cmp")
    vi = _t(_slots().astype(np.int32))
    sel = slice(None) if batch else 0
    sticks = src[sel].reshape(src[sel].shape[:-2] + (S, DZ, 2))
    sr, si = _t(sticks[..., 0]), _t(sticks[..., 1])
    for out in (gather_kernel.compress(sr, si, vi, pair),
                gather_kernel.compress_plain(sr, si, vi, pair)):
        np.testing.assert_array_equal(_rows(out, pair), want[sel])


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("direction", ["dec", "cmp"])
def test_gather_with_mask_matches_jax_interpret(kind, direction):
    """The general form ``out[b, j] = valid[j] ? src[b, idx[j]] : 0`` on
    the JAX tables' own (idx, valid), strided interleaved planes."""
    src, idx, valid, want = _jax_gather(kind, direction)
    s = _t(src)
    out = torch.empty((B, len(idx), 2))
    gather_kernel.gather((s[..., 0], s[..., 1]), _t(idx.astype(np.int32)),
                         (out[..., 0], out[..., 1]), _t(valid))
    np.testing.assert_array_equal(out.numpy(), want)


def test_gather_sentinels_and_out_of_range_give_zero():
    rng = np.random.default_rng(5)
    src = rng.standard_normal((2, 10)).astype(np.float32)
    idx = np.array([0, 10, -1, 9, 3, 12, 3], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 1, 1], bool)
    out = tuple(torch.full((2, 7), np.nan) for _ in range(2))
    gather_kernel.gather((_t(src), _t(-src)), _t(idx), out, _t(valid))
    want = np.zeros((2, 7), np.float32)
    for j, i in enumerate(idx):
        if 0 <= i < 10 and valid[j]:
            want[:, j] = src[:, i]
    np.testing.assert_array_equal(out[0].numpy(), want)
    np.testing.assert_array_equal(out[1].numpy(), -want)


def test_gather_wrapper_checks_operands():
    src = (torch.zeros((2, 8)), torch.zeros((2, 8)))
    out = (torch.zeros((2, 4)), torch.zeros((2, 4)))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(InvalidParameterError, match="int32"):
        gather_kernel.gather(src, idx.long(), out)
    with pytest.raises(InvalidParameterError, match="float32"):
        gather_kernel.gather((src[0].double(), src[1]), idx, out)
    with pytest.raises(InvalidParameterError, match="shape"):
        gather_kernel.gather(src, idx, (torch.zeros((3, 4)),) * 2)
    with pytest.raises(InvalidParameterError, match="differ"):
        gather_kernel.gather((src[0], torch.zeros((8, 2)).t()), idx, out)
    with pytest.raises(InvalidParameterError, match="bool"):
        gather_kernel.gather(src, idx, out, torch.ones(4, dtype=torch.int32))
    with pytest.raises(InvalidParameterError, match="whole sticks"):
        gather_kernel.decompress(torch.zeros((3, 2)), idx[:3], 2)
    meta = (torch.zeros((2, 8), device="meta"),) * 2
    with pytest.raises(DeviceError):
        gather_kernel.gather(meta, idx.to("meta"),
                             (torch.zeros((2, 4), device="meta"),) * 2)


# -- the shard axis -----------------------------------------------------------

#: sticks per shard: uneven, one shard empty; max_sticks is the largest
SHARD_STICKS = (24, 0, 9)


@functools.lru_cache(maxsize=None)
def _shards():
    """Per-shard value_indices over each shard's own sticks (DZ slots a
    stick, about half occupied, duplicates, shuffled blocks) and the
    stacked tables the distributed plan builds from them: slot_src ``(S,
    max_sticks * DZ)`` with sentinel ``max_values``, value_indices ``(S,
    max_values)`` padded with ``max_sticks * DZ``."""
    rng = np.random.default_rng(11)
    vis = []
    for k in SHARD_STICKS:
        vi = np.flatnonzero(rng.random(k * DZ) < 0.5)
        vi = np.concatenate([vi, vi[:3]])
        blocks = np.array_split(vi, 5) if len(vi) else [vi]
        vis.append(np.concatenate([blocks[j]
                                   for j in rng.permutation(len(blocks))]))
    ms, mv = max(SHARD_STICKS), max(len(v) for v in vis)
    slot_src = np.full((len(vis), ms * DZ), mv, np.int32)
    vi_pad = np.full((len(vis), mv), ms * DZ, np.int32)
    for r, (vi, k) in enumerate(zip(vis, SHARD_STICKS)):
        ss = inverse_slot_map(vi, k * DZ, len(vi))
        slot_src[r, :k * DZ] = np.where(ss == len(vi), mv, ss)
        vi_pad[r, :len(vi)] = vi
    return vis, slot_src, vi_pad


@functools.lru_cache(maxsize=None)
def _jax_shards(kind: str, direction: str):
    """(source, want): the stacked batched source ``(S, B, n, 2)`` (a
    shard's padding rows random too) and, per shard, the interpret-mode
    Pallas gather on that shard's tables from ``compression_gather_inputs``
    padded to ``max_values`` as the JAX distributed plan builds them,
    ``(S, B, num_out, 2)``; an empty shard's JAX tables do not exist, and
    its output is zeros."""
    vis, slot_src, vi_pad = _shards()
    ms, mv = max(SHARD_STICKS), vi_pad.shape[1]
    n_src, num_out = (mv, ms * DZ) if direction == "dec" else (ms * DZ, mv)
    src = np.random.default_rng(len(kind) + 7 * len(direction)) \
        .standard_normal((len(vis), B, n_src, 2)).astype(np.float32)
    build = {"narrow": jgk.build_monotone_gather_tables,
             "wide": jgk.build_wide_gather_tables}[kind]
    want = np.zeros((len(vis), B, num_out, 2), np.float32)
    for r, vi in enumerate(vis):
        if not len(vi):
            continue
        dec, cmp = jgk.compression_gather_inputs(vi, ms * DZ,
                                                 pad_values_to=mv)
        idx, valid = dec if direction == "dec" else cmp
        t = build(idx, valid, n_src)
        assert t is not None and not t.segs
        re, im = jgk.planar_from_interleaved(jnp.asarray(src[r]), t.src_rows)
        out_re, out_im = jgk.run_gather(re, im, jgk.gather_device_tables(t),
                                        t, interpret=True)
        want[r] = np.asarray(jgk.interleaved_from_planar(out_re, out_im,
                                                         t.num_out))
    return src, want


def _view(ptr, count, ctype):
    """A writable numpy view of ``count`` items at a CPU address."""
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _strided(ptr, shape, strides, ctype=ctypes.c_float):
    """The numpy view that a kernel reads at ``ptr`` with element
    ``strides`` (an empty shape gives an empty array)."""
    if 0 in shape:
        return np.zeros(shape, np.dtype(ctype))
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    base = _view(ptr, span, ctype)
    return np.lib.stride_tricks.as_strided(
        base, shape, [st * base.itemsize for st in strides])


def _assert_aligned(addrs, align, what):
    addrs = np.asarray(addrs, np.int64)
    assert (addrs % align == 0).all(), f"{what}: a wide access off {align}"


def emulate_gather(args, esize=4):
    """numpy stand-in for csrc/gather.cu's ``spfft_gather`` (``esize`` 4)
    and ``spfft_gather_f64`` (``esize`` 8): computes the function through
    the raw pointers, strides and extents, and checks that each wide
    access the layout word allows is aligned for every whole group of 4
    slots: a pair load or an interleaved double store on its 2 ``esize``
    bytes, a planar group's stores and an interleaved float group's
    float4s from 16 bytes (or the float row's first 8)."""
    (sre, sim, se, sb, ss, n, idx, isst, valid, vsst, ore, oim, oe, ob, os_,
     num_out, batch, shards, layout) = args
    gk = gather_kernel
    ctype = ctypes.c_float if esize == 4 else ctypes.c_double
    real = np.dtype(ctype)
    j0 = np.arange(num_out // 4) * 4  # every whole group
    s = np.arange(shards)[:, None, None]
    b = np.arange(batch)[None, :, None]
    if layout & gk.IDX_VEC:
        _assert_aligned(idx + 4 * (s[:, 0] * isst + j0), 16, "idx")
    if layout & gk.VALID_VEC:
        _assert_aligned(valid + s[:, 0] * vsst + j0, 4, "valid")
    if layout & gk.OUT_PLANAR:
        assert oe == 1
        for base in (ore, oim):
            _assert_aligned(base + esize * (s * os_ + b * ob + j0), 16,
                            "out")
    if layout & gk.OUT_PAIR:  # float4s from the row's first 16 bytes, or
        assert oe == 2 and oim == ore + esize  # one double2 a slot
        _assert_aligned(ore + esize * (s * os_ + b * ob + 2 * j0),
                        2 * esize, "out")
    i = _strided(idx, (shards, num_out), (isst, 1), ctypes.c_int) \
        .astype(np.int64)
    ok = (i >= 0) & (i < n)
    if valid is not None:
        ok &= _strided(valid, (shards, num_out), (vsst, 1),
                       ctypes.c_ubyte) != 0
    if layout & gk.SRC_PAIR:
        assert se == 2 and sim == sre + esize
        _assert_aligned(sre + esize * (s * ss + b * sb + 2 * np.where(
            ok, i, 0)[:, None]), 2 * esize, "source")
    take = np.broadcast_to(np.where(ok, i, 0)[:, None], (shards, batch,
                                                         num_out))
    for src_ptr, out_ptr in ((sre, ore), (sim, oim)):
        src = _strided(src_ptr, (shards, batch, n), (ss, sb, se), ctype)
        got = np.take_along_axis(src, take, 2) if n else \
            np.zeros(take.shape, real)
        _strided(out_ptr, (shards, batch, num_out), (os_, ob, oe),
                 ctype)[...] = np.where(ok[:, None], got, real.type(0))


class _Emulated:
    """``gather_kernel``'s ``_build`` with the launch path taken on CPU
    tensors, each launch run by :func:`emulate_gather`; ``calls`` holds
    each launch's layout word."""
    require = staticmethod(_build.require)
    call_dtype = staticmethod(_build.call_dtype)
    entry = staticmethod(_build.entry)
    REAL_TYPES = _build.REAL_TYPES
    calls = []

    @staticmethod
    def on_cuda(t, what):
        return True

    @staticmethod
    def function(source, symbol, argtypes):
        assert source == "gather.cu"
        assert symbol in ("spfft_gather", "spfft_gather_f64")
        assert len(argtypes) == 20  # the operands, then the stream
        return symbol

    @classmethod
    def launch(cls, fn, what, device, *args):
        cls.calls.append(args[-1])
        emulate_gather(args, 8 if fn.endswith("_f64") else 4)


@pytest.fixture
def emulated_gather(monkeypatch):
    """The gather wrapper takes its launch path on CPU tensors (only the
    gather: the other wrappers keep their plain versions); yields the
    list of the layout words of its launches."""
    monkeypatch.setattr(gather_kernel, "_build", _Emulated)
    monkeypatch.setattr(_Emulated, "calls", [])
    monkeypatch.setattr(gather_kernel.gather, "launches", 0)
    yield _Emulated.calls


def _planes(a):
    """The (re, im) views of an interleaved ``(..., n, 2)`` tensor."""
    return a[..., 0], a[..., 1]


@pytest.mark.parametrize("launch", ["plain", "emulated"])
@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("direction", ["dec", "cmp"])
def test_shard_gather_matches_jax_per_shard(request, launch, kind,
                                            direction):
    """The stacked, padded per-shard tables in one call (the plain
    version, or the launch path through the emulated C entry) against
    the JAX gathers run shard by shard: every shard's slots exact, its
    padding slots 0, whatever the padding rows of its source hold: the
    padding indices lie at or past the source's extent."""
    calls = request.getfixturevalue("emulated_gather") \
        if launch == "emulated" else None
    vis, slot_src, vi_pad = _shards()
    src, want = _jax_shards(kind, direction)
    ms, dz = max(SHARD_STICKS), DZ
    idx = slot_src if direction == "dec" else vi_pad
    s = _t(src)
    out = torch.full(want.shape, np.nan, dtype=torch.float32)
    gather_kernel.gather(_planes(s), _t(idx), _planes(out))
    np.testing.assert_array_equal(out.numpy(), want)
    if direction == "cmp":
        for r, vi in enumerate(vis):  # the padding value slots
            assert not out[r, :, len(vi):].any()
    if launch == "emulated":
        assert gather_kernel.gather.launches == 1 and len(calls) == 1
        gk = gather_kernel  # index rows of whole 16-byte units are wide
        assert calls[0] == gk.SRC_PAIR | gk.OUT_PAIR \
            | (gk.IDX_VEC if idx.shape[1] % 4 == 0 else 0)
    assert ms * dz == slot_src.shape[1]


def _offset(shape, off, rng):
    """A float32 view of ``shape`` starting ``off`` floats into a buffer
    (off = 1: no view of it is 8- or 16-byte aligned)."""
    buf = torch.as_tensor(rng.standard_normal(int(np.prod(shape)) + 4),
                          dtype=torch.float32)
    return buf[off:off + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("num_out", [1, 3, 5, 13, 37])
@pytest.mark.parametrize("shards, batch", [(3, 5), (1, 1)])
@pytest.mark.parametrize("off", [0, 1])
def test_launch_path_ragged_and_unaligned(emulated_gather, num_out, shards,
                                          batch, off):
    """num_out not a multiple of 4, and views one float off any
    alignment, through the emulated C entry against the plain version:
    S = 3 shards of B = 5 bands (two batch chunks, the second ragged) or
    one shard of B = 1, interleaved and planar values, a mask and
    out-of-range indices."""
    rng = np.random.default_rng(num_out + 10 * shards + off)
    gk = gather_kernel
    n = 11
    idx = _t(rng.integers(-2, n + 3, shards * num_out + 1).astype(
        np.int32))[off:off + shards * num_out].view(shards, num_out)
    valid = _t(rng.random(shards * num_out + 1) < 0.8)[
        off:off + shards * num_out].view(shards, num_out)
    for pair_src in (True, False):
        if pair_src:
            src = _planes(_offset((shards, batch, n, 2), off, rng))
        else:
            both = _offset((shards, batch, 2, n), off, rng)
            src = both[:, :, 0], both[:, :, 1]
        outs = {}
        for how in ("kernel", "plain"):
            if pair_src:  # the planar pair: im num_out floats on
                po = _offset((shards, batch, 2, num_out), off, rng)
                o = po[:, :, 0], po[:, :, 1]
            else:
                o = _planes(_offset((shards, batch, num_out, 2), off, rng))
            for t in o:
                t.fill_(np.nan)
            if how == "kernel":
                gk.gather(src, idx, o, valid)
            else:
                gk.gather_plain(src, idx, o, valid)
            outs[how] = o
        for g, w in zip(outs["kernel"], outs["plain"]):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    if off:  # nothing aligned: every access takes the scalar path
        assert emulated_gather == [0] * 2
    else:  # interleaved (S, B, 11, 2) values: even strides, float2 reads
        assert [lay & gk.SRC_PAIR for lay in emulated_gather] == \
            [gk.SRC_PAIR, 0]


def test_layout_word_of_the_plans_operands(emulated_gather):
    """The wide accesses of the plan's layouts, as the wrapper's launch
    passes them: interleaved values are float2 pairs, contiguous sticks
    and planar-pair planes take float4 stores, interleaved outputs float4
    pairs; a 2-D table whose rows are not whole 16-byte units, or a view
    off by one float, takes none."""
    gk = gather_kernel

    def word(src, idx, valid, out):
        gk.gather(src, idx, out, valid)
        return emulated_gather[-1]

    vals = torch.zeros((3, 2, 40, 2))
    sticks = torch.zeros((2, 3, 48)).transpose(0, 1)
    idx = torch.zeros((3, 48), dtype=torch.int32)
    assert word(_planes(vals), idx, None, (sticks, sticks)) == \
        gk.IDX_VEC | gk.SRC_PAIR | gk.OUT_PLANAR
    vi = torch.zeros((3, 40), dtype=torch.int32)
    valid = torch.ones((3, 40), dtype=torch.bool)
    assert word((sticks, sticks), vi, valid, _planes(vals)) == \
        gk.IDX_VEC | gk.VALID_VEC | gk.OUT_PAIR
    pair = torch.zeros((1, 3, 2, 40))
    planes = pair[:, :, 0], pair[:, :, 1]
    assert word(planes, vi[:1], None, planes) == gk.IDX_VEC | gk.OUT_PLANAR
    ragged = torch.zeros((3, 42), dtype=torch.int32)
    assert not word(_planes(vals), ragged, None,
                    _planes(torch.zeros((3, 2, 42, 2)))) & gk.IDX_VEC
    off = torch.zeros(3 * 2 * 40 * 2 + 1)[1:].view(3, 2, 40, 2)
    vi_off = torch.zeros(3 * 40 + 1, dtype=torch.int32)[1:].view(3, 40)
    assert word(_planes(off), vi_off, None, _planes(off)) == 0


def test_shard_gather_wrapper_checks_operands():
    """Typed errors on a shard-axis mismatch: the planes' strides, the
    tables' shape against the shards, devices."""
    src = (torch.zeros((2, 3, 8)), torch.zeros((2, 3, 8)))
    out = (torch.zeros((2, 3, 4)), torch.zeros((2, 3, 4)))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    gk = gather_kernel
    with pytest.raises(InvalidParameterError, match="shape"):
        gk.gather(src, torch.zeros((3, 4), dtype=torch.int32), out)
    with pytest.raises(InvalidParameterError, match="shape"):
        gk.gather(src, idx, (torch.zeros((1, 3, 4)),) * 2)
    with pytest.raises(InvalidParameterError, match="differ"):
        gk.gather((src[0], torch.zeros((3, 2, 8)).transpose(0, 1)), idx,
                  out)
    with pytest.raises(InvalidParameterError, match="differ"):
        gk.gather(src, idx, (out[0], torch.zeros((3, 2, 4)).transpose(0, 1)))
    with pytest.raises(InvalidParameterError, match="shards, batch, n"):
        gk.gather((src[0][0], src[1][0]), idx, out)
    with pytest.raises(InvalidParameterError, match="shape"):
        gk.gather(src, idx, out, torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(InvalidParameterError, match="on cpu"):
        gk.gather(src, idx.to("meta"), out)
    with pytest.raises(InvalidParameterError, match="on cpu"):
        gk.gather(src, idx, out, torch.ones((2, 4), dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(InvalidParameterError, match="contiguous rows"):
        gk.gather(src, torch.zeros((4, 2), dtype=torch.int32).t(), out)
    with pytest.raises(InvalidParameterError, match="num_out"):
        gk.gather(src, torch.zeros((2, 2, 4), dtype=torch.int32), out)
    meta = tuple(t.to("meta") for t in src)
    with pytest.raises(DeviceError):
        gk.gather(meta, idx.to("meta"), tuple(t.to("meta") for t in out))


# -- pdft_last -----------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("case", [
    ((37,), 12, "c2c"),
    ((130,), 13, "c2c"),
    ((3, 5), 16, "c2c"),
    ((33,), 5, "rows"),     # K = 5 rows of a 12-point inverse
    ((20,), 16, "cols"),    # N = 6 columns of a 16-point forward
])
def test_pdft_last_matches_jax_interpret(case):
    lead, k, kind = case
    if kind == "rows":
        mats = jdft.sub_rows_mats(12, jdft.BACKWARD, (0, 2, 3, 7, 11))
    elif kind == "cols":
        mats = jdft.sub_cols_mats(k, jdft.FORWARD, (0, 1, 2, 13, 14, 15))
    else:
        mats = jdft.c2c_mats(k, jdft.BACKWARD, 1.0 / k)
    xr, xi = _rand(lead + (k,), k), _rand(lead + (k,), k + 1)
    wr, wi = jdk.pdft_last(jnp.asarray(xr), jnp.asarray(xi), mats,
                           interpret=True)
    got = dft_kernel.pdft_last(_t(xr), _t(xi),
                               dft.device_mats(mats[:2], "cpu"))
    want = np.stack([np.asarray(wr), np.asarray(wi)])
    assert got[0].shape == wr.shape
    err = np.abs(np.stack([got[0].numpy(), got[1].numpy()]) - want).max()
    assert err <= TOL * np.abs(want).max()


def test_pdft_last_wrapper_checks_operands():
    m = dft.device_mats(jdft.c2c_mats(8, jdft.FORWARD)[:2], "cpu")
    x = torch.zeros((4, 8))
    with pytest.raises(InvalidParameterError, match="float32"):
        dft_kernel.pdft_last(x.double(), x, m)
    with pytest.raises(InvalidParameterError, match="shape"):
        dft_kernel.pdft_last(x, torch.zeros((4, 7)), m)
    with pytest.raises(InvalidParameterError, match="shape"):
        dft_kernel.pdft_last(torch.zeros((4, 7)), torch.zeros((4, 7)), m)
    with pytest.raises(InvalidParameterError, match="contiguous"):
        dft_kernel.pdft_last(torch.zeros((8, 8)).t(), torch.zeros((8, 8)), m)
    meta = dft.device_mats(jdft.c2c_mats(8, jdft.FORWARD)[:2], "meta")
    xm = torch.zeros((4, 8), device="meta")
    with pytest.raises(DeviceError):
        dft_kernel.pdft_last(xm, xm, meta)
