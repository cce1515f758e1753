"""The wire ladder of the port's distributed exchange on the CPU, against
the JAX package's (``spfft_tpu/parallel/exchange.py``
``quantize_blocks_int8`` / ``dequantize_blocks_int8`` and the rung
resolution of ``spfft_tpu/parallel/dist.py``); JAX on the 8 virtual CPU
devices of tests/conftest.py, with x64.

* ``ops.wire_kernel``'s plain quantize / dequantize against the JAX
  functions exactly (payload, float32 scales, dequantized values), both
  quant axes, float32 and float64 blocks, zero rows;
* ``csrc/wire.cu``'s C entries emulated in numpy through the pointers,
  strides and extents the wrappers pass (the packed views of the
  exchange, strided), against the plain versions bit for bit;
* float64 -> bfloat16 in torch rounds through float32, as the JAX
  package's conversion does (crafted double-rounding cases and random
  values), so the probe's bfloat16 error is the JAX package's float;
* the resolved rung, ``wire_probe_error`` and ``wire_declines`` equal the
  JAX plan's over a grid of exchange, precision, requested rung,
  overlap chunks and budget, from the arguments and from the
  environment; the knobs' refusals;
* the lossy rungs end to end: each side's backward against the dense
  oracle and its forward round trip, the port's error at most 1.25 times
  the JAX plan's on the same inputs and rung, and the backward's within
  the rung's fixed bound, ``max(4 * wire_probe_error,
  predicted_rel_error)``, which chip_smoke.py holds on the card; the int8
  wire bit for bit
  the same at K = 1, 2 and 4 (per-chunk scales are the monolithic ones).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.parallel import exchange as jex

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import _build, wire_kernel
from spfft_tpu_torch.parallel import dist as tdist
from spfft_tpu_torch.parallel import exchange

from test_torch_exchange import _c, _rel
from test_torch_gather import _strided
from test_util import dense_backward
from spfft_tpu.utils.workloads import (even_plane_split,
                                       round_robin_stick_partition,
                                       spherical_cutoff_triplets)

torch.set_num_threads(2)

N = 12
SHARDS = 3


# -- the quantizer ------------------------------------------------------------

def _block(shape, dtype, seed=0, span=6.0):
    """Random planar blocks with 10^±span magnitudes per (slot, row of
    both axes), a zero row and a zero plane."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-span, span, shape[:-1] + (1,))
    re = rng.standard_normal(shape) * mags
    im = rng.standard_normal(shape) * mags
    re[..., 1, :] = im[..., 1, :] = 0.0
    re[..., :, 2] = im[..., :, 2] = 0.0
    return re.astype(dtype), im.astype(dtype)


def _jax_quant(re, im, quant_axis):
    """JAX's packed layout -> (q_re, q_im, scales) in the port's layout,
    and JAX's dequantized block."""
    blocks = jnp.asarray(re + 1j * im)
    packed = np.asarray(jex.quantize_blocks_int8(blocks, quant_axis))
    s, ms, mp = re.shape
    n = ms * mp * 2
    q = packed[:, :n].reshape(s, ms, mp, 2)
    rows = ms if quant_axis == 1 else mp
    scales = packed[:, n:].copy().view(np.float32).reshape(s, rows)
    if quant_axis == 2:
        q = q.transpose(0, 2, 1, 3)
    back = np.asarray(jex.dequantize_blocks_int8(
        jnp.asarray(packed), re.shape, quant_axis, re.dtype))
    return q[..., 0], q[..., 1], scales, back


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("quant_axis", [1, 2])
def test_plain_quantizer_matches_jax_exactly(quant_axis, dtype):
    re, im = _block((4, 9, 7), dtype)
    q_re, q_im, scales = wire_kernel.quantize_plain(
        (torch.from_numpy(re)[None], torch.from_numpy(im)[None]), quant_axis)
    j_re, j_im, j_sc, back = _jax_quant(re, im, quant_axis)
    assert q_re.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q_re[0].numpy(), j_re)
    np.testing.assert_array_equal(q_im[0].numpy(), j_im)
    np.testing.assert_array_equal(scales[0].numpy(), j_sc)
    out = wire_kernel.dequantize_plain((q_re, q_im), scales, quant_axis,
                                       torch.from_numpy(re).dtype)
    assert out[0].dtype == torch.from_numpy(re).dtype
    np.testing.assert_array_equal(out[0][0].numpy() + 1j * out[1][0].numpy(),
                                  back)
    # the zero stick row (axis 1) or plane (axis 2): scale 1, payload 0
    zero = 1 if quant_axis == 1 else 2
    assert (scales[0][:, zero] == 1.0).all()
    assert not q_re[0][:, zero].any() and not q_im[0][:, zero].any()


# -- csrc/wire.cu's C entries, emulated through the wrappers' launch path ----

def emulate_quantize(args, esize):
    (re, im, g_st, s_st, r_st, e_st, groups, slots, rows, n, q_re, q_im,
     scales) = args
    ctype = ctypes.c_float if esize == 4 else ctypes.c_double
    shape = (groups, slots, rows, n)
    st = (g_st, s_st, r_st, e_st)
    x = [_strided(p, shape, st, ctype).astype(np.float32) for p in (re, im)]
    absmax = np.maximum(np.abs(x[0]).max(-1, initial=0),
                        np.abs(x[1]).max(-1, initial=0))
    scale = np.where(absmax > 0, absmax / np.float32(127), np.float32(1))
    scale = scale.astype(np.float32)
    cont = (slots * rows * n, rows * n, n, 1)
    for src, dst in zip(x, (q_re, q_im)):
        q = np.clip(np.rint(src / scale[..., None]), -127, 127)
        _strided(dst, shape, cont, ctypes.c_int8)[...] = q.astype(np.int8)
    _strided(scales, shape[:3], (slots * rows, rows, 1),
             ctypes.c_float)[...] = scale


def emulate_dequantize(args, esize):
    q_re, q_im, scales, gs, ms, mp, axis, out_re, out_im = args
    ctype = ctypes.c_float if esize == 4 else ctypes.c_double
    rows, n = (ms, mp) if axis == 1 else (mp, ms)
    sc = _strided(scales, (gs, rows), (rows, 1), ctypes.c_float)
    for q, o in ((q_re, out_re), (q_im, out_im)):
        x = _strided(q, (gs, rows, n), (rows * n, n, 1), ctypes.c_int8)
        y = (x.astype(np.float32) * sc[..., None]).astype(np.dtype(ctype))
        if axis == 2:
            y = y.transpose(0, 2, 1)
        _strided(o, (gs, ms, mp), (ms * mp, mp, 1), ctype)[...] = y


class _Emulated:
    """``wire_kernel``'s ``_build`` with the launch path taken on CPU
    tensors, each launch run by the emulations above."""
    require = staticmethod(_build.require)
    call_dtype = staticmethod(_build.call_dtype)
    entry = staticmethod(_build.entry)
    REAL_TYPES = _build.REAL_TYPES

    @staticmethod
    def on_cuda(t, what):
        return True

    @staticmethod
    def function(source, symbol, argtypes):
        assert source == "wire.cu"
        assert symbol.split("_f64")[0] in ("spfft_wire_quantize",
                                           "spfft_wire_dequantize")
        assert len(argtypes) == (14 if "quantize" in symbol
                                 and "de" not in symbol else 10)
        return symbol

    @staticmethod
    def launch(fn, what, device, *args):
        esize = 8 if fn.endswith("_f64") else 4
        if fn.startswith("spfft_wire_quantize"):
            emulate_quantize(args, esize)
        else:
            emulate_dequantize(args, esize)


@pytest.fixture
def emulated_wire(monkeypatch):
    monkeypatch.setattr(wire_kernel, "_build", _Emulated)
    for w in (wire_kernel.quantize, wire_kernel.dequantize):
        monkeypatch.setattr(w, "launches", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quant_axis", [1, 2])
def test_wire_cu_launch_path_matches_plain(emulated_wire, quant_axis, dtype):
    """Both entries on the exchange's packed views (a transposed
    ``(G, S, ms, mp)`` view, as the backward and forward packs make
    them), bit for bit the plain versions, one launch each."""
    re, im = (torch.from_numpy(a).to(dtype) for a in _block((6, 4, 9, 5),
                                                            np.float64))
    views = (re.transpose(-3, -2).contiguous().transpose(-3, -2),
             im.transpose(-3, -2).contiguous().transpose(-3, -2))
    if quant_axis == 2:  # rows contiguous over sticks, as the forward pack
        views = tuple(t.transpose(-1, -2).contiguous().transpose(-1, -2)
                      for t in views)
    got = wire_kernel.quantize(views, quant_axis)
    want = wire_kernel.quantize_plain(views, quant_axis)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    out = wire_kernel.dequantize(got[:2], got[2], quant_axis, dtype)
    ref = wire_kernel.dequantize_plain(want[:2], want[2], quant_axis, dtype)
    for g, w in zip(out, ref):
        assert g.is_contiguous() and torch.equal(g, w)
    assert wire_kernel.quantize.launches == 1
    assert wire_kernel.dequantize.launches == 1


def test_int8_block_exchange_through_the_launch_path(emulated_wire):
    """``exchange.move_blocks`` on the int8 wire (both quant axes, the
    transposing copy and the ring) equals the plain quantize, the move
    and the plain dequantize."""
    re, im = (torch.from_numpy(a) for a in _block((2, 3, 3, 5, 4),
                                                  np.float32, seed=3))
    for axis in (1, 2):
        for ring in (False, True):
            got = exchange.move_blocks((re, im), torch.int8, axis,
                                       torch.float32, ring=ring)
            q = wire_kernel.quantize_plain(
                (re.reshape(-1, 3, 5, 4), im.reshape(-1, 3, 5, 4)), axis)
            back = wire_kernel.dequantize_plain(q[:2], q[2], axis,
                                                torch.float32)
            for g, b in zip(got, back):
                want = exchange.all_to_all_blocks(b.view(2, 3, 3, 5, 4), 2)
                assert torch.equal(g, want)


# -- bfloat16 from float64 ----------------------------------------------------

def test_bfloat16_from_float64_rounds_like_jax():
    """torch rounds float64 -> bfloat16 through float32 (twice), as
    ml_dtypes and the JAX package's conversion do: 1 + 2^-8 + 2^-40 lies
    above the bfloat16 halfway point but rounds to it in float32, then
    to even."""
    crafted = np.array([1 + 2.0 ** -8 + 2.0 ** -40, 1 + 2.0 ** -8 - 2.0 ** -40,
                        1 + 3 * 2.0 ** -8 + 2.0 ** -30, -(1 + 2.0 ** -8
                                                         + 2.0 ** -40)])
    rng = np.random.default_rng(2)
    rand = rng.standard_normal(100_000) * 10.0 ** rng.uniform(-6, 6, 100_000)
    for x in (crafted, rand):
        got = torch.from_numpy(x).to(torch.bfloat16).to(torch.float64)
        np.testing.assert_array_equal(
            got.numpy(), x.astype(ml_dtypes.bfloat16).astype(np.float64))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float64)))
    assert torch.tensor(crafted[0]).to(torch.bfloat16).item() == 1.0


# -- the rung resolution ------------------------------------------------------

def _sphere(n=N, shards=SHARDS, span=4.0, seed=0xA11):
    tr = spherical_cutoff_triplets(n)
    parts = round_robin_stick_partition(tr, (n, n, n), shards)
    rng = np.random.default_rng(seed)
    vals = []
    for p in parts:
        m = 10.0 ** rng.uniform(-span, span, size=len(p))
        vals.append((rng.uniform(-1, 1, len(p))
                     + 1j * rng.uniform(-1, 1, len(p))) * m)
    return parts, even_plane_split(n, shards), vals


def _both(parts, planes, exchange="DEFAULT", precision="single", **kw):
    jp = jpar.make_distributed_plan(
        spfft_tpu.TransformType.C2C, N, N, N, parts, planes,
        mesh=jpar.make_mesh(len(parts)), precision=precision,
        exchange=spfft_tpu.ExchangeType[exchange], **kw)
    tp = sp.make_distributed_plan(
        sp.TransformType.C2C, N, N, N, parts, planes, device="cpu",
        precision=precision, exchange=sp.ExchangeType[exchange], **kw)
    return jp, tp


def _same_rung(jp, tp):
    assert tp.wire_rung == jp.wire_rung
    assert tp.wire_rung_name == jp.wire_rung_name
    assert tp.wire_rung_requested == jp.wire_rung_requested
    assert tp.wire_error_budget == jp.wire_error_budget
    assert tp.wire_probe_error == jp.wire_probe_error  # the same float
    assert tp.wire_declines == jp.wire_declines


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("exchange_name", [
    "DEFAULT", "BUFFERED_FLOAT", "COMPACT_BUFFERED",
    "COMPACT_BUFFERED_FLOAT", "UNBUFFERED"])
def test_rung_resolution_matches_jax(exchange_name, precision):
    parts, planes, _ = _sphere()
    assert tdist.WIRE_RUNGS == ("full", "f32", "bf16", "int8")
    for budget in (1e-7, 1e-3, 0.01, 1.0):
        for rung in range(4):
            for k in ((1, 2) if rung == 3 else (1,)):
                jp, tp = _both(parts, planes, exchange_name, precision,
                               wire_precision=rung, wire_error_budget=budget,
                               overlap_chunks=k)
                _same_rung(jp, tp)


def test_wire_knobs_from_the_environment_and_refusals(monkeypatch):
    parts, planes, _ = _sphere()
    # the defaults are the process-global config's knobs, the JAX package's
    from spfft_tpu_torch.control import global_config
    assert (global_config().wire_precision,
            global_config().wire_error_budget) == (0, 0.01)
    jp, tp = _both(parts, planes)
    _same_rung(jp, tp)
    assert tp.wire_rung_name == "full" and tp.wire_error_budget == 0.01
    monkeypatch.setenv(tdist.WIRE_PRECISION_ENV, "3")
    monkeypatch.setenv(tdist.WIRE_ERROR_BUDGET_ENV, "0.5")
    jp, tp = _both(parts, planes)
    _same_rung(jp, tp)
    assert tp.wire_rung_name == "int8" and tp.wire_error_budget == 0.5
    jp, tp = _both(parts, planes, wire_precision=2, wire_error_budget=1e-9)
    _same_rung(jp, tp)
    assert tp.wire_declines == (("bf16", "over_budget"),)
    for kw in ({"wire_precision": 4}, {"wire_precision": -1},
               {"wire_error_budget": 0.0}, {"wire_error_budget": -1.0}):
        with pytest.raises(sp.InvalidParameterError, match="wire_"):
            sp.make_distributed_plan(sp.TransformType.C2C, N, N, N, parts,
                                     planes, device="cpu", **kw)
        with pytest.raises(spfft_tpu.InvalidParameterError):
            _both(parts, planes, **kw)


# -- the lossy rungs end to end -----------------------------------------------

LOSSY = {
    "bf16": ("DEFAULT", "single", 2, 1),
    "int8": ("DEFAULT", "single", 3, 1),
    "int8_k2": ("DEFAULT", "single", 3, 2),
    "ring_int8": ("UNBUFFERED", "single", 3, 1),
    "ragged_bf16": ("COMPACT_BUFFERED", "single", 2, 1),
    "ragged_float_k2": ("COMPACT_BUFFERED_FLOAT", "single", 0, 2),
    "buffered_float": ("BUFFERED_FLOAT", "single", 0, 1),
    "double_f32": ("DEFAULT", "double", 1, 1),
    "double_compact_float": ("COMPACT_BUFFERED_FLOAT", "double", 0, 1),
}


@pytest.mark.parametrize("case", sorted(LOSSY))
def test_lossy_rungs_against_the_oracle(case):
    """Backward against the dense complex128 oracle, and the forward(FULL)
    of the oracle's space against the values: the port's error at most
    1.25 times the JAX plan's (plus the precision's floor)."""
    name, precision, rung, k = LOSSY[case]
    parts, planes, vals = _sphere()
    cdt = np.complex64 if precision == "single" else np.complex128
    vals = [v.astype(cdt) for v in vals]
    jp, tp = _both(parts, planes, name, precision, wire_precision=rung,
                   wire_error_budget=1.0, overlap_chunks=k)
    _same_rung(jp, tp)
    assert tp.wire_rung > 0
    cube = np.zeros((N, N, N), np.complex128)
    for p, v in zip(parts, vals):
        st = np.where(p < 0, p + N, p)
        cube[st[:, 2], st[:, 1], st[:, 0]] = v
    oracle = dense_backward(cube)
    floor = sp.predicted_rel_error(precision, N, True)

    def bwd_err(plan, space):
        return _rel(np.concatenate(plan.unshard_space(space)), oracle)

    tb, jb = tp.backward(vals), np.asarray(jp.backward(vals))
    assert bwd_err(tp, tb) <= 1.25 * bwd_err(jp, jb) + floor
    # the rung's fixed bound, which chip_smoke.py holds on the card too:
    # 4 times the plan's probe error (the JAX package's own test bound)
    assert bwd_err(tp, tb) <= max(4 * tp.wire_probe_error, floor)
    slabs = [oracle[o:o + n] for o, n in zip(
        np.concatenate([[0], np.cumsum(planes)[:-1]]), planes)]
    tf = tp.forward(slabs, sp.Scaling.FULL)
    jf = jp.forward(jp.shard_space(slabs), spfft_tpu.Scaling.FULL)
    want = tp.shard_values(vals).numpy()
    assert _rel(_c(tf.numpy()), _c(want)) <= \
        1.25 * _rel(_c(np.asarray(jf)), _c(want)) + floor


def test_int8_wire_is_the_same_at_every_k():
    """Chunks slice the quant rows, so the per-chunk scales are the
    monolithic ones: K = 1, 2 and 4 give the same backward and forward
    bit for bit, and the same wire bytes (scales conserved)."""
    parts, planes, vals = _sphere()
    vals = [v.astype(np.complex64) for v in vals]
    plans = [sp.make_distributed_plan(
        sp.TransformType.C2C, N, N, N, parts, planes, device="cpu",
        overlap_chunks=k, wire_precision=3, wire_error_budget=1.0)
        for k in (1, 2, 4)]
    assert [p.wire_rung_name for p in plans] == ["int8"] * 3
    assert [p.overlap_chunks for p in plans] == [1, 2, 4]
    b = [p.backward(vals) for p in plans]
    f = [p.forward(b[0], sp.Scaling.FULL) for p in plans]
    for i in (1, 2):
        assert torch.equal(b[i], b[0]) and torch.equal(f[i], f[0])
        for fwd in (False, True):
            assert plans[i].exchange_wire_bytes(fwd) == \
                plans[0].exchange_wire_bytes(fwd)
    dp = plans[0].dist_plan
    links = SHARDS * (SHARDS - 1)
    assert plans[0].exchange_wire_bytes() == \
        links * (dp.max_sticks * dp.max_planes * 2 + dp.max_sticks * 4)
    assert plans[0].exchange_wire_bytes(True) == \
        links * (dp.max_sticks * dp.max_planes * 2 + dp.max_planes * 4)
