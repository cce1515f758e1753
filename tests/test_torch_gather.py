"""The port's gather (``spfft_tpu_torch.ops.gather_kernel``, the kernel of
rows 8-9 of PERF.md's table) and ``pdft_last`` (row 7) on the CPU, where
each wrapper runs its plain version, against the JAX package on the same
inputs made from numpy seeds: the Pallas gathers in interpret mode
(``run_gather`` over narrow ``build_monotone_gather_tables`` and wide
``build_wide_gather_tables`` tables from ``compression_gather_inputs``,
as the JAX plan builds them) and the single-stage Pallas DFT kernel in
interpret mode.

Tolerances: the gather moves values and computes nothing, so it is held
exact (atol 0) in both directions, batched and unbatched, in both value
layouts. ``pdft_last`` sums f32 products in another order than the JAX
kernel's Karatsuba form: within 2e-6 of the largest value."""

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
from spfft_tpu_torch.ops import dft, dft_kernel, gather_kernel

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
