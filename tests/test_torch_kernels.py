"""The port's kernel wrappers on the CPU, where each runs its plain
PyTorch version, against the JAX package on the same inputs: the Pallas
kernels in interpret mode (as tests/test_fused_kernel.py and
tests/test_dft_kernel.py run them) at one small shape, and the XLA
compositions they replace at a few shapes. The CUDA kernels themselves
are held to these plain versions on the card by chip_smoke.py.

Tolerance: rtol = atol = 2e-6 (relative l2 for the DFT stages), as the
JAX package's own kernel tests use: the two sides sum f32 products in
different orders (this package the 4-product form, the JAX package the
Karatsuba form). The z-stage inputs are drawn with variance 1/dim_z so
that the transformed sticks have unit variance and ``atol`` means the
same at every dim_z."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import dft_kernel as jdk
from spfft_tpu.ops import fused_kernel as jfk
from spfft_tpu.ops import gather_kernel as jgk
from spfft_tpu.ops import stages as jstages

from spfft_tpu_torch.errors import DeviceError, InvalidParameterError
from spfft_tpu_torch.indexing import inverse_slot_map
from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel, stages

torch.set_num_threads(2)

TOL = 2e-6


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _mats(m):
    """(cr, ci) tensors of a matrix pair, or of the JAX package's
    Karatsuba triple (whose third matrix the 4-product form needs not)."""
    return dft.device_mats(m[:2], "cpu")


def _close_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= TOL * max(np.linalg.norm(want),
                                                   1e-30)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


# -- matrix builders ----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 7, 12, 16, 128, 256])
@pytest.mark.parametrize("sign", [dft.BACKWARD, dft.FORWARD])
def test_c2c_mats_equal_jax(n, sign):
    scale = 1.0 / (n * 3)
    for s in (1.0, scale):
        got = dft.c2c_mats(n, sign, s)
        want = jdft.c2c_mats(n, sign, s)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_sub_mats_equal_jax():
    rows = (20, 21, 22, 23, 0, 1, 2)
    for got, want in (
            (dft.sub_rows_mats(24, dft.BACKWARD, rows),
             jdft.sub_rows_mats(24, jdft.BACKWARD, rows)),
            (dft.sub_cols_mats(24, dft.FORWARD, rows),
             jdft.sub_cols_mats(24, jdft.FORWARD, rows))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_long_axes_raise_typed_error():
    with pytest.raises(InvalidParameterError, match="later slice"):
        dft.c2c_mats(513, dft.FORWARD)


def test_mdft_coverable_matches_jax():
    for dims in ((256,), (513,), (1021,), (1024, 8), (2053,), (4099, 4)):
        assert dft.mdft_coverable(dims) == jdft.mdft_coverable(dims)


# -- pdft2 -------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def test_pdft2_matches_jax_interpret():
    p, a, b = 5, 12, 16
    xr, xi = _rand((p, a, b), 5), _rand((p, a, b), 6)
    m1 = jdft.c2c_mats(b, jdft.BACKWARD)
    m2 = jdft.c2c_mats(a, jdft.FORWARD)
    want = jdk.pdft2(jnp.asarray(xr), jnp.asarray(xi), m1, m2,
                     interpret=True)
    got = dft_kernel.pdft2(_t(xr), _t(xi), _mats(m1), _mats(m2))
    _close_l2(got[0], want[0])
    _close_l2(got[1], want[1])


@pytest.mark.parametrize("case", [
    ((5, 12, 16), "c2c", "c2c"),
    ((1, 7, 9), "c2c", "c2c"),
    ((8, 16, 16), "c2c", "c2c"),
    ((3, 9, 20), "c2c", "rows"),      # split-x backward: (w -> dim_x)
    ((4, 20, 24), "cols", "c2c"),     # split-x forward: (dim_x -> w)
    ((2, 11, 128), "c2c", "c2c"),
])
def test_pdft2_matches_jax_composition(case):
    (p, a, b), k1, k2 = case
    window = (20, 21, 22, 23, 0, 1, 2, 3, 4)

    def mats(kind, n, out, sign):
        if kind == "rows":
            return jdft.sub_rows_mats(out, sign, window[:n])
        if kind == "cols":
            return jdft.sub_cols_mats(n, sign, window[:6])
        return jdft.c2c_mats(n, sign)

    m1 = mats(k1, b, 24, jdft.FORWARD)
    m2 = mats(k2, a, 24, jdft.BACKWARD)
    xr, xi = _rand((p, a, b), 7), _rand((p, a, b), 8)
    want = jdft.pdft2_minor(jnp.asarray(xr), jnp.asarray(xi), m1, m2)
    got = dft_kernel.pdft2(_t(xr), _t(xi), _mats(m1), _mats(m2))
    assert tuple(got[0].shape) == tuple(want[0].shape)
    _close_l2(got[0], want[0])
    _close_l2(got[1], want[1])


# -- decompress_zdft ---------------------------------------------------------

def _slot_set(s, dz, fill, seed, dup=0):
    """Occupied slots of s sticks x dz (every third stick empty), shuffled,
    with ``dup`` duplicated values."""
    rng = np.random.default_rng(seed)
    occ = rng.random(s * dz) < fill
    occ.reshape(s, dz)[::3] = False
    slots = np.flatnonzero(occ)
    slots = np.concatenate([slots, slots[:dup]])
    return slots[rng.permutation(len(slots))]


def test_decompress_zdft_matches_jax_interpret():
    """Tables as tests/test_fused_kernel.py builds them (dim_z = 128)."""
    rng = np.random.default_rng(0)
    s_pad, dim_z = 32, 128
    num_slots = s_pad * dim_z
    vi = np.flatnonzero(rng.random(num_slots) < 0.6)
    (dec_idx, occupied), _ = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(dec_idx, occupied, len(vi))
    ft = jfk.build_fused_decompress_tables(nt, dim_z, s_pad)
    vals = (rng.standard_normal((len(vi), 2))
            / np.sqrt(dim_z)).astype(np.float32)
    re, im = jgk.planar_from_interleaved(jnp.asarray(vals), nt.src_rows)
    mats = jdft.c2c_mats(dim_z, jdft.BACKWARD)
    wr, wi = jfk.run_decompress_zdft(
        re, im, jfk.decompress_device_tables(ft), jfk.commit_mats(mats),
        ft, interpret=True)
    slot_src = _t(inverse_slot_map(vi, num_slots, len(vi)))
    gr, gi = fused_kernel.decompress_zdft(_t(vals), slot_src, _mats(mats),
                                          dim_z)
    _close(gr, np.asarray(wr)[:s_pad])
    _close(gi, np.asarray(wi)[:s_pad])


@pytest.mark.parametrize("dz", [12, 16, 128])
@pytest.mark.parametrize("pair", [False, True])
def test_decompress_zdft_matches_jax_composition(dz, pair):
    s = 10
    slots = _slot_set(s, dz, 0.5, seed=dz, dup=3)
    nv = len(slots)
    rng = np.random.default_rng(dz + 1)
    vals = (rng.standard_normal((nv, 2)) / np.sqrt(dz)).astype(np.float32)
    # one trailing stick of sentinels, as the plan lays slot_src out
    ss = np.concatenate([inverse_slot_map(slots, s * dz, nv),
                         np.full(dz, nv, np.int32)])
    mats = jdft.c2c_mats(dz, jdft.BACKWARD)
    flat = jstages.gather_rows_with_sentinel(jnp.asarray(vals),
                                             jnp.asarray(ss))
    wr, wi = jdft.pdft_last(flat[:, 0].reshape(s + 1, dz),
                            flat[:, 1].reshape(s + 1, dz), mats)
    v = _t(vals.T) if pair else _t(vals)
    gr, gi = fused_kernel.decompress_zdft(v, _t(ss), _mats(mats), dz, pair)
    _close(gr, wr)
    _close(gi, wi)
    assert not gr[s].any() and not gi[s].any()  # the sentinel stick


# -- zdft_compress ------------------------------------------------------------

def test_zdft_compress_matches_jax_interpret():
    rng = np.random.default_rng(1)
    s_pad, dim_z = 32, 128
    num_slots = s_pad * dim_z
    vi = np.flatnonzero(rng.random(num_slots) < 0.5)
    _, (cmp_idx, cmp_valid) = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(cmp_idx, cmp_valid, num_slots)
    ct = jfk.build_fused_compress_tables(nt, dim_z, s_pad)
    sr, si = (rng.standard_normal((2, s_pad, dim_z))
              / np.sqrt(dim_z)).astype(np.float32)
    mats = jdft.c2c_mats(dim_z, jdft.FORWARD, scale=1.0 / num_slots)
    psr, psi = jfk.pad_sticks_planar(jnp.asarray(sr), jnp.asarray(si),
                                     ct.src_sticks)
    fo_re, fo_im = jfk.run_zdft_compress(
        psr, psi, jfk.compress_device_tables(ct), jfk.commit_mats(mats),
        ct, interpret=True)
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(vi, s_pad, dim_z))
    got = fused_kernel.zdft_compress(_t(sr), _t(si), _mats(mats), csr)
    _close(got[:, 0], np.asarray(fo_re).reshape(-1)[:ct.num_out])
    _close(got[:, 1], np.asarray(fo_im).reshape(-1)[:ct.num_out])


@pytest.mark.parametrize("dz", [12, 16, 128])
@pytest.mark.parametrize("pair", [False, True])
def test_zdft_compress_matches_jax_composition(dz, pair):
    s = 10
    slots = _slot_set(s, dz, 0.5, seed=dz + 7, dup=4)
    rng = np.random.default_rng(dz + 2)
    sr, si = (rng.standard_normal((2, s, dz)) / np.sqrt(dz)) \
        .astype(np.float32)
    mats = jdft.c2c_mats(dz, jdft.FORWARD, scale=0.25)
    tr, ti = jdft.pdft_last(jnp.asarray(sr), jnp.asarray(si), mats)
    want = jstages.compress(tr + 1j * ti, jnp.asarray(slots))
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(slots, s, dz))
    got = fused_kernel.zdft_compress(_t(sr), _t(si), _mats(mats), csr, pair)
    _close(got.t() if pair else got, want)


def test_compress_csr_covers_each_value_once():
    slots = _slot_set(9, 12, 0.4, seed=3, dup=5)
    ptr, vid, vz = fused_kernel.compress_csr(slots, 9, 12)
    assert ptr[0] == 0 and ptr[-1] == len(slots)
    np.testing.assert_array_equal(np.sort(vid), np.arange(len(slots)))
    stick = np.repeat(np.arange(9), np.diff(ptr))
    np.testing.assert_array_equal(stick * 12 + vz, slots[vid])


# -- placement stages (plain indexing in both packages) ----------------------

def test_stick_grid_placement_matches_jax():
    rng = np.random.default_rng(4)
    s, planes, w, dy = 7, 5, 4, 3
    cols = rng.choice(w * dy, size=s, replace=False).astype(np.int32)
    col_inv = np.full(w * dy, s, np.int32)
    col_inv[cols] = np.arange(s, dtype=np.int32)
    sticks = rng.standard_normal((s, planes)).astype(np.float32)
    want = np.asarray(jstages.sticks_to_grid(jnp.asarray(sticks),
                                             jnp.asarray(col_inv), w, dy))
    got = stages.sticks_to_grid(_t(sticks), _t(col_inv).long(), w, dy)
    np.testing.assert_array_equal(got, want)
    assert got.is_contiguous()
    padded = np.concatenate([sticks, np.zeros((1, planes), np.float32)])
    np.testing.assert_array_equal(
        stages.sticks_to_grid_padded(_t(padded), _t(col_inv).long(), w, dy),
        want)
    back = stages.grid_to_sticks(_t(want), _t(cols).long())
    np.testing.assert_array_equal(
        back, np.asarray(jstages.grid_to_sticks(jnp.asarray(want),
                                                jnp.asarray(cols))))
    np.testing.assert_array_equal(back, sticks)


# -- wrapper rules -------------------------------------------------------------

def test_wrappers_check_operands():
    m = _mats(jdft.c2c_mats(8, jdft.FORWARD))
    x = torch.zeros((2, 8, 8))
    with pytest.raises(InvalidParameterError, match="float32"):
        dft_kernel.pdft2(x.double(), x.double(), m, m)
    with pytest.raises(InvalidParameterError, match="contiguous"):
        dft_kernel.pdft2(x.transpose(1, 2), x, m, m)
    with pytest.raises(InvalidParameterError, match="shape"):
        dft_kernel.pdft2(x, torch.zeros((2, 8, 7)), m, m)
    ss = torch.zeros(16, dtype=torch.int64)
    with pytest.raises(InvalidParameterError, match="int32"):
        fused_kernel.decompress_zdft(torch.zeros((3, 2)), ss, m, 8)
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(
        np.array([0, 9]), 2, 8))
    with pytest.raises(InvalidParameterError, match="shape"):
        fused_kernel.zdft_compress(torch.zeros((3, 8)), torch.zeros((3, 8)),
                                   m, csr)


def test_wrappers_refuse_devices_without_a_kernel():
    """Only CPU tensors take the plain version; a tensor on any device
    other than CUDA raises instead of falling back."""
    m = dft.device_mats(jdft.c2c_mats(8, jdft.FORWARD)[:2], "meta")
    x = torch.zeros((2, 8, 8), device="meta")
    with pytest.raises(DeviceError):
        dft_kernel.pdft2(x, x, m, m)
