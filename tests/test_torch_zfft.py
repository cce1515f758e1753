"""The FFT form of the fused z kernels (``decompress_zdft``,
``zdft_compress``, ``csrc/fused_fft.cu``) on the CPU.

The kernels cannot run here, but their launch path can: the ``emulated``
fixture makes every wrapper take its CUDA path on CPU tensors and runs
each C entry in numpy, reading and writing the operands through the
pointers the wrapper passes (argument order, radix code, sign, scale,
input and output windows, ``zero_stick``, batch, both value layouts).
The FFT form is emulated with ``test_torch_fft.stockham``, the numpy
mirror of ``csrc/fft_tile.cuh``, on the f32 twiddle table the wrapper
hands the kernel; the matrix form (``csrc/fused_compress.cu``) with the
matrix pair it hands. On those paths:

* both wrappers against the JAX package's ``run_decompress_zdft`` /
  ``run_zdft_compress`` in interpret mode, on the tables
  ``tests/test_torch_kernels.py`` builds, and against its XLA
  compositions at other dim_z;
* the dispatch (``fused_kernel.z_form``) and the launches by form;
* a batched launch against B single launches, bit for bit;
* the launches by form of a local C2C and R2C pair and of a 3-shard
  distributed pair, whose results agree with ``spfft_tpu``.

Tolerance: 2e-6 in relative l2 and in the largest error relative to the
largest value (``KERNEL_TOL`` of ``chip_smoke.py``, the JAX package's
kernel tests' own): the JAX side sums f32 products in its Karatsuba
form, whose error grows with sqrt(dim_z).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spfft_tpu
from spfft_tpu import parallel as jpar
from spfft_tpu.ops import dft as jdft
from spfft_tpu.ops import fused_kernel as jfk
from spfft_tpu.ops import gather_kernel as jgk
from spfft_tpu.ops import stages as jstages

import spfft_tpu_torch as sp
from spfft_tpu_torch.indexing import inverse_slot_map
from spfft_tpu_torch.ops import _build, dft, dft_kernel, fused_kernel

from test_torch_fft import (_emulate as _emulate_dft, _view, decode_radices,
                            emulated_function, entry_real, stockham)
from test_util import (dense_cube_from_values, hermitian_triplets,
                       random_sparse_triplets, random_values, sample_cube)

torch.set_num_threads(2)

TOL = 2e-6


def _ints(ptr, count):
    """A numpy view of ``count`` int32 at a CPU tensor's address."""
    if count == 0:
        return np.zeros(0, np.int32)
    return np.ctypeslib.as_array((ctypes.c_int * count).from_address(ptr))


def _values(ptr, batch, nv, pair, real=np.float32):
    """A writable view of the values at ``ptr``, ``(batch, 2, nv)`` or
    ``(batch, nv, 2)``, of type ``real``."""
    v = _view(ptr, batch * 2 * nv, real)
    return v.reshape(batch, 2, nv) if pair else v.reshape(batch, nv, 2)


def _put_values(view, pair, y):
    if pair:
        view[:, 0], view[:, 1] = y.real, y.imag
    else:
        view[..., 0], view[..., 1] = y.real, y.imag


def _factors(code):
    return decode_radices(code)


def _fft_form(x, n, sign, scale, in0, out0, code, tw_ptr, real=np.float32):
    """What fused_fft.cu computes on raw sticks ``x`` (..., n): slot k at
    position (in0 + k) mod n, the Stockham FFT on the table (of type
    ``real``) at ``tw_ptr``, output j from position (out0 + j) mod n
    times ``scale``."""
    assert tuple(_factors(code)) == dft.fft_factors(n)
    t = _view(tw_ptr, 2 * n, real).astype(np.float64)
    want = dft.fft_twiddles(n, sign)
    np.testing.assert_array_equal(t[:n], want.real.astype(real))
    np.testing.assert_array_equal(t[n:], want.imag.astype(real))
    buf = np.zeros(x.shape, np.complex128)
    buf[..., (in0 + np.arange(n)) % n] = x
    y = stockham(buf, sign, _factors(code), t[:n] + 1j * t[n:])
    return y[..., (out0 + np.arange(n)) % n] * scale


def _matrix_form(x, cr, ci, n, real=np.float32):
    """x (..., n) against the matrix pair, summed over k in one fixed
    order (a BLAS product's order may depend on the operand's address)."""
    m = (_view(cr, n * n, real) + 1j * _view(ci, n * n, real)).reshape(n, n)
    return sum(x[..., k, None] * m[k].astype(np.complex128)
               for k in range(n))


def _gather(values, slot_src, num_sticks, n, nv, pair, zero_stick, batch,
            real=np.float32):
    """The raw sticks ``(batch, num_sticks, n)`` a decompress kernel
    gathers, the zero stick completed from the values before completion."""
    v = _values(values, batch, nv, pair, real)
    vals = v[:, 0] + 1j * v[:, 1] if pair else v[..., 0] + 1j * v[..., 1]
    ss = _ints(slot_src, num_sticks * n).reshape(num_sticks, n)
    x = np.concatenate([vals, np.zeros((batch, 1))], axis=1)[:, ss]
    if zero_stick >= 0:
        stick = x[:, zero_stick]
        mirror = np.roll(stick[:, ::-1], 1, axis=-1)
        x[:, zero_stick] = np.where(stick != 0, stick, mirror.conj())
    return x


def _compress(x, stick_ptr, val_id, val_z, values, num_sticks, nv, pair,
              batch, real=np.float32):
    """Write each value of the CSR from the transformed sticks ``x``
    (output columns in order)."""
    ptr = _ints(stick_ptr, num_sticks + 1)
    stick = np.repeat(np.arange(num_sticks), np.diff(ptr))
    y = np.empty((batch, nv), np.complex128)
    y[:, _ints(val_id, nv)] = x[:, stick, _ints(val_z, nv)]
    _put_values(_values(values, batch, nv, pair, real), pair, y)


def _bluestein_form(x, n, x0, y0, tables, split, real=np.float32):
    """What fused_bluestein.cu computes on raw sticks ``x`` (..., n): the
    Bluestein DFT of csrc/bluestein.cu in mode cc (slot k at position
    (x0 + k) mod n, output j from position (y0 + j) mod n), run by
    test_torch_long_axes' ``emulate_bluestein`` through the tables'
    pointers the wrapper passes (``tables``: chirp, spectrum, twiddles;
    ``split``: M, m1, m2, the radices, the paths)."""
    from test_torch_long_axes import emulate_bluestein
    rows = int(np.prod(x.shape[:-1]))
    xr, xi = (np.ascontiguousarray(p.astype(real)).reshape(-1)
              for p in (x.real, x.imag))
    yr, yi = np.empty_like(xr), np.empty_like(xr)
    if rows:
        emulate_bluestein((0, xr.ctypes.data, xi.ctypes.data, yr.ctypes.data,
                           yi.ctypes.data, *tables, rows, n, n, 0, n, x0, y0,
                           *split), real)
    return (yr + 1j * yi.astype(np.complex128)).reshape(x.shape)


def _emulate(symbol, args):
    """numpy stand-ins for the C entries of csrc/fused_fft.cu,
    csrc/fused_bluestein.cu and csrc/fused_compress.cu, float32 and
    float64 (the suffix ``_f64``); any other symbol goes to
    test_torch_fft's."""
    base, real = entry_real(symbol)

    def view(ptr, count):
        return _view(ptr, count, real)

    if base == "spfft_decompress_zdft_fft":
        (values, slot_src, tw, sr, si, s, nv, pair, zs, batch, n, sign,
         scale, in0, out0, code) = args
        x = _gather(values, slot_src, s, n, nv, pair, zs, batch, real)
        y = _fft_form(x, n, sign, scale, in0, out0, code, tw, real)
    elif base == "spfft_decompress_zdft_bluestein":
        (values, slot_src, chirp, spec, tw, sr, si, s, nv, pair, zs, batch,
         n, x0, y0, *split) = args
        y = _bluestein_form(_gather(values, slot_src, s, n, nv, pair, zs,
                                    batch, real), n, x0, y0,
                            (chirp, spec, tw), split, real)
    elif base == "spfft_zdft_compress_bluestein":
        (sr, si, chirp, spec, tw, ptr, vid, vz, values, s, nv, pair, batch,
         n, x0, y0, *split) = args
        x = (view(sr, batch * s * n) + 1j * view(si, batch * s * n)) \
            .reshape(batch, s, n)
        _compress(_bluestein_form(x, n, x0, y0, (chirp, spec, tw), split,
                                  real),
                  ptr, vid, vz, values, s, nv, pair, batch, real)
        return
    elif base == "spfft_decompress_zdft":
        (values, slot_src, cr, ci, sr, si, s, n, nv, pair, zs,
         batch) = args
        y = _matrix_form(_gather(values, slot_src, s, n, nv, pair, zs,
                                 batch, real), cr, ci, n, real)
    elif base == "spfft_zdft_compress_fft":
        (sr, si, tw, ptr, vid, vz, values, s, nv, pair, batch, n, sign,
         scale, in0, out0, code) = args
        x = (view(sr, batch * s * n) + 1j * view(si, batch * s * n)) \
            .reshape(batch, s, n)
        _compress(_fft_form(x, n, sign, scale, in0, out0, code, tw, real),
                  ptr, vid, vz, values, s, nv, pair, batch, real)
        return
    elif base == "spfft_zdft_compress":
        (sr, si, cr, ci, ptr, vid, vz, values, s, n, nv, pair,
         batch) = args
        x = (view(sr, batch * s * n) + 1j * view(si, batch * s * n)) \
            .reshape(batch, s, n)
        _compress(_matrix_form(x, cr, ci, n, real), ptr, vid, vz, values, s,
                  nv, pair, batch, real)
        return
    else:
        _emulate_dft(symbol, args)
        return
    view(sr, y.size)[:] = y.real.reshape(-1)
    view(si, y.size)[:] = y.imag.reshape(-1)


@pytest.fixture
def emulated(monkeypatch):
    """Every wrapper takes its launch path on CPU tensors, each launch run
    by :func:`_emulate`; yields the list of launched symbols."""
    calls = []
    monkeypatch.setattr(_build, "on_cuda", lambda t, what: True)
    monkeypatch.setattr(_build, "function", emulated_function)
    assert fused_kernel._build is _build and dft_kernel._build is _build

    def launch(fn, what, device, *args):
        calls.append(fn[1])
        _emulate(fn[1], args)

    monkeypatch.setattr(_build, "launch", launch)
    for w, forms in ((fused_kernel.decompress_zdft, fused_kernel.FORMS),
                     (fused_kernel.zdft_compress, fused_kernel.FORMS),
                     (dft_kernel.pdft_last, dft_kernel.FORMS),
                     (dft_kernel.pdft2, dft_kernel.FORMS),
                     (dft_kernel.pdft2_swapped, dft_kernel.FORMS),
                     (dft_kernel.prdft2, dft_kernel.FORMS),
                     (dft_kernel.pdft2_cr, dft_kernel.FORMS)):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "form_launches", dict.fromkeys(forms, 0))
    yield calls


def _launched(wrapper, **forms):
    return wrapper.form_launches == dict(
        dict.fromkeys(fused_kernel.FORMS, 0), **forms)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _close(got, want):
    """Relative l2 and relative max error within TOL, as chip_smoke.py
    compares a kernel with its plain version."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    assert np.abs(got - want).max(initial=0.0) <= TOL * scale
    assert _rel(got, want) <= TOL


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- against the Pallas kernels in interpret mode -----------------------------

def test_decompress_zdft_fft_matches_jax_interpret(emulated):
    """Tables as tests/test_torch_kernels.py builds them (dim_z = 128)."""
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
    wr, wi = jfk.run_decompress_zdft(
        re, im, jfk.decompress_device_tables(ft),
        jfk.commit_mats(jdft.c2c_mats(dim_z, jdft.BACKWARD)), ft,
        interpret=True)
    slot_src = _t(inverse_slot_map(vi, num_slots, len(vi)))
    mats = dft.device_c2c(dim_z, dft.BACKWARD)
    gr, gi = fused_kernel.decompress_zdft(_t(vals), slot_src, mats, dim_z)
    _close(gr, np.asarray(wr)[:s_pad])
    _close(gi, np.asarray(wi)[:s_pad])
    assert emulated == ["spfft_decompress_zdft_fft"]
    assert _launched(fused_kernel.decompress_zdft, fft=1)


def test_zdft_compress_fft_matches_jax_interpret(emulated):
    rng = np.random.default_rng(1)
    s_pad, dim_z = 32, 128
    num_slots = s_pad * dim_z
    vi = np.flatnonzero(rng.random(num_slots) < 0.5)
    _, (cmp_idx, cmp_valid) = jgk.compression_gather_inputs(vi, num_slots)
    nt = jgk.build_monotone_gather_tables(cmp_idx, cmp_valid, num_slots)
    ct = jfk.build_fused_compress_tables(nt, dim_z, s_pad)
    sr, si = (rng.standard_normal((2, s_pad, dim_z))
              / np.sqrt(dim_z)).astype(np.float32)
    psr, psi = jfk.pad_sticks_planar(jnp.asarray(sr), jnp.asarray(si),
                                     ct.src_sticks)
    fo_re, fo_im = jfk.run_zdft_compress(
        psr, psi, jfk.compress_device_tables(ct),
        jfk.commit_mats(jdft.c2c_mats(dim_z, jdft.FORWARD,
                                      scale=1.0 / num_slots)),
        ct, interpret=True)
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(vi, s_pad, dim_z))
    mats = dft.device_c2c(dim_z, dft.FORWARD, 1.0 / num_slots)
    for pair in (False, True):
        got = fused_kernel.zdft_compress(_t(sr), _t(si), mats, csr, pair)
        got = got.t() if pair else got
        _close(got[:, 0], np.asarray(fo_re).reshape(-1)[:ct.num_out])
        _close(got[:, 1], np.asarray(fo_im).reshape(-1)[:ct.num_out])
    assert emulated == ["spfft_zdft_compress_fft"] * 2
    assert _launched(fused_kernel.zdft_compress, fft=2)


# -- against the XLA compositions at other dim_z ------------------------------

def _slot_set(s, dz, fill, seed, dup=0):
    """Occupied slots of s sticks x dz (every third stick empty), shuffled,
    with ``dup`` duplicated values."""
    rng = np.random.default_rng(seed)
    occ = rng.random(s * dz) < fill
    occ.reshape(s, dz)[::3] = False
    slots = np.flatnonzero(occ)
    slots = np.concatenate([slots, slots[:dup]])
    return slots[rng.permutation(len(slots))]


DIMS = [1, 2, 3, 5, 12, 60, 256, 384, 512, 13, 7, 11, 448]


def _z_mats(dz, sign, scale=1.0, **window):
    """The z tables a plan hands the fused kernels at ``dz``: the
    length's own form, Bluestein's at a prime of 13 or more."""
    return dft.device_c2c(dz, sign, scale, **window)


@pytest.mark.parametrize("dz", DIMS)
def test_decompress_zdft_matches_jax_composition(emulated, dz):
    """Both value layouts, with and without the R2C zero stick (stick 1,
    half of it given), against the JAX package's sentinel gather, stick
    completion and z-DFT."""
    s = 7
    slots = _slot_set(s, dz, 0.5, seed=dz, dup=2)
    zs = 1
    slots = slots[slots // dz != zs]
    slots = np.concatenate([slots, zs * dz + np.arange(dz // 2 + 1)])
    nv = len(slots)
    rng = np.random.default_rng(dz + 1)
    vals = (rng.standard_normal((nv, 2)) / np.sqrt(dz)).astype(np.float32)
    ss = np.concatenate([inverse_slot_map(slots, s * dz, nv),
                         np.full(dz, nv, np.int32)])
    jm = jdft.c2c_mats(dz, jdft.BACKWARD)
    flat = jstages.gather_rows_with_sentinel(jnp.asarray(vals),
                                             jnp.asarray(ss))
    sticks = np.asarray(flat[:, 0] + 1j * flat[:, 1]).reshape(s + 1, dz)
    mats = _z_mats(dz, dft.BACKWARD)
    form = fused_kernel.z_form(mats, dz)
    assert form == ("bluestein" if dz == 13 else "fft")
    for zid in (-1, zs):
        src = sticks.copy()
        if zid >= 0:
            src[zid] = np.asarray(jstages.complete_stick_hermitian(
                jnp.asarray(src[zid])))
        wr, wi = jdft.pdft_last(jnp.asarray(src.real, jnp.float32),
                                jnp.asarray(src.imag, jnp.float32), jm)
        for pair in (False, True):
            v = _t(vals.T) if pair else _t(vals)
            gr, gi = fused_kernel.decompress_zdft(v, _t(ss), mats, dz, pair,
                                                  zid)
            _close(gr, wr)
            _close(gi, wi)
            assert not gr[s].any() and not gi[s].any()  # the sentinel
    assert _launched(fused_kernel.decompress_zdft, **{form: 4})


@pytest.mark.parametrize("dz", DIMS)
def test_zdft_compress_matches_jax_composition(emulated, dz):
    s = 7
    slots = _slot_set(s, dz, 0.5, seed=dz + 7, dup=3)
    rng = np.random.default_rng(dz + 2)
    sr, si = (rng.standard_normal((2, s, dz)) / np.sqrt(dz)) \
        .astype(np.float32)
    jm = jdft.c2c_mats(dz, jdft.FORWARD, scale=0.25)
    tr, ti = jdft.pdft_last(jnp.asarray(sr), jnp.asarray(si), jm)
    want = np.asarray(jstages.compress(tr + 1j * ti, jnp.asarray(slots)))
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(slots, s, dz))
    mats = _z_mats(dz, dft.FORWARD, 0.25)
    for pair in (False, True):
        got = fused_kernel.zdft_compress(_t(sr), _t(si), mats, csr, pair)
        _close(got.t() if pair else got, want)
    form = "bluestein" if dz == 13 else "fft"
    assert _launched(fused_kernel.zdft_compress, **{form: 2})


@pytest.mark.parametrize("x0,y0", [(5, 0), (0, 9), (11, 3)])
def test_windows_reach_the_kernel(emulated, x0, y0):
    """A z pair whose windows start off 0 (input slot k at position x0 + k,
    output j at y0 + j) takes the FFT form and computes its matrices."""
    dz, s = 12, 5
    slots = _slot_set(s, dz, 0.6, seed=4, dup=2)
    nv = len(slots)
    rng = np.random.default_rng(5)
    vals = _t(rng.standard_normal((nv, 2)).astype(np.float32) / 4)
    ss = _t(np.concatenate([inverse_slot_map(slots, s * dz, nv),
                            np.full(dz, nv, np.int32)]))
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(slots, s, dz))
    zb = dft.device_c2c(dz, dft.BACKWARD, rows=(x0, dz), cols=(y0, dz))
    zf = dft.device_c2c(dz, dft.FORWARD, 1 / 3, rows=(x0, dz),
                        cols=(y0, dz))
    sticks = fused_kernel.decompress_zdft(vals, ss, zb, dz, False, 2)
    want = fused_kernel.decompress_zdft_plain(vals, ss, zb, dz, False, 2)
    assert _rel(torch.stack(sticks), torch.stack(want)) < TOL
    sr, si = (t[:s].contiguous() for t in sticks)
    got = fused_kernel.zdft_compress(sr, si, zf, csr)
    assert _rel(got, fused_kernel.zdft_compress_plain(sr, si, zf, csr,
                                                      False)) < TOL
    assert _launched(fused_kernel.decompress_zdft, fft=1)
    assert _launched(fused_kernel.zdft_compress, fft=1)


# -- dispatch and batches -----------------------------------------------------

def test_z_form_by_shape():
    c = dft.device_c2c
    for n in (256, 12, 1, 512, 384, 2, 3, 5, 60):
        assert fused_kernel.z_form(c(n, dft.BACKWARD), n) == "fft", n
    for n in (7, 11, 448, 462, 343):  # radix 7 and 11
        assert fused_kernel.z_form(c(n, dft.FORWARD, 0.5), n) == "fft", n
    # a prime of 13 or more: the plan's z tables are the length's own,
    # Bluestein's; tables built in the matrix form keep the matrix form
    assert fused_kernel.z_form(c(13, dft.BACKWARD), 13) == "bluestein"
    assert fused_kernel.z_form(c(448, dft.BACKWARD), 448) == "fft"
    assert fused_kernel.z_form(c(13, dft.BACKWARD, form="matrix"), 13) == \
        "matrix"
    # Bluestein tables of a longer transform hold no pair for the stick
    with pytest.raises(sp.InvalidParameterError, match="Bluestein or matrix"):
        fused_kernel.z_form(c(26, dft.BACKWARD, rows=(0, 13),
                              cols=(0, 13)), 13)
    plain = dft.device_mats(dft.c2c_mats(256, dft.BACKWARD), "cpu")
    assert fused_kernel.z_form(plain, 256) == "matrix"
    # a window of a longer transform is not one stick's FFT
    assert fused_kernel.z_form(c(512, dft.BACKWARD, rows=(0, 256),
                                 cols=(0, 256)), 256) == "matrix"


@pytest.mark.parametrize("dz", [12, 13])
@pytest.mark.parametrize("pair", [False, True])
def test_batched_launch_equals_single_launches(emulated, dz, pair):
    s, b = 6, 3
    slots = _slot_set(s, dz, 0.5, seed=9, dup=2)
    nv = len(slots)
    rng = np.random.default_rng(10)
    ss = _t(np.concatenate([inverse_slot_map(slots, s * dz, nv),
                            np.full(dz, nv, np.int32)]))
    csr = tuple(_t(a) for a in fused_kernel.compress_csr(slots, s, dz))
    zb = _z_mats(dz, dft.BACKWARD)
    zf = _z_mats(dz, dft.FORWARD, 0.5)
    vals = _t(rng.standard_normal((b, 2, nv) if pair else (b, nv, 2))
              .astype(np.float32))
    got = fused_kernel.decompress_zdft(vals, ss, zb, dz, pair, 1)
    want = fused_kernel.decompress_zdft_plain(vals, ss, zb, dz, pair, 1)
    assert _rel(torch.stack(got), torch.stack(want)) < TOL
    sr, si = (t[:, :s].contiguous() for t in got)
    out = fused_kernel.zdft_compress(sr, si, zf, csr, pair)
    assert _rel(out, fused_kernel.zdft_compress_plain(sr, si, zf, csr,
                                                      pair)) < TOL
    for k in range(b):
        one = fused_kernel.decompress_zdft(vals[k], ss, zb, dz, pair, 1)
        assert torch.equal(one[0], got[0][k]) and torch.equal(one[1],
                                                             got[1][k])
        assert torch.equal(fused_kernel.zdft_compress(sr[k], si[k], zf, csr,
                                                      pair), out[k])
    form = "bluestein" if dz == 13 else "fft"
    assert _launched(fused_kernel.decompress_zdft, **{form: 1 + b})
    assert _launched(fused_kernel.zdft_compress, **{form: 1 + b})


# -- the plans' pairs ---------------------------------------------------------

def _sphere(dims, radius):
    def c(d):
        a = np.arange(d)
        return np.where(a > d // 2, a - d, a)
    X, Y, Z = np.meshgrid(c(dims[0]), c(dims[1]), c(dims[2]), indexing="ij")
    m = X * X + Y * Y + Z * Z <= radius * radius
    return np.stack([X[m], Y[m], Z[m]], axis=1).astype(np.int32)


@pytest.mark.parametrize("tt", ["C2C", "R2C"])
def test_local_pair_launches_the_fft_form(emulated, tt):
    """One z launch per direction, in the FFT form, and the pair's result
    within 2e-6 of ``spfft_tpu``."""
    dims = (16, 12, 16)
    rng = np.random.default_rng(12)
    trip = _sphere(dims, 6) if tt == "C2C" else hermitian_triplets(rng, dims)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    if tt == "R2C":
        cube = np.fft.fftn(np.fft.ifftn(cube).real)
    vals = sample_cube(cube, trip, dims).astype(np.complex64)
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType[tt], *dims, trip,
                                   precision="single", use_pallas=False)
    want_b = np.asarray(jp.backward(vals))
    want_f = np.asarray(jp.forward(want_b, spfft_tpu.Scaling.FULL))
    tp = sp.make_local_plan(sp.TransformType[tt], *dims, trip, device="cpu")
    got_b = tp.backward(vals)
    got_f = tp.forward(got_b, sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, fft=1)
    assert _launched(fused_kernel.zdft_compress, fft=1)
    assert _rel(got_b, want_b) < TOL
    assert _rel(got_f, want_f) < TOL
    if tt == "R2C":  # the zero stick reached the kernel
        assert "spfft_decompress_zdft_fft" in emulated
        assert tp._zero_stick >= 0


def test_distributed_pair_launches_the_fft_form_per_shard(emulated):
    """Three shards: each z kernel launches once per shard and direction,
    in the FFT form, and the pair agrees with ``spfft_tpu.parallel``."""
    dims = (12, 10, 10)
    rng = np.random.default_rng(13)
    trip = random_sparse_triplets(rng, dims)
    cube = dense_cube_from_values(trip, random_values(rng, len(trip)), dims)
    st = np.where(trip < 0, trip + np.array(dims), trip)
    owner = (st[:, 0] * 7 + st[:, 1]) % 3
    parts = [trip[owner == r] for r in range(3)]
    planes = [4, 3, 3]
    vals = [sample_cube(cube, p, dims).astype(np.complex64) for p in parts]
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType.C2C, *dims,
                                    parts, planes, mesh=jpar.make_mesh(3),
                                    precision="single")
    want_b = np.array(jp.backward(vals))
    want_f = np.asarray(jp.forward(jax.device_put(want_b, jp._sharded),
                                   spfft_tpu.Scaling.FULL))
    tp = sp.make_distributed_plan(sp.TransformType.C2C, *dims, parts,
                                  planes, device="cpu")
    got_b = tp.backward(vals)
    got_f = tp.forward(torch.from_numpy(want_b), sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, fft=3)
    assert _launched(fused_kernel.zdft_compress, fft=3)
    assert dft_kernel.pdft2_swapped.form_launches["cluster"] == 2
    assert _rel(got_b, want_b) < TOL
    assert _rel(got_f, want_f) < TOL
