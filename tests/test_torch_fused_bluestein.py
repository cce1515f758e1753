"""The fused z kernels at a dim_z with a prime of 13 or more: their
Bluestein form (``csrc/fused_bluestein.cu``, ``fused_kernel.z_form`` ->
``"bluestein"``) on the CPU.

* The dispatch: the lengths' own z tables take the Bluestein form at 13,
  26, 416, 509, the FFT form at 12, 256, 448; a plain matrix pair keeps
  the matrix form.
* Fused C2C and R2C plans at (12, 10, 13) and (8, 6, 26), local and
  distributed over 1 and 4 shards, against the JAX package's plans on the
  same triplets and seeded numpy values (the JAX package declines its
  fused kernels at such a dim_z and runs its two-kernel route): within
  1e-6 relative l2 in single precision (both sides sum float32 products
  in different orders, each about 1e-7 a pass; the port's z stage is
  Bluestein's FFT, the JAX package's a dense product) and
  ``predicted_rel_error("double", n)`` in double.
* The same plans through the wrappers' launch path, the C entries
  emulated in numpy through the pointers the wrappers pass
  (``test_torch_zfft``'s ``emulated``): one launch of each z kernel in
  the Bluestein form a direction (one per shard on a distributed plan),
  B = 3 bands bit for bit against single calls.
* The plans' z tables are Bluestein tables (the chirp, the spectrum and
  the twiddles of M), the same for both routes, not dim_z^2 matrices, and
  ``estimated_device_bytes`` counts them; a plan artifact restores onto
  them bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

import spfft_tpu
from spfft_tpu import parallel as jpar

import spfft_tpu_torch as sp
from spfft_tpu_torch.ops import dft, fused_kernel

from test_distributed import split_by_sticks, split_planes
from test_torch_zfft import _launched, emulated  # noqa: F401 (a fixture)
from test_util import (dense_cube_from_values, dense_forward,
                       hermitian_triplets, random_sparse_triplets,
                       random_values, sample_cube)

torch.set_num_threads(2)

TOL = 1e-6
DIMS = [(12, 10, 13), (8, 6, 26)]
B = 3


def _tol(precision, dims):
    return TOL if precision == "single" else \
        sp.predicted_rel_error("double", max(dims))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


def _case(tt, dims, precision):
    """Triplets and seeded values: a sparse C2C set, or the hermitian
    half of an R2C one with the spectrum of a real field on it."""
    rng = np.random.default_rng(sum(dims) + (tt == "R2C"))
    cdt = np.complex64 if precision == "single" else np.complex128
    if tt == "C2C":
        trip = random_sparse_triplets(rng, dims, 0.7, 0.7)
        vals = random_values(rng, len(trip))
        return trip, vals.astype(cdt)
    trip = hermitian_triplets(rng, dims)
    nx, ny, nz = dims
    field = rng.standard_normal((nz, ny, nx))
    return trip, sample_cube(dense_forward(field), trip, dims).astype(cdt)


def _jax_local(tt, dims, trip, vals, precision):
    jp = spfft_tpu.make_local_plan(spfft_tpu.TransformType[tt], *dims, trip,
                                   precision=precision)
    want_b = np.asarray(jp.backward(vals))
    return want_b, np.asarray(jp.forward(want_b, spfft_tpu.Scaling.FULL))


def _split(trip, dims, shards):
    parts = split_by_sticks(trip, dims, [1, 2, 1, 3][:shards])
    planes = split_planes(dims[2], [2, 1, 1, 1][:shards])
    return parts, planes


def _values_per_shard(trip, vals, parts):
    pos = {tuple(t): i for i, t in enumerate(np.asarray(trip).tolist())}
    return [vals[[pos[tuple(t)] for t in p.tolist()]] for p in parts]


def test_forms_by_length():
    c = dft.device_c2c
    for n in (13, 26, 416, 509):
        for sign in (dft.BACKWARD, dft.FORWARD):
            m = c(n, sign)
            assert fused_kernel.z_form(m, n) == "bluestein", n
            assert len(m) == 0 and m.bluestein.m == dft.bluestein_length(n)
    for n in (12, 256, 448):
        assert fused_kernel.z_form(c(n, dft.BACKWARD), n) == "fft", n
    plain = dft.device_mats(dft.c2c_mats(13, dft.BACKWARD), "cpu")
    assert fused_kernel.z_form(plain, 13) == "matrix"
    assert fused_kernel.z_form(c(416, dft.FORWARD, form="matrix"), 416) == \
        "matrix"
    assert fused_kernel.FORMS == ("matrix", "fft", "bluestein")


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("tt", ["C2C", "R2C"])
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_local_fused_plan_matches_jax(dims, tt, precision):
    trip, vals = _case(tt, dims, precision)
    want_b, want_f = _jax_local(tt, dims, trip, vals, precision)
    tp = sp.make_local_plan(sp.TransformType[tt], *dims, trip, device="cpu",
                            precision=precision)
    assert tp.fused_active and tp.fused_fallback_reasons == {}
    assert fused_kernel.z_form(tp._mats["z_b"], dims[2]) == "bluestein"
    got_b = tp.backward(vals).numpy()
    got_f = tp.forward(torch.from_numpy(want_b.copy()),
                       sp.Scaling.FULL).numpy()
    tol = _tol(precision, dims)
    assert _rel(got_b, want_b) <= tol
    assert _rel(got_f, want_f) <= tol


@pytest.mark.parametrize("tt", ["C2C", "R2C"])
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_local_fused_plan_launch_path(emulated, dims, tt):
    """The same plan through the launch path: one Bluestein launch of
    each z kernel a direction (the R2C zero stick reaching the kernel),
    results within TOL of the JAX plan; a batch of B bands in one launch
    each, bit for bit against single calls."""
    trip, vals = _case(tt, dims, "single")
    want_b, want_f = _jax_local(tt, dims, trip, vals, "single")
    tp = sp.make_local_plan(sp.TransformType[tt], *dims, trip, device="cpu")
    got_b = tp.backward(vals)
    got_f = tp.forward(torch.from_numpy(want_b.copy()), sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, bluestein=1)
    assert _launched(fused_kernel.zdft_compress, bluestein=1)
    assert set(emulated) >= {"spfft_decompress_zdft_bluestein",
                             "spfft_zdft_compress_bluestein"}
    assert (tp._zero_stick >= 0) == (tt == "R2C")
    assert _rel(got_b.numpy(), want_b) <= TOL
    assert _rel(got_f.numpy(), want_f) <= TOL
    bands = np.stack([vals * (1 + b / 2) for b in range(B)])
    space = tp.backward_batched(bands)
    out = tp.forward_batched(space, sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, bluestein=2)
    assert _launched(fused_kernel.zdft_compress, bluestein=2)
    for b in range(B):
        one = tp.backward(bands[b])
        assert torch.equal(space[b], one)
        assert torch.equal(out[b], tp.forward(one, sp.Scaling.FULL))


@pytest.mark.parametrize("precision", ["single", "double"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("tt", ["C2C", "R2C"])
def test_distributed_fused_plan_matches_jax(tt, shards, precision):
    """Distributed plans over 1 and 4 shards at (12, 10, 13) against
    ``spfft_tpu.parallel`` on conftest's virtual CPU devices."""
    dims = DIMS[0]
    trip, vals = _case(tt, dims, precision)
    parts, planes = _split(trip, dims, shards)
    pv = _values_per_shard(trip, vals, parts)
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType[tt], *dims,
                                    parts, planes,
                                    mesh=jpar.make_mesh(shards),
                                    precision=precision)
    want_b = np.array(jp.backward(pv))
    want_f = np.asarray(jp.forward(jax.device_put(want_b, jp._sharded),
                                   spfft_tpu.Scaling.FULL))
    tp = sp.make_distributed_plan(sp.TransformType[tt], *dims, parts,
                                  planes, device="cpu", precision=precision)
    assert tp.fused_dist_active and tp.fused_dist_fallback_reason is None
    assert fused_kernel.z_form(tp._mats["z_b"], dims[2]) == "bluestein"
    got_b = tp.backward(pv).numpy()
    got_f = tp.forward(torch.from_numpy(want_b.copy()),
                       sp.Scaling.FULL).numpy()
    tol = _tol(precision, dims)
    assert _rel(got_b, want_b) <= tol
    assert _rel(got_f, want_f) <= tol


@pytest.mark.parametrize("tt", ["C2C", "R2C"])
def test_distributed_fused_plan_launch_path(emulated, tt):
    """Four shards through the launch path: each z kernel once a shard
    and direction in the Bluestein form, within TOL of the JAX plan; B
    bands bit for bit against single calls."""
    dims = DIMS[1]
    trip, vals = _case(tt, dims, "single")
    parts, planes = _split(trip, dims, 4)
    pv = _values_per_shard(trip, vals, parts)
    jp = jpar.make_distributed_plan(spfft_tpu.TransformType[tt], *dims,
                                    parts, planes, mesh=jpar.make_mesh(4),
                                    precision="single")
    want_b = np.array(jp.backward(pv))
    tp = sp.make_distributed_plan(sp.TransformType[tt], *dims, parts,
                                  planes, device="cpu")
    got_b = tp.backward(pv)
    tp.forward(got_b, sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, bluestein=4)
    assert _launched(fused_kernel.zdft_compress, bluestein=4)
    assert _rel(got_b.numpy(), want_b) <= TOL
    bands = [[v * (1 + b / 2) for v in pv] for b in range(B)]
    space = tp.backward_batched(bands)
    out = tp.forward_batched(space, sp.Scaling.FULL)
    assert _launched(fused_kernel.decompress_zdft, bluestein=8)
    assert _launched(fused_kernel.zdft_compress, bluestein=8)
    for b in range(B):
        one = tp.backward(bands[b])
        assert torch.equal(space[:, b], one)
        assert torch.equal(out[:, b], tp.forward(one, sp.Scaling.FULL))


def _table_bytes(mats) -> int:
    return sum(t.numel() * t.element_size() for t in mats.tensors)


@pytest.mark.parametrize("precision", ["single", "double"])
def test_z_tables_are_bluestein_and_bytes_follow(precision):
    """The plan's z tables are the length's Bluestein tables ((2, n)
    chirp, (2, M) spectrum and twiddles), the fused and two-kernel plans'
    the same, no dim_z^2 matrix on either;
    ``estimated_device_bytes`` is
    the plan's tensors, dim_z^2 pairs of the matrix form absent; a plan
    artifact restores onto the same tables, bit for bit."""
    dims = DIMS[1]
    dz = dims[2]
    m = dft.bluestein_length(dz)
    trip, vals = _case("C2C", dims, precision)
    fused, split = (sp.make_local_plan(sp.TransformType.C2C, *dims, trip,
                                       device="cpu", precision=precision,
                                       fused=f) for f in (True, False))
    e = fused.real_dtype.itemsize
    for key in ("z_b", "z_f", "z_fs"):
        z = fused._mats[key]
        assert z.form == "bluestein" and len(z) == 0
        assert [tuple(t.shape) for t in z.bluestein] == [(2, dz), (2, m),
                                                         (2, m)]
        assert _table_bytes(z) == 2 * (dz + 2 * m) * e
        assert all(t.numel() != dz * dz for t in z.tensors)
        s = split._mats[key]
        assert s.form == "bluestein"
        assert all(torch.equal(a, b) for a, b in zip(z.tensors, s.tensors))
    # the plan's bytes are its tables and stages, each tensor once
    want = sum(t.numel() * t.element_size()
               for v in fused._tabs.values()
               for t in (v if isinstance(v, tuple) else (v,)))
    want += sum(_table_bytes(z) for z in fused._mats.values())
    assert fused.estimated_device_bytes() == want
    # against the matrix form's three dim_z^2 pairs, the Bluestein tables
    # are smaller by construction at these lengths
    z_bytes = sum(_table_bytes(fused._mats[k]) for k in ("z_b", "z_f",
                                                         "z_fs"))
    assert z_bytes == 3 * 2 * (dz + 2 * m) * e < 3 * 2 * dz * dz * e
    restored = sp.restore_plan(fused.index_plan, fused.export_tables(),
                               precision=precision, device="cpu")
    assert restored._mats["z_b"].form == "bluestein"
    assert torch.equal(restored.backward(vals), fused.backward(vals))
