"""The plain reference against a dense numpy.fft pair at 16^3, and the
control one precision below it."""

import numpy as np
import pytest
import torch

from portbench import workload
from portbench.reference import dense
from portbench_support import small_config


def numpy_pair(values, potential, trip, dims, r2c):
    """backward -> times V -> forward (FULL), with numpy.fft on a dense
    spectrum indexed [z, y, x]."""
    nx, ny, nz = dims
    spec = np.zeros((nz, ny, nx), np.complex128)
    v = values[:, 0] + 1j * values[:, 1]
    s = workload.storage_indices(trip, dims)
    if r2c:
        spec[(-s[:, 2]) % nz, (-s[:, 1]) % ny, (-s[:, 0]) % nx] = np.conj(v)
    spec[s[:, 2], s[:, 1], s[:, 0]] = v
    space = np.fft.ifftn(spec) * (nx * ny * nz)
    if r2c:
        assert np.abs(space.imag).max() < 1e-9 * np.abs(space.real).max()
        space = space.real
    out = np.fft.fftn(space * potential) / (nx * ny * nz)
    g = out[s[:, 2], s[:, 1], s[:, 0]]
    return np.stack([g.real, g.imag], -1)


@pytest.mark.parametrize("name", ["c2c256_f32", "r2c256_f64"])
def test_reference_matches_numpy(name):
    cfg = small_config(name, bands=2)
    trip = workload.config_triplets(cfg)
    values, pot = workload.draw_inputs(cfg, trip, 2**31 + 11, "cpu")
    idx = torch.as_tensor(workload.storage_indices(trip, cfg["dims"]))
    r2c = cfg["transform"] == "r2c"
    for b in range(2):
        got = dense.reference_pair(values[b], pot, idx, cfg["dims"], r2c)
        want = numpy_pair(values[b].double().numpy(), pot.double().numpy(),
                          trip, cfg["dims"], r2c)
        assert np.abs(got.numpy() - want).max() < 1e-12 * np.abs(want).max()


def test_r2c_inputs_are_hermitian():
    cfg = small_config("r2c256_f64", bands=3)
    trip = workload.config_triplets(cfg)
    values, _ = workload.draw_inputs(cfg, trip, 5, "cpu")
    src, dst, selfs = workload.hermitian_pairs(trip, cfg["dims"])
    # the x = 0 and x = 8 planes' corners, each its own mirror
    assert len(src) > 0 and len(selfs) == 8
    assert torch.equal(values[:, dst, 0], values[:, src, 0])
    assert torch.equal(values[:, dst, 1], -values[:, src, 1])
    assert (values[:, selfs, 1] == 0).all()


def test_same_seed_same_inputs():
    cfg = small_config("c2c256_f32", bands=2)
    trip = workload.config_triplets(cfg)
    a = workload.draw_inputs(cfg, trip, 2**33 + 1, "cpu")
    b = workload.draw_inputs(cfg, trip, 2**33 + 1, "cpu")
    c = workload.draw_inputs(cfg, trip, 2**33 + 2, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and a[0].shape == c[0].shape


@pytest.mark.parametrize("name, low, high", [
    ("c2c256_f32", 1e-4, 3e-3),    # TF32: 10 mantissa bits
    ("r2c256_f64", 3e-8, 1e-6)])   # complex64
def test_control_one_precision_below(name, low, high):
    cfg = small_config(name, bands=1)
    trip = workload.config_triplets(cfg)
    values, pot = workload.draw_inputs(cfg, trip, 3, "cpu")
    idx = torch.as_tensor(workload.storage_indices(trip, cfg["dims"]))
    r2c = cfg["transform"] == "r2c"
    ref = dense.reference_pair(values[0], pot, idx, cfg["dims"], r2c)
    ctl = dense.control_pair(values[0], pot, idx, cfg["dims"], r2c)
    err = float(torch.linalg.vector_norm(ctl.double() - ref)
                / torch.linalg.vector_norm(ref))
    assert low < err < high
