"""``scripts/torch_precision_matrix.py`` on the CPU (the kernels' plain
PyTorch versions) beside the JAX package's ``scripts/precision_matrix.py``
(loaded by path, unchanged, on the suite's CPU platform): the same rows,
seeds and oracle, each row at most its bar (1e-6 single, 2e-11 double);
the adversarial cases; the script's command line, and its exit 1 with the
port's ``DeviceError`` without a card.

The CPU's plain versions compute each axis as a float32 matrix product,
which reads above ``predicted_rel_error`` at 128^3 (``ROADMAP.md`` queue
3): :func:`test_cpu_plain_versions_at_128` pins that excess.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from spfft_tpu_torch import predicted_rel_error

REPO = Path(__file__).resolve().parent.parent


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port = _load("torch_precision_matrix", "scripts/torch_precision_matrix.py")
jax_script = _load("jax_precision_matrix", "scripts/precision_matrix.py")

ROWS = [(n, t, c) for n in (16, 32) for t in ("c2c", "r2c")
        for c in (False, True)]


@pytest.mark.parametrize("n,transform,centered", ROWS)
def test_measure_matches_the_jax_script(monkeypatch, n, transform, centered):
    monkeypatch.delenv("PRECISION", raising=False)
    got = port.measure(n, transform, centered, device="cpu")
    want = jax_script.measure(n, transform, centered)
    assert got <= port.BARS["single"]
    assert want <= port.BARS["single"]
    assert got <= predicted_rel_error("single", n)


@pytest.mark.parametrize("transform", ["c2c", "r2c"])
def test_measure_double(transform):
    err = port.measure(16, transform, True, "double", "cpu")
    assert err <= port.BARS["double"]
    assert err <= predicted_rel_error("double", 16)


@pytest.mark.parametrize("case", port.ADVERSARIAL_CASES)
def test_measure_adversarial(case):
    label, err = port.measure_adversarial(case, "cpu")
    assert label
    assert err <= port.BARS["single"], (label, err)


def test_prime_triplets_are_the_jax_scripts_set():
    import numpy as np
    dims = (7, 11, 13)
    want = np.array([(x, y, z) for x in range(dims[0]) for y in range(dims[1])
                     for z in range(dims[2])
                     if (x * 3 + y * 5 + z * 7) % 4 == 0], np.int64)
    np.testing.assert_array_equal(port._prime_triplets(dims), want)


@pytest.mark.parametrize("transform", ["c2c", "r2c"])
def test_cpu_plain_versions_at_128(transform):
    """The 128^3 sphere on the CPU: under the bar, and within 10 % of
    ``predicted_rel_error`` (3.064e-7), which the float32 matrix products
    of the plain versions pass (3.30e-7 C2C); the kernels on the card and
    the JAX package's CPU plans read 1.6-1.7e-7."""
    err = port.measure(128, transform, True, "single", "cpu")
    assert err <= port.BARS["single"]
    assert err <= 1.1 * predicted_rel_error("single", 128)


def test_main_prints_the_rows(monkeypatch, capsys):
    monkeypatch.setenv("DIMS", "8")
    monkeypatch.setenv("TRANSFORMS", "c2c")
    monkeypatch.delenv("PRECISION", raising=False)
    monkeypatch.delenv("ADVERSARIAL", raising=False)
    assert port.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[:5] == ["dim", "transform", "indexing", "rel_l2",
                                  "<=bar"]
    assert [ln.split()[:3] for ln in out[1:3]] == [
        ["8", "c2c", "positive"], ["8", "c2c", "centered"]]
    assert all(ln.split()[4] == "yes" for ln in out[1:3])
    assert out[-1].startswith("worst: ")


def test_without_a_card_it_exits_with_the_device_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA card")
    assert port.main([]) == 1
    assert "DeviceError: no CUDA device" in capsys.readouterr().err
