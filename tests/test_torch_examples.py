"""The port's example programs (``examples_torch/``) against the JAX
package's (``examples/``), on the CPU.

Every program runs as a process, all of them at once (a module fixture):
the port's with ``--device cpu`` (the kernels' plain PyTorch versions),
the JAX package's on the suite's CPU platform with 8 virtual devices.
Each port program exits 0 and prints what its JAX counterpart prints, on
the same seeds, within the tolerances below; the multihost example also
runs as two processes over a localhost coordinator (gloo). No program of
``examples_torch/`` and no ``scripts/torch_*.py`` imports ``jax`` or the
JAX package, and without a card and without ``--device cpu`` a port
program exits 1 with the port's ``DeviceError``.
"""

import ast
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_EXAMPLES = ("example", "example_scf", "example_poisson",
                 "example_distributed", "example_multihost")
TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _runs() -> dict:
    """label -> argv of every program the tests read."""
    runs = {}
    for name in PORT_EXAMPLES:
        runs[f"jax {name}"] = [str(REPO / "examples" / f"{name}.py")]
        runs[f"port {name}"] = [str(REPO / "examples_torch" / f"{name}.py"),
                                "--device", "cpu"]
    coordinator = f"127.0.0.1:{_free_port()}"
    for pid in (0, 1):
        runs[f"port example_multihost {pid}/2"] = [
            str(REPO / "examples_torch" / "example_multihost.py"),
            "--device", "cpu", "--coordinator", coordinator,
            "--num-processes", "2", "--process-id", str(pid)]
    return runs


@pytest.fixture(scope="module")
def outputs():
    """label -> (exit code, stdout, stderr) of every program, all run side
    by side (two threads each: the runs are small)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {label: subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for label, argv in _runs().items()}
    out = {}
    try:
        for label, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
            out[label] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _ok(outputs, label) -> list:
    rc, stdout, stderr = outputs[label]
    assert rc == 0, f"{label}: exit {rc}\n{stdout[-2000:]}\n{stderr[-2000:]}"
    return stdout.splitlines()


def _pairs(lines, heading) -> list:
    """The 8 value pairs printed under ``heading``."""
    i = lines.index(heading)
    return [tuple(map(float, ln.split(","))) for ln in lines[i + 1:i + 9]]


def test_example_matches_jax(outputs):
    port, jax_ = _ok(outputs, "port example"), _ok(outputs, "jax example")
    assert port[:11] == jax_[:11]  # the dimensions and the input
    for heading in ("After backward transform:",
                    "After forward transform (without scaling):"):
        got, want = _pairs(port, heading), _pairs(jax_, heading)
        assert len(got) == len(want) == 8
        for g, w in zip(got, want):
            assert abs(g[0] - w[0]) <= 1e-5 and abs(g[1] - w[1]) <= 1e-5, \
                (heading, got, want)


def _steps(lines):
    pat = re.compile(r"iter (\d+): \|coeffs\| = ([0-9.]+)")
    return [float(m.group(2)) for m in map(pat.match, lines) if m]


def test_example_scf_matches_jax(outputs):
    port, jax_ = _ok(outputs, "port example_scf"), _ok(outputs,
                                                       "jax example_scf")
    got, want = _steps(port), _steps(jax_)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-5)
    builds = [int(ln.rsplit(" ", 1)[-1]) for ln in port
              if ln.startswith("iter ")]
    assert builds[1:] == [0, 0, 0, 0]
    assert port[-1] == jax_[-1] == "OK"


def test_example_poisson_matches_jax(outputs):
    port = _ok(outputs, "port example_poisson")
    jax_ = _ok(outputs, "jax example_poisson")
    assert port[0] == jax_[0]  # grid and plane-wave count
    assert "17074 plane waves" in port[0]
    for lines in (port, jax_):
        err = float(lines[1].rsplit(" ", 1)[-1])
        assert err < 1e-4
        assert lines[-1] == "OK"


def test_example_distributed_matches_jax(outputs):
    port = _ok(outputs, "port example_distributed")
    jax_ = _ok(outputs, "jax example_distributed")
    assert port[0] == jax_[0] == "17074 sparse values over 8 shards"
    for lines in (port, jax_):
        assert lines[1].startswith("round-trip max error: ")
        assert float(lines[1].rsplit(" ", 1)[-1]) <= 1e-6


def _multihost_err(lines, pid, count):
    line = next(ln for ln in lines if ln.startswith(f"process {pid}/{count}"))
    return float(line.rsplit(" ", 1)[-1])


def test_example_multihost_matches_jax(outputs):
    port = _ok(outputs, "port example_multihost")
    jax_ = _ok(outputs, "jax example_multihost")
    assert _multihost_err(port, 0, 1) < 1e-3
    assert _multihost_err(jax_, 0, 1) < 1e-3
    assert "8 shards" in port[0] and "8 shards" in jax_[0]
    assert port[-1] == jax_[-1] == "OK"


def test_example_multihost_two_processes(outputs):
    for pid in (0, 1):
        lines = _ok(outputs, f"port example_multihost {pid}/2")
        assert _multihost_err(lines, pid, 2) < 1e-3
        assert lines[-1] == "OK"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def _port_programs() -> list:
    return sorted((REPO / "examples_torch").glob("*.py")) \
        + sorted((REPO / "scripts").glob("torch_*.py"))


def test_port_programs_import_neither_jax_nor_the_jax_package():
    programs = _port_programs()
    assert {p.stem for p in programs} >= set(PORT_EXAMPLES) | {
        "torch_precision_matrix", "torch_multihost_smoke"}
    for path in programs:
        bad = {m for m in _imports(path)
               if m.split(".")[0] in ("jax", "jaxlib", "spfft_tpu")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_without_a_card_an_example_exits_with_the_device_error():
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples_torch" / "example_scf.py")],
        cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 1
    assert "DeviceError: no CUDA device" in proc.stderr
    assert "iter 0" not in proc.stdout
