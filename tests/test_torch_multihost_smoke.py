"""Real-wire smoke of the port's multihost plan build:
``scripts/torch_multihost_smoke.py --device cpu`` spawns two gloo worker
processes on a localhost store (a free port), each builds the distributed
plan collectively from its own shard's triplets and runs one backward +
forward(FULL); the parent prints ``MULTIHOST SMOKE: OK``. Without a card
and without ``--device cpu`` the script exits 1 with the port's
``DeviceError``."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" \
    / "torch_multihost_smoke.py"


def test_two_process_smoke_on_the_cpu():
    out = subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "MULTIHOST SMOKE: OK"
    for pid in (0, 1):
        assert f"worker {pid}: ok" in out.stdout
        assert f"worker {pid}: process group up, 2 global shards (gloo on " \
               f"cpu)" in out.stdout


def test_without_a_card_it_exits_with_the_device_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("needs a host without a CUDA card")
    spec = importlib.util.spec_from_file_location("torch_multihost_smoke",
                                                  SCRIPT)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.main(None) == 1
    captured = capsys.readouterr()
    assert "DeviceError: no CUDA device" in captured.err
    assert "MULTIHOST SMOKE" not in captured.out
