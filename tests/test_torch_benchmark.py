"""The port's benchmark CLI (``python -m spfft_tpu_torch.benchmark``) on the
CPU (``--cpu``: every kernel wrapper on its plain version), against the
JAX package's CLI (``spfft_tpu.benchmark``) run in this process on the
virtual CPU devices of tests/conftest.py.

* ``cutoff_stick_triplets`` equals the JAX function;
* the CLI runs for C2C and R2C, single and double, ``-m 2``,
  ``--fused-pair``, ``--no-fused``, ``--shards 2``, ``-p host``, a long z
  axis (``-d 8 8 520``) and ``--profile-dir``, writing its JSON;
* its ``parameters`` keys are the JAX CLI's at the same flags, plus
  exactly ``device_kind`` and ``power_limit``;
* the flags outside this slice exit 2 with the typed not-in-slice
  message; without a card and without ``--cpu`` it exits 1 with the
  port's ``DeviceError``.
"""

import json
import os

import numpy as np
import pytest
import torch

from spfft_tpu import benchmark as jbench

from spfft_tpu_torch import benchmark
from spfft_tpu_torch.utils.platform import platform_summary

torch.set_num_threads(2)

#: the keys the port adds to the JAX CLI's parameters
ADDED = {"device_kind", "power_limit"}


@pytest.mark.parametrize("dims,sparsity,hermitian", [
    ((8, 6, 4), 0.5, False), ((8, 6, 4), 1.0, True), ((9, 7, 5), 0.3, True),
    ((16, 16, 16), 0.25, False), ((5, 3, 2), 0.0, True),
    ((12, 10, 8), 2.0, False)])
def test_cutoff_stick_triplets_match_jax(dims, sparsity, hermitian):
    got = benchmark.cutoff_stick_triplets(*dims, sparsity, hermitian)
    want = jbench.cutoff_stick_triplets(*dims, sparsity, hermitian)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _run(flags, tmp_path, name="bench.json"):
    out = tmp_path / name
    assert benchmark.main(["--cpu"] + flags + ["-o", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("flags", [
    ["-d", "16", "-r", "2"],
    ["-d", "16", "-r", "1", "-t", "r2c"],
    ["-d", "12", "-r", "1", "--precision", "double"],
    ["-d", "12", "-r", "1", "-t", "r2c", "--precision", "double"],
    ["-d", "12", "-r", "2", "-m", "2"],
    ["-d", "12", "-r", "1", "--fused-pair"],
    ["-d", "12", "-r", "1", "--no-fused"],
    ["-d", "16", "-r", "1", "--shards", "2"],
    ["-d", "16", "-r", "1", "--shards", "2", "-t", "r2c", "-p", "host"],
    ["-d", "12", "-r", "1", "-p", "host", "-m", "2"],
    ["-d", "8", "8", "520", "-r", "1", "-s", "0.5"],
])
def test_cli_runs(flags, tmp_path, capsys):
    payload = _run(flags, tmp_path)
    params = payload["parameters"]
    assert "timings" in payload
    assert params["pair_seconds"] > 0 and params["backend"] == "cpu"
    assert params["pallas"] is False and params["power_limit"] is None
    assert capsys.readouterr().out  # params + tree printed
    if "520" in flags:  # the long z: the fused kernels decline it
        assert params["fused"] is False
        assert params["fused_fallback"] == {"dec": "dimz_over_cap",
                                            "cmp": "dimz_over_cap"}
    if "--no-fused" in flags:
        assert params["fused"] is False and params["fused_fallback"] == {}


@pytest.mark.parametrize("flags", [
    ["-d", "12", "-r", "1"],
    ["-d", "8", "10", "12", "-r", "1", "-t", "r2c", "-s", "0.5", "-m", "2"],
    ["-d", "16", "-r", "1", "--shards", "2"],
])
def test_parameters_keys_are_the_jax_clis(flags, tmp_path):
    jout = tmp_path / "jax.json"
    assert jbench.main(flags + ["-o", str(jout)]) == 0
    want = json.loads(jout.read_text())["parameters"]
    got = _run(flags, tmp_path)["parameters"]
    assert set(got) == set(want) | ADDED
    for key in ("dim_x", "dim_y", "dim_z", "shards", "num_values",
                "transform_type", "num_transforms", "precision",
                "sparsity", "repeats", "exchange", "proc", "fused_pair",
                "overlap_chunks"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("flags,what", [
    (["--serve"], "--serve"),
    (["--store-dir", "x"], "--store-dir"),
    (["--overlap-chunks", "2", "--shards", "2"], "--overlap-chunks 2"),
    (["-e", "bufferedFloat", "--shards", "2"], "-e bufferedFloat"),
    (["-e", "compact", "--shards", "2"], "-e compact"),
    (["-e", "compactFloat", "--shards", "2"], "-e compactFloat"),
    (["-e", "unbuffered", "--shards", "2"], "-e unbuffered"),
    (["-e", "all", "--shards", "2"], "-e all"),
])
def test_out_of_slice_flags_exit_2(flags, what, capsys):
    assert benchmark.main(["--cpu", "-d", "8"] + flags) == 2
    err = capsys.readouterr().err
    assert f"InvalidParameterError: {what}" in err
    assert "is not in this slice of spfft_tpu_torch" in err


def test_buffered_exchange_and_one_chunk_run(tmp_path):
    params = _run(["-d", "12", "-r", "1", "--shards", "2", "-e", "buffered",
                   "--overlap-chunks", "1"], tmp_path)["parameters"]
    assert params["exchange"] == "buffered" and params["shards"] == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_without_a_card_it_exits_with_the_device_error(capsys):
    assert benchmark.main(["-d", "8", "-r", "1"]) == 1
    assert "DeviceError: no CUDA device" in capsys.readouterr().err


def test_bad_arguments_exit_2(capsys):
    assert benchmark.main(["--cpu", "-d", "8", "8"]) == 2
    assert benchmark.main(["--cpu", "-d", "8", "-m", "0"]) == 2
    assert benchmark.main(["--cpu", "-d", "8", "-r", "0"]) == 2
    with pytest.raises(SystemExit):
        benchmark.main(["--cpu", "-d", "8", "--fused-pair", "-m", "2"])


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    _run(["-d", "8", "-r", "1", "--profile-dir", str(prof)], tmp_path)
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the CPU summary")
def test_platform_summary_on_the_cpu():
    assert platform_summary() == {"backend": "cpu", "device_count": 1,
                                  "device_kind": "cpu", "power_limit": None}
    assert platform_summary("cpu")["backend"] == "cpu"


def test_module_entry_point_runs(tmp_path):
    """``python -m spfft_tpu_torch.benchmark --cpu``, as a user runs it."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "spfft_tpu_torch.benchmark", "--cpu", "-d",
         "8", "-r", "1"], cwd=repo, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout[:res.stdout.index("\n}\n") + 2])[
        "backend"] == "cpu"
