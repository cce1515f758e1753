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
* every ``-e`` exchange and ``--overlap-chunks K`` run, with the JAX
  CLI's keys (``-e all``: its ``exchange_sweep`` rows, key for key);
* ``--serve`` (the serving layer: ``params["serve"]``, the executor's
  metrics snapshot) and ``--store-dir`` (``cold_start_ms`` in this
  process, ``warm_start_ms`` from a fresh prewarm process with
  ``warm_builds == 0``) run at ``-d 16`` with the JAX CLI's keys;
* the serving modules and the store's CLI import with ``jax`` blocked
  and load no module of the JAX package;
* without a card and without ``--cpu`` it exits 1 with the port's
  ``DeviceError``.
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


@pytest.mark.parametrize("flags", [
    ["--overlap-chunks", "2", "--shards", "2"],
    ["-e", "bufferedFloat", "--shards", "2"],
    ["-e", "compact", "--shards", "2"],
    ["-e", "compactFloat", "--shards", "2"],
    ["-e", "unbuffered", "--shards", "2"],
    ["-e", "all", "--shards", "2"],
], ids=["overlap_chunks", "bufferedFloat", "compact", "compactFloat",
        "unbuffered", "all"])
def test_exchange_flags_run_with_the_jax_clis_keys(flags, tmp_path):
    """Every exchange flag exits 0; its JSON has the JAX CLI's keys at the
    same flags (plus ``device_kind`` and ``power_limit``) and the same
    values of the workload's keys; ``-e all`` its ``exchange_sweep``
    rows, one per exchange, key for key and with the JAX CLI's wire
    bytes."""
    argv = ["-d", "8", "-r", "1"] + flags
    jout = tmp_path / "jax.json"
    assert jbench.main(argv + ["-o", str(jout)]) == 0
    want = json.loads(jout.read_text())
    got = _run(argv, tmp_path)
    if "all" in flags:
        assert set(got["parameters"]) == set(want["parameters"]) | ADDED
        rows, jrows = got["exchange_sweep"], want["exchange_sweep"]
        assert [r["exchange"] for r in rows] == \
            [r["exchange"] for r in jrows]
        for r, j in zip(rows, jrows):
            assert set(r) == set(j)
            for key in ("overlap_chunks", "wire_total_bytes",
                        "busiest_link_bytes", "hermitian_trimmed",
                        "folded_mirror_values"):
                assert r[key] == j[key], (r["exchange"], key)
        return
    assert set(got["parameters"]) == set(want["parameters"]) | ADDED
    for key in ("shards", "exchange", "overlap_chunks", "num_values"):
        assert got["parameters"][key] == want["parameters"][key], key


@pytest.mark.parametrize("flags", [
    ["--serve"],
    ["--serve", "-m", "3", "-p", "host", "-t", "r2c"],
    ["--store-dir", "STORE"],
    ["--store-dir", "STORE", "--no-fused", "--precision", "double"],
], ids=["serve", "serve_m3_host_r2c", "store_dir", "store_dir_two_kernel"])
def test_serve_and_store_dir_have_the_jax_clis_keys(flags, tmp_path):
    """``--serve`` and ``--store-dir`` at ``-d 16`` on the CPU: the JAX
    CLI's keys at the same flags (``serve``: its metrics snapshot's keys,
    the registry's counters among them; the store's cold / warm pair),
    every request completed and a warm boot with no build."""
    argv = ["-d", "16", "-r", "2"] + [
        str(tmp_path / "jax_store") if f == "STORE" else f for f in flags]
    jargv = [f for f in argv if f not in ("--no-fused",)]
    jout = tmp_path / "jax.json"
    assert jbench.main(jargv + ["-o", str(jout)]) == 0
    want = json.loads(jout.read_text())["parameters"]
    argv = [str(tmp_path / "port_store") if a == str(tmp_path / "jax_store")
            else a for a in argv]
    got = _run(argv, tmp_path)["parameters"]
    assert set(got) == set(want) | ADDED
    if "--serve" in flags:
        serve, jserve = got["serve"], want["serve"]
        assert set(serve) == set(jserve)
        for key in ("health", "overhead_seconds", "latency_seconds",
                    "registry"):
            assert set(serve[key]) == set(jserve[key]), key
        m = got["num_transforms"]
        assert serve["completed"] == jserve["completed"] == 2 * m * 3
        assert serve["failed"] == 0
        assert serve["health"]["bucket_fallbacks"] == 0
        if m > 1:
            assert serve["fused_batches"] > 0
    else:
        for key in ("cold_start_ms", "warm_start_ms"):
            assert set(got[key]) == set(want[key])
            assert got[key]["value"] > 0
        assert got["store_was_cold"] and got["warm_builds"] == 0
        assert got["warm_store"]["hits"] == 1
        assert got["warm_store"]["rejects"] == {}


def test_serving_modules_import_without_jax():
    """``spfft_tpu_torch.serve``, ``spfft_tpu_torch.net.blobstore``, the
    store's CLI, the pod (``serve.cluster``, its names through
    ``spfft_tpu_torch.serve``) and ``spfft_tpu_torch.net.{frame,
    membership,transport,agent,smoke}``, in a process where ``import
    jax`` fails: no module of the JAX package is loaded."""
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import spfft_tpu_torch.serve as s\n"
        "import spfft_tpu_torch.net.blobstore as b\n"
        "import spfft_tpu_torch.serve.store as st\n"
        "from spfft_tpu_torch.serve import PlanArtifactStore\n"
        "import spfft_tpu_torch.serve.cluster\n"
        "from spfft_tpu_torch.serve import (PodFrontend, HostLane,\n"
        "    LoopbackTransport, load_score, simulate_routing)\n"
        "import spfft_tpu_torch.net.frame\n"
        "import spfft_tpu_torch.net.membership\n"
        "import spfft_tpu_torch.net.transport\n"
        "import spfft_tpu_torch.net.agent\n"
        "import spfft_tpu_torch.net.smoke\n"
        "try:\n"
        "    st.main(['verify', sys.argv[1], '--json'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m == 'spfft_tpu'\n"
        "             or m.startswith('spfft_tpu.'))\n"
        "assert sys.modules['jax'] is None, 'jax was imported'\n"
        "print('LOADED', bad)\n")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run([sys.executable, "-c", code, d], cwd=repo,
                             capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr
    assert "LOADED []" in res.stdout


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
