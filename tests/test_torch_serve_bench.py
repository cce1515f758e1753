"""The port's serving benchmark CLI (``python -m
spfft_tpu_torch.serve.bench``) on the CPU against the JAX package's.

Every mode runs on the port with ``--cpu`` (the kernels' plain
versions): ``--smoke``, ``--smoke --control`` with its trace and
Prometheus text, ``--fault-smoke --devices 2`` (the quarantine and
probation phases over two host slots), and the replay at ``--dim 12``
with ``--config``, ``--slo``, ``--metrics-port 0``, ``--high-fraction``,
``--profile-dir``, ``--no-batching`` and ``--verify-sample``. The
payload's keys are the JAX CLI's. The same seed draws the same trace in
both packages, and each request's result is within 1e-6 relative of the
JAX bench's result for it. No CPU throughput bar is asserted.
"""

import json

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import timing as jtiming
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import bench as jbench
from spfft_tpu.serve import executor as jexecutor

from spfft_tpu_torch import faults, obs, timing
from spfft_tpu_torch.control import ServeConfig
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.obs.__main__ import (REQUEST_STAGES,
                                          validate_trace_payload)
from spfft_tpu_torch.serve import bench
from spfft_tpu_torch.serve import executor as texecutor

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tcfg.CONFIG_ENV, raising=False)
    monkeypatch.delenv("SPFFT_TPU_METRICS_PORT", raising=False)

    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.disable()
            o.GLOBAL_TRACER.reset()
            o.GLOBAL_TRACER.set_sample_rate(1.0)
            o.GLOBAL_COUNTERS.reset()
            c.set_global_config(None)
    reset()
    yield
    reset()


def _reset_timers():
    for t in (timing, jtiming):
        t.disable()
        t.GlobalTimer.reset()


@pytest.fixture(autouse=True)
def _timers():
    """Both packages' global timers disabled and empty around each test:
    a test of another file that shares the worker may leave records in
    the JAX timer (``tests/test_serve_executor.py``'s timing test), which
    the JAX bench's ``serve_metrics`` then reports as a ``timings`` key
    the port's payload lacks."""
    _reset_timers()
    yield
    _reset_timers()


def _last_json(capsys):
    out = capsys.readouterr().out
    line = next(ln for ln in reversed(out.splitlines())
                if ln.startswith("{"))
    return json.loads(line), out


REPLAY = ["--dim", "12", "--requests", "12", "--signatures", "3",
          "--threads", "1", "--seed", "5"]


def _recorded(monkeypatch, mod):
    """Record every (values, future) the bench submits to ``mod``'s
    executor, in submit order."""
    seen = []
    orig = mod.ServeExecutor.submit

    def submit(self, signature, values, *a, **kw):
        fut = orig(self, signature, values, *a, **kw)
        seen.append((values, fut))
        return fut
    monkeypatch.setattr(mod.ServeExecutor, "submit", submit)
    return seen


def _complex(x):
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)
    if a.dtype.kind != "c":
        a = a[..., 0] + 1j * a[..., 1]
    return a


def test_replay_keys_trace_and_results_equal_jax(monkeypatch, capsys,
                                                 tmp_path):
    """One thread submits in trace order, so the last ``requests``
    submits are the replay: the same values in both packages (the same
    numpy draws), and results within 1e-6 relative l2 of the JAX
    bench's; the payloads carry the same keys."""
    port_seen = _recorded(monkeypatch, texecutor)
    jax_seen = _recorded(monkeypatch, jexecutor)
    out = tmp_path / "port.json"
    assert bench.main(REPLAY + ["--cpu", "-o", str(out)]) == 0
    port, text = _last_json(capsys)
    assert json.loads(out.read_text()) == port
    assert jbench.main(REPLAY) == 0
    jax_payload, _ = _last_json(capsys)
    assert set(port) == set(jax_payload)
    snap, jsnap = port["serve_metrics"], jax_payload["serve_metrics"]
    assert set(snap) == set(jsnap)
    for key in ("latency_seconds", "latency_seconds_by_class",
                "overhead_seconds", "registry", "health"):
        assert set(snap[key]) == set(jsnap[key]), key
    # the port's platform record adds the card's power limit
    assert set(port["platform"]) - set(jax_payload["platform"]) \
        == {"power_limit"}
    assert port["platform"]["backend"] == "cpu"
    assert snap["completed"] == 12 and snap["failed"] == 0
    assert snap["registry"]["builds"] == 3
    n = 12
    replay_p, replay_j = port_seen[-n:], jax_seen[-n:]
    for i, ((vp, fp), (vj, fj)) in enumerate(zip(replay_p, replay_j)):
        assert np.array_equal(np.asarray(vp), np.asarray(vj)), i
        got, want = _complex(fp.result()), _complex(fj.result())
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-6, (i, rel)
    assert "serial loop" in text and "executor" in text


def test_replay_keys_equal_jax_after_jax_timer_records(monkeypatch, capsys,
                                                       tmp_path):
    """An earlier test of the worker leaves records in the JAX package's
    timer (and its timing on), as a timed JAX executor does; the
    fixture's reset between two tests clears them, and the comparison
    then holds."""
    jtiming.enable()
    with jtiming.GlobalTimer.scoped("left by an earlier test"):
        pass
    assert json.loads(jtiming.GlobalTimer.process().json()).get("timings")
    _reset_timers()  # what the fixture does between the two tests
    assert not jtiming.enabled()
    assert not json.loads(jtiming.GlobalTimer.process().json()).get(
        "timings")
    test_replay_keys_trace_and_results_equal_jax(monkeypatch, capsys,
                                                 tmp_path)


def test_replay_verify_sample_and_options(tmp_path, capsys):
    cfg = ServeConfig()
    cfg.set("batch_window", 0.003, source="tuner")
    cfg.set("max_batch", 4, source="tuner")
    path = tmp_path / "recommended.json"
    cfg.save(str(path))
    prof = tmp_path / "profile"
    rc = bench.main(["--cpu", "--dim", "12", "--requests", "32",
                     "--signatures", "3", "--threads", "4",
                     "--config", str(path), "--high-fraction", "0.3",
                     "--slo", "p99_ms=60000,error_rate=0.5",
                     "--metrics-port", "0", "--profile-dir", str(prof),
                     "--verify-sample", "16"])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert "window=3.0ms" in text and "max_batch=4" in text
    assert "metrics endpoint: http://127.0.0.1:" in text
    assert payload["slo"]["violations"] == []
    assert payload["slo"]["objectives"]["latency_p99_s"] == 60.0
    counts = payload["serve_metrics"]["completed_by_class"]
    assert counts["high"] + counts["normal"] == 32 and counts["high"] > 0
    assert "high  lane p50/p99" in text
    v = payload["verify"]
    assert v["ok"] and len(v["requests"]) == 16 and v["signatures"] == 3
    assert v["launch_check"] == "not on the card"
    assert (prof / "trace.json").is_file()
    # explicit flag beats the artifact
    assert bench.main(["--cpu", "--dim", "12", "--requests", "8",
                       "--signatures", "1", "--threads", "2", "--config",
                       str(path), "--max-batch", "6"]) == 0
    _, text = _last_json(capsys)
    assert "max_batch=6" in text and "window=3.0ms" in text


def test_replay_control_trace_and_prom(tmp_path, capsys):
    trace_file = tmp_path / "trace.json"
    prom_file = tmp_path / "metrics.prom"
    rc = bench.main(["--cpu", "--dim", "12", "--requests", "24",
                     "--signatures", "3", "--threads", "4", "--control",
                     "--control-interval", "0.005", "--trace-out",
                     str(trace_file), "--prom-out", str(prom_file)])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert payload["control"]["steps"] >= 1
    for knob, value in payload["control"]["knobs"].items():
        lo, hi = ServeConfig.bounds(knob)
        assert lo <= value <= hi
    assert payload["obs"]["open_spans"] == 0
    trace = json.loads(trace_file.read_text())
    assert validate_trace_payload(trace, require_names=REQUEST_STAGES) \
        == []
    series = obs.parse_prometheus_text(prom_file.read_text())
    assert series[("spfft_serve_completed_total", ())] == 24
    assert "control:" in text


def test_no_batching_and_bad_args(capsys):
    assert bench.main(["--cpu", "--dim", "12", "--requests", "16",
                       "--signatures", "1", "--threads", "2",
                       "--no-batching"]) == 0
    payload, _ = _last_json(capsys)
    assert payload["serve_metrics"]["fused_batches"] == 0
    assert payload["serve_metrics"]["completed"] == 16
    assert bench.main(["--requests", "0"]) == 2
    assert bench.main(["--high-fraction", "1.5"]) == 2
    assert bench.main(["--fault-rate", "1.5"]) == 2
    assert bench.main(["--verify-sample", "-1"]) == 2
    if not torch.cuda.is_available():
        assert bench.main(["--dim", "12"]) == 1
        assert "DeviceError" in capsys.readouterr().err


def test_fault_rate_degrades_gracefully(capsys):
    rc = bench.main(["--cpu", "--dim", "12", "--requests", "32",
                     "--signatures", "1", "--threads", "4",
                     "--fault-rate", "0.05"])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert payload["fault_rate"] == 0.05 and payload["faults"] is not None
    snap = payload["serve_metrics"]
    health = snap["health"]
    assert snap["completed"] + payload["failed_requests"] == 32
    assert payload["failed_requests"] <= health["retries_exhausted"] \
        + health["no_healthy_device"]
    assert snap["completed"] >= 24
    assert "recovery:" in text and "health:" in text


def test_smoke_pins_and_traces(tmp_path, capsys):
    trace_file = tmp_path / "trace.json"
    prom_file = tmp_path / "metrics.prom"
    rc = bench.main(["--cpu", "--smoke", "--trace-out", str(trace_file),
                     "--prom-out", str(prom_file)])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert payload["smoke"] and payload["ok"] and payload["failures"] == []
    assert payload["pinned_batches"] >= 1
    assert payload["padded_rows_per_wave"][-1] == 0
    assert payload["obs"]["open_spans"] == 0
    trace = json.loads(trace_file.read_text())
    require = REQUEST_STAGES + ("serve.request", "compile.registry_build",
                                "exchange.plan_build")
    assert validate_trace_payload(trace, require_names=require) == []
    names = {e["name"] for e in trace["traceEvents"]
             if e["ph"] in ("X", "i", "C")}
    assert "exchange.chunk_wire_bytes" in names
    series = obs.parse_prometheus_text(prom_file.read_text())
    assert series[("spfft_serve_completed_total", ())] == 30  # 6 x 5
    assert any(name == "spfft_exchange_wire_bytes" for name, _ in series)
    assert "pad rows per wave" in text
    assert jbench.main(["--smoke"]) == 0
    assert set(payload) == set(_last_json(capsys)[0])


def test_smoke_control_closes_the_loop(tmp_path, capsys):
    trace_file = tmp_path / "control_trace.json"
    prom_file = tmp_path / "control.prom"
    rc = bench.main(["--cpu", "--smoke", "--control", "--trace-out",
                     str(trace_file), "--prom-out", str(prom_file)])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert payload["ok"] and payload["failures"] == []
    ctl = payload["control"]
    assert [d for d in ctl["decisions"] if d["knob"] == "batch_window"]
    assert ctl["window_after"] < ctl["window_before"]
    lo, hi = ServeConfig.bounds("batch_window")
    assert lo <= ctl["window_after"] <= hi
    assert payload["slo"]["violations"] == []
    trace = json.loads(trace_file.read_text())
    assert "control.retune" in {e["name"] for e in trace["traceEvents"]
                                if e["ph"] in ("X", "i")}
    series = obs.parse_prometheus_text(prom_file.read_text())
    assert any(name == "spfft_control_decisions_total"
               and ("knob", "batch_window") in labels
               and ("source", "controller") in labels and v >= 1
               for (name, labels), v in series.items())
    assert any(name == "spfft_slo_burn_rate" for name, _ in series)
    assert "control:" in text
    # the scenario's decisions are the JAX scenario's, knob for knob
    assert jbench.main(["--smoke", "--control"]) == 0
    jax_payload = _last_json(capsys)[0]
    assert set(payload) == set(jax_payload)
    assert set(ctl) == set(jax_payload["control"])
    assert [(d["step"], d["knob"], d["old"], d["new"])
            for d in ctl["decisions"]] == \
        [(d["step"], d["knob"], d["old"], d["new"])
         for d in jax_payload["control"]["decisions"]]


def test_fault_smoke_over_two_slots(tmp_path, capsys):
    trace_file = tmp_path / "fault_trace.json"
    rc = bench.main(["--cpu", "--fault-smoke", "--devices", "2",
                     "--trace-out", str(trace_file)])
    assert rc == 0
    payload, text = _last_json(capsys)
    assert payload["fault_smoke"] and payload["ok"]
    assert payload["failures"] == []
    assert payload["obs"]["open_spans"] == 0
    assert set(payload["phases"]) == {
        "1_poisoned_isolated", "2_transient_recovered", "3_quarantine",
        "4_readmission", "5_crash_fails_futures",
        "6_crash_restart_recovers"}
    assert payload["phases"]["3_quarantine"]["quarantines"] == 1
    assert payload["phases"]["4_readmission"]["readmissions"] == 1
    trace = json.loads(trace_file.read_text())
    errored = [e for e in trace["traceEvents"]
               if e["ph"] == "X" and e["args"].get("status") == "error"]
    assert errored and all(e["args"].get("error") for e in errored)
    assert "fault smoke" in text
    # one slot: phases 3-4 are skipped and say why
    assert bench.main(["--cpu", "--fault-smoke"]) == 0
    payload, _ = _last_json(capsys)
    assert payload["ok"]
    assert payload["phases"]["3_quarantine"].startswith("skipped")


def test_pair_layout_bucket_stages_interleaved_rows(monkeypatch):
    """A pair-layout plan's bucket of interleaved host rows stages them
    as they are (no host transpose) and the plan layout transposes the
    batch where it lands (the card): every band equals the serial call
    bit for bit. Rehearsed on the host with a small plan forced into the
    pair layout and a stand-in card plan for the staging decision."""
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import plan as tplan
    from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor
    monkeypatch.setattr(tplan, "PAIR_IO_THRESHOLD", 0)
    n = 8
    from spfft_tpu_torch.benchmark import cutoff_stick_triplets
    trip = cutoff_stick_triplets(n, n, n, 1.0, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, n, n, n, trip,
                                 device="cpu")
    nv = plan.index_plan.num_values
    template = plan.batch_row_template("values")
    assert template[0] == (2, nv)
    rng = np.random.default_rng(1)
    rows = [rng.standard_normal((nv, 2)).astype(np.float32)
            for _ in range(3)]

    class _Card:  # the staging decision reads only these
        device = torch.device("cuda", 0)
    assert ServeExecutor._swapped_row(_Card, "backward", template) \
        == (nv, 2)
    assert ServeExecutor._swapped_row(plan, "backward", template) is None
    assert ServeExecutor._swapped_row(_Card, "forward", template) is None
    assert ServeExecutor._host_row(plan, "backward", rows[0], template,
                                   (nv, 2)) is rows[0]
    # what _stage fills (rows as they are) and _to_device lands
    staged = torch.from_numpy(np.stack(rows))
    batch = ServeExecutor._plan_layout(plan, staged)
    assert tuple(batch.shape) == (3, 2, nv) and batch.is_contiguous()
    out = plan.backward_batched(batch)
    for i, r in enumerate(rows):
        assert torch.equal(out[i], plan.backward(r))
    # a batch already in the plan's layout passes unchanged
    assert ServeExecutor._plan_layout(plan, batch) is batch
    with ServeExecutor(reg, autostart=False) as ex:
        futs = [ex.submit(sig, r) for r in rows]
        ex._drain_once()
        for f, r in zip(futs, rows):
            assert torch.equal(f.result(timeout=30), plan.backward(r))


def test_staging_buffer_keeps_the_plan_row_shape(monkeypatch):
    """An interleaved bucket borrows the pinned buffer as (num_values, 2)
    rows and returns it in the plan's (2, num_values) shape, so a planar
    bucket of the same signature can take it next (the stand-in card plan
    stages into host tensors here)."""
    import spfft_tpu_torch as sp
    from spfft_tpu_torch import plan as tplan
    from spfft_tpu_torch.benchmark import cutoff_stick_triplets
    from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor
    monkeypatch.setattr(tplan, "PAIR_IO_THRESHOLD", 0)
    n = 8
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, n, n, n,
                                 cutoff_stick_triplets(n, n, n, 1.0,
                                                       hermitian=False),
                                 device="cpu")
    nv = plan.index_plan.num_values
    monkeypatch.setattr(ServeExecutor, "_swapped_row", staticmethod(
        lambda p, kind, template: (nv, 2) if kind == "backward" else None))
    rng = np.random.default_rng(2)
    with ServeExecutor(reg, autostart=False) as ex:
        inter = [rng.standard_normal((nv, 2)).astype(np.float32)
                 for _ in range(2)]
        planar = [np.ascontiguousarray(r.T) for r in inter]
        for rows in (inter, planar, inter):
            futs = [ex.submit(sig, r) for r in rows]
            ex._drain_once()
            for f, r in zip(futs, rows):
                assert torch.equal(f.result(timeout=30), plan.backward(r))
        shard_key = next(iter(ex._staging))
        assert all(tuple(e[0].shape[1:]) == (2, nv)
                   for e in ex._staging[shard_key])
