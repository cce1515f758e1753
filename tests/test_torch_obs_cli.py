"""The port's observability CLI (``python -m spfft_tpu_torch.obs``) on
the CPU against the JAX package's.

``validate_trace_payload`` gives the JAX package's verdicts on the same
payloads (well-formed and broken ones, a trace the JAX bench exported
and one the port's demo exported); ``demo --cpu`` writes a trace that
``validate --require-request-stages`` accepts and Prometheus text that
``prom FILE`` round-trips; ``incident --peer`` gathers a port
``HostAgent``'s bundle over loopback TCP into a pod bundle that
``incident --validate`` accepts.
"""

import copy
import json

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.obs import __main__ as jcli
from spfft_tpu.serve.bench import main as jbench

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.obs import __main__ as cli
from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for f, o in ((faults, obs), (jfaults, jobs)):
            f.disarm()
            o.disable()
            o.GLOBAL_TRACER.reset()
            o.GLOBAL_COUNTERS.reset()
            o.reset_recorder()
    reset()
    yield
    reset()


def test_request_stages_equal_jax():
    assert cli.REQUEST_STAGES == jcli.REQUEST_STAGES


def _variants(payload):
    """The payload and broken copies of it, one fault each."""
    out = [payload, {}, {"traceEvents": []}, {"traceEvents": "x"}]
    evs = payload["traceEvents"]
    x = next(i for i, e in enumerate(evs) if e.get("ph") == "X")
    for mutate in (lambda e: e.update(ph="Q"), lambda e: e.pop("ts"),
                   lambda e: e.update(name=7), lambda e: e.update(dur=-1),
                   lambda e: e.update(dur="1")):
        bad = copy.deepcopy(payload)
        mutate(bad["traceEvents"][x])
        out.append(bad)
    bad = copy.deepcopy(payload)
    bad["traceEvents"].append({"ph": "M", "name": "thread_name",
                               "tid": 987654, "args": {"name": "empty"}})
    out.append(bad)
    bad = copy.deepcopy(payload)
    bad.setdefault("otherData", {})["tracer"] = {"open": 3}
    out.append(bad)
    return out


def _verdicts(payload):
    requires = [(), cli.REQUEST_STAGES, ("no.such.span",)]
    return [[cli.validate_trace_payload(p, require_names=r)
             for r in requires] for p in _variants(payload)], \
        [[jcli.validate_trace_payload(p, require_names=r)
          for r in requires] for p in _variants(payload)]


def test_validate_verdicts_equal_jax_on_both_packages_traces(tmp_path,
                                                             capsys):
    jtrace = tmp_path / "jax.json"
    assert jbench(["--smoke", "--trace-out", str(jtrace)]) == 0
    ptrace = tmp_path / "port.json"
    assert cli.main(["demo", "--cpu", "--trace-out", str(ptrace)]) == 0
    capsys.readouterr()
    for path in (jtrace, ptrace):
        payload = json.loads(path.read_text())
        port, jax = _verdicts(payload)
        assert port == jax
        assert port[0][1] == []  # every request stage is in both traces
        assert sum(1 for row in port if any(row)) >= 9
    for path in (jtrace, ptrace):
        assert cli.main(["validate", str(path),
                         "--require-request-stages"]) == 0
        assert jcli.main(["validate", str(path),
                          "--require-request-stages"]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli.main(["validate", str(bad)]) == 1 == jcli.main(
        ["validate", str(bad)])


def test_demo_validate_and_prom_round_trip(tmp_path, capsys):
    trace = tmp_path / "demo.json"
    prom = tmp_path / "demo.prom"
    assert cli.main(["demo", "--cpu", "--dim", "10", "--requests", "8",
                     "--trace-out", str(trace), "--prom-out",
                     str(prom)]) == 0
    out = capsys.readouterr().out
    assert "ui.perfetto.dev" in out
    assert cli.main(["validate", str(trace), "--require-request-stages",
                     "--require-stage", "exchange.plan_build",
                     "--require-stage", "compile.registry_build"]) == 0
    payload = json.loads(trace.read_text())
    assert payload["otherData"]["tracer"]["open"] == 0
    assert cli.main(["prom", str(prom)]) == 0
    assert "series" in capsys.readouterr().out
    series = obs.parse_prometheus_text(prom.read_text())
    assert series[("spfft_serve_completed_total", ())] == 8
    assert any(name == "spfft_exchange_wire_bytes" for name, _ in series)
    assert jcli.main(["prom", str(prom)]) == 0  # the JAX parser reads it
    bad = tmp_path / "bad.prom"
    bad.write_text("spfft_x{le=\n")
    assert cli.main(["prom", str(bad)]) == 1
    assert cli.main(["prom"]) == 0
    if not torch.cuda.is_available():
        assert cli.main(["demo"]) == 1
        assert "DeviceError" in capsys.readouterr().err


def test_incident_peer_over_loopback(tmp_path, capsys):
    from spfft_tpu_torch.net.agent import HostAgent
    n = 8
    from spfft_tpu_torch.benchmark import cutoff_stick_triplets
    trip = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, n, n, n, trip,
                                 device="cpu")
    ex = ServeExecutor(reg)
    agent = HostAgent("peer0", ex).start()
    try:
        rng = np.random.default_rng(0)
        v = rng.standard_normal((plan.index_plan.num_values, 2)).astype(
            np.float32)
        assert torch.equal(ex.submit(sig, v).result(timeout=60),
                           plan.backward(v))
        inc = tmp_path / "incidents"
        assert cli.main(["incident", "--dir", str(inc), "--reason",
                         "test", "--host", "front", "--peer",
                         f"peer0=127.0.0.1:{agent.port}", "--peer",
                         "127.0.0.1:1"]) == 0
        out = capsys.readouterr().out
        path = out.strip().splitlines()[-1].split("wrote ", 1)[1]
        bundle = json.loads(open(path).read())
        assert bundle["kind"] == "pod"
        assert {"front", "peer0", "127.0.0.1:1"} <= set(bundle["hosts"])
        assert "error" in bundle["hosts"]["127.0.0.1:1"]
        assert "error" not in bundle["hosts"]["peer0"]
        assert obs.validate_bundle(bundle) == []
        assert jobs.validate_bundle(bundle) == []
        assert cli.main(["incident", "--validate", path]) == 0
        assert "pod bundle" in capsys.readouterr().out
        assert jcli.main(["incident", "--validate", path]) == 0
        # a capture of this process alone
        assert cli.main(["incident", "--dir", str(inc)]) == 0
        assert cli.main(["incident", "--validate",
                         str(tmp_path / "none.json")]) == 1
    finally:
        agent.close()
        ex.close()
