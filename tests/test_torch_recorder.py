"""The port's flight recorder (``spfft_tpu_torch.obs.recorder``) against
the JAX package's: the event registry, the journal and its bounded ring,
tail retention, incident bundles that each package's ``validate_bundle``
accepts from the other, pod bundles, and a capture whose write the
``obs.capture`` fault seam fails (typed, counted, non-fatal)."""

import json
import os

import pytest

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.obs import recorder as jrec

from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.obs import recorder as trec
from spfft_tpu_torch.obs import trace as ttrace

PKGS = ((obs, trec, faults), (jobs, jrec, jfaults))


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for o, r, f in PKGS:
            r.disable_recorder()
            o.disable()
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            o.GLOBAL_TRACER.reset()
            o.reset_recorder()
        tcfg.set_global_config(None)
        jcfg.set_global_config(None)
    reset()
    yield
    reset()


def test_event_specs_equal_jax():
    assert trec.EVENT_SPECS == jrec.EVENT_SPECS
    assert trec.BUNDLE_VERSION == jrec.BUNDLE_VERSION
    for name in ("RECORDER_ENV", "EVENT_BUFFER_ENV", "INCIDENT_DIR_ENV",
                 "DEFAULT_EVENT_BUFFER", "DEFAULT_HOLD", "DEFAULT_RETAIN"):
        assert getattr(trec, name) == getattr(jrec, name)


def _journal(r):
    j = r.EventJournal(capacity=16)
    r_events = [("wire.resolve", {"requested": "int8", "resolved": "bf16",
                                  "probe_error": 0.002}),
                ("wire.decline", {"rung": "int8", "reason": "fault_injected",
                                  "extra": "dropped"}),
                ("fused.demote", {"which": "dec", "reason": "runtime: X",
                                  "permanent": False}),
                ("no.such.kind", {"a": 1})]
    for i in range(6):
        for kind, attrs in r_events:
            j.record(kind, dict(attrs, **({"which": f"d{i}"}
                                          if kind == "fused.demote"
                                          else {})))
    return j


def test_journal_ring_matches_jax():
    tj, jj = _journal(trec), _journal(jrec)
    assert tj.stats() == jj.stats()
    assert tj.stats()["dropped"] == 2 and tj.stats()["buffered"] == 16
    strip = [[{k: v for k, v in e.items() if k != "ts"}
              for e in j.snapshot()] for j in (tj, jj)]
    assert strip[0] == strip[1]
    assert "extra" not in strip[0][0]["attrs"] | strip[0][1]["attrs"]
    assert len(tj.snapshot(limit=3)) == 3
    assert obs.GLOBAL_COUNTERS.snapshot() == jobs.GLOBAL_COUNTERS.snapshot()
    assert obs.GLOBAL_COUNTERS.get("spfft_recorder_events_dropped_total",
                                   reason="undeclared_kind") == 6


def _traffic(o, r):
    """Three request traces (ok, error, flagged) with the recorder on."""
    for name, status in (("ok", "ok"), ("bad", "error"), ("flag", "ok")):
        rt = o.RequestTrace(o.GLOBAL_TRACER, "high", args={"req": name})
        rt.begin("serve.stage")
        rt.close(status=status, error="Boom" if status == "error" else None)
        if name == "flag":
            r.flag_trace(rt.trace_id)
    o.record_event("incident.capture", reason="manual", outcome="test")


def test_retention_and_bundles_validate_across_packages(tmp_path):
    bundles = {}
    for (o, r, _), d in zip(PKGS, ("t", "j")):
        r.enable_recorder(incident_dir=str(tmp_path / d), auto=False)
        assert r.recorder_active() and o.active()
        _traffic(o, r)
        kept = r.retained_traces()
        assert [t["reason"] for t in kept] == ["error", "flagged"]
        b = r.build_incident_bundle("manual:test", host="h0")
        assert r.validate_bundle(b) == []
        bundles[d] = b
    for b in bundles.values():  # each package accepts the other's
        assert trec.validate_bundle(b) == []
        assert jrec.validate_bundle(b) == []
    tb, jb = bundles["t"], bundles["j"]
    assert set(tb) == set(jb)
    assert [e["kind"] for e in tb["events"]] == \
        [e["kind"] for e in jb["events"]]
    assert tb["config"]["knobs"] == jb["config"]["knobs"]
    pod = trec.merge_pod_bundle("lane_death", {"a": tb, "b": jb,
                                               "c": {"error": "down"}})
    assert trec.validate_bundle(pod) == [] == jrec.validate_bundle(pod)
    broken = dict(tb, version=99, events=[{"kind": "nope"}])
    assert trec.validate_bundle(broken) == jrec.validate_bundle(broken)
    assert len(trec.validate_bundle(broken)) == 2
    assert trec.validate_bundle([]) == ["bundle is not a JSON object"]


def test_capture_with_obs_capture_faulted(tmp_path):
    """The ``obs.capture`` seam fails the first write: the capture
    returns None, counts a failure and journals it; the next one writes
    a bundle that validates; the directory is kept to ``keep``."""
    d = tmp_path / "incidents"
    trec.enable_recorder(incident_dir=str(d), keep=2, auto=False)
    faults.arm(faults.FaultPlan(script="obs.capture@1"))
    try:
        assert trec.capture_incident("manual:one") is None
        paths = [trec.capture_incident(f"manual:{i}") for i in range(3)]
    finally:
        faults.disarm()
    assert all(paths) and not any(p.endswith(".tmp") for p in paths)
    assert sorted(os.listdir(d)) == sorted(os.path.basename(p)
                                           for p in paths[1:])
    with open(paths[-1]) as f:
        bundle = json.load(f)
    assert trec.validate_bundle(bundle) == []
    assert jrec.validate_bundle(bundle) == []
    c = obs.GLOBAL_COUNTERS
    assert c.get("spfft_recorder_incident_failures_total") == 1
    assert c.get("spfft_recorder_incidents_total", trigger="manual") == 3
    outcomes = [e["attrs"]["outcome"] for e in trec.GLOBAL_JOURNAL.snapshot()
                if e["kind"] == "incident.capture"]
    assert outcomes[0] == "failed: InjectedFault"
    assert outcomes[1:] == ["written"] * 3
    fired = [e["attrs"] for e in trec.GLOBAL_JOURNAL.snapshot()
             if e["kind"] == "fault.fired"]
    assert fired == [{"site": "obs.capture", "kind": "transient"}]


def test_auto_capture_debounce_and_env(tmp_path, monkeypatch):
    trec.enable_recorder(incident_dir=str(tmp_path), min_interval_s=3600)
    assert trec.maybe_auto_capture("slo_alert", "p99") is not None
    assert trec.maybe_auto_capture("slo_alert", "p99") is None  # debounced
    trec.disable_recorder()
    assert trec.maybe_auto_capture("slo_alert") is None  # disarmed
    assert not ttrace._force_sample
    monkeypatch.setenv(trec.RECORDER_ENV, "1")
    assert trec.recorder_from_env() and trec.recorder_active()
    stats = trec.recorder_stats()
    assert stats["active"] and set(stats) >= {"buffered", "holding",
                                              "retained"}


def test_overhead_probe_reports_both_paths():
    out = trec.overhead_probe(requests=50, repeats=2)
    assert set(out) == set(jrec.overhead_probe(requests=5, repeats=1))
    assert out["off_us"] >= 0 and out["on_us"] > 0
    assert not obs.active()
