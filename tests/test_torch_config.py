"""The port's control config (``spfft_tpu_torch.control.config``) against
the JAX package's: the same knob table, the same clamping and decision
records for the same writes, and the JSON artifact carried across both
ways (a JAX ``ServeConfig.save`` loads in the port to the same snapshot,
and the reverse). The distributed plan reads its knobs' defaults from the
process-global config."""

import json

import numpy as np
import pytest
import torch

from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg

import spfft_tpu_torch as sp
from spfft_tpu_torch import control, obs
from spfft_tpu_torch.control import config as tcfg

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(tcfg.CONFIG_ENV, raising=False)
    for c, o in ((tcfg, obs), (jcfg, jobs)):
        c.set_global_config(None)
        o.GLOBAL_COUNTERS.reset()
        o.reset_recorder()
    yield
    for c, o in ((tcfg, obs), (jcfg, jobs)):
        c.set_global_config(None)
        o.GLOBAL_COUNTERS.reset()
        o.reset_recorder()


def test_knob_table_equals_jax():
    assert tcfg.CONFIG_ENV == jcfg.CONFIG_ENV
    assert (tcfg.ARTIFACT_KEY, tcfg.ARTIFACT_VERSION) == \
        (jcfg.ARTIFACT_KEY, jcfg.ARTIFACT_VERSION)
    assert tcfg.HISTORY_LIMIT == jcfg.HISTORY_LIMIT
    assert tcfg.PATH_SETTINGS == jcfg.PATH_SETTINGS
    assert list(tcfg.KNOB_SPECS) == list(jcfg.KNOB_SPECS)
    assert len(tcfg.KNOB_SPECS) == 25
    for name, spec in tcfg.KNOB_SPECS.items():
        j = jcfg.KNOB_SPECS[name]
        assert (spec.name, spec.default, spec.lo, spec.hi, spec.kind,
                spec.signal, spec.doc) == (j.name, j.default, j.lo, j.hi,
                                           j.kind, j.signal, j.doc)
    import spfft_tpu.control as jcontrol
    assert control.__all__ == jcontrol.__all__


WRITES = [("batch_window", 0.5, "r1", "controller"),
          ("batch_window", 0.05, "r2", "controller"),
          ("max_batch", 0, "r3", "manual"),
          ("max_batch", 0, "again", "manual"),     # no move: no record
          ("overlap_chunks", 3.7, "r4", "boot"),
          ("wire_precision", 9, "r5", "manual"),
          ("wire_error_budget", 1e-9, "r6", "manual"),
          ("registry_max_bytes", 1, "r7", "manual"),
          ("execute_timeout_ms", 250, "r8", "controller")]


def _drive(mod):
    cfg = mod.ServeConfig({"pin_after": 5})
    out = [cfg.set(name, v, reason=r, source=src)
           for name, v, r, src in WRITES]
    out.append(cfg.update({"max_queue": 10 ** 9, "lease_ttl_ms": 10},
                          reason="bulk"))
    return cfg, out


def test_clamping_and_decisions_equal_jax():
    tc, tout = _drive(tcfg)
    jc, jout = _drive(jcfg)
    assert tout == jout
    assert tc.snapshot() == jc.snapshot()
    assert tc.decisions() == jc.decisions()
    for src in (None, "controller", "manual", "boot", "init"):
        assert tc.decision_count(src) == jc.decision_count(src)
    assert obs.GLOBAL_COUNTERS.snapshot() == jobs.GLOBAL_COUNTERS.snapshot()
    assert [(e["kind"], e["attrs"]) for e in obs.GLOBAL_JOURNAL.snapshot()] \
        == [(e["kind"], e["attrs"]) for e in jobs.GLOBAL_JOURNAL.snapshot()]
    assert tc.get("overlap_chunks") == tc.overlap_chunks == 3
    assert tcfg.ServeConfig.bounds("wire_precision") == (0, 3)
    for bad in (lambda c: c.get("nosuch"), lambda c: c.set("nosuch", 1),
                lambda c: c.update({"max_batch": 2, "nosuch": 1}),
                lambda c: c.set_path("nosuch", "x")):
        with pytest.raises(sp.InvalidParameterError):
            bad(tc)
        with pytest.raises(jcfg.InvalidParameterError):
            bad(jc)
    with pytest.raises(AttributeError):
        tc.nosuch


def test_jax_artifact_loads_in_the_port_and_back(tmp_path):
    jc, _ = _drive(jcfg)
    jc.set_path("plan_store_path", "/var/plans")
    path = tmp_path / "jax.json"
    jc.save(str(path), provenance={"tuner": "offline"})
    tc = tcfg.ServeConfig.load(str(path))
    assert tc.snapshot() == jc.snapshot()
    assert tc.paths() == jc.paths()
    assert tc.plan_store_path == "/var/plans"
    # and the port's artifact loads in the JAX package
    back = tmp_path / "port.json"
    tc.save(str(back))
    assert json.loads(back.read_text())["spfft_tpu_serve_config"] == 1
    assert jcfg.ServeConfig.load(str(back)).snapshot() == tc.snapshot()
    assert tc.to_artifact({"x": 1})["provenance"] == {"x": 1}


@pytest.mark.parametrize("payload", [
    "not json", json.dumps({"values": {}}),
    json.dumps({"spfft_tpu_serve_config": 1}),
    json.dumps({"spfft_tpu_serve_config": 1, "values": {"nosuch": 1}}),
    json.dumps({"spfft_tpu_serve_config": 1, "values": {},
                "paths": ["x"]})])
def test_bad_artifacts_refused_in_both(tmp_path, payload):
    path = tmp_path / "bad.json"
    path.write_text(payload)
    with pytest.raises(sp.InvalidParameterError):
        tcfg.ServeConfig.load(str(path))
    with pytest.raises(jcfg.InvalidParameterError):
        jcfg.ServeConfig.load(str(path))


def test_global_config_boots_from_the_environment(tmp_path, monkeypatch):
    cfg = tcfg.ServeConfig({"overlap_chunks": 2, "wire_precision": 1})
    path = tmp_path / "boot.json"
    cfg.save(str(path))
    monkeypatch.setenv(tcfg.CONFIG_ENV, str(path))
    g = tcfg.global_config()
    assert g is tcfg.global_config()
    assert (g.overlap_chunks, g.wire_precision) == (2, 1)
    assert g.decision_count("boot") == 2
    tcfg.set_global_config(None)
    monkeypatch.delenv(tcfg.CONFIG_ENV)
    assert tcfg.global_config().overlap_chunks == 1


def test_distributed_plan_reads_its_knobs_from_the_global_config():
    """Without an argument or an environment variable the distributed
    plan takes overlap_chunks and the wire knobs from global_config();
    a caller's argument still wins."""
    from test_distributed import split_by_sticks, split_planes
    from test_util import random_sparse_triplets

    dims = (8, 8, 8)
    trip = random_sparse_triplets(np.random.default_rng(3), dims)
    parts = split_by_sticks(trip, dims, [1, 1])
    planes = split_planes(8, [1, 1])

    def plan(**kw):
        return sp.make_distributed_plan(sp.TransformType.C2C, *dims, parts,
                                        planes, device="cpu", **kw)

    base = plan()
    assert (base.overlap_chunks, base.wire_rung_requested,
            base.wire_error_budget) == (1, 0, 0.01)
    tcfg.set_global_config(tcfg.ServeConfig(
        {"overlap_chunks": 2, "wire_precision": 2,
         "wire_error_budget": 0.5}))
    knobbed = plan()
    assert (knobbed.overlap_chunks, knobbed.wire_rung_requested,
            knobbed.wire_error_budget) == (2, 2, 0.5)
    assert knobbed.wire_rung_name == "bf16"
    assert plan(overlap_chunks=1, wire_precision=0).overlap_chunks == 1
