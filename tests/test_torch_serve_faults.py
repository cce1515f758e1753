"""Fault-tolerant serving in the port (``spfft_tpu_torch.serve``) against
the JAX package's executor on the CPU: the same ``FaultPlan`` scripts as
tests/test_serve_faults.py, given to both executors over the same
requests, give the same failing futures, error types, retry /
quarantine / probation / readmission counts and health states; every
healthy request, co-batched with a poisoned or faulted one or not, stays
bit for bit the port plan's serial call.

Scenarios: a poisoned request in a batched bucket; a transient fault at
dispatch, at materialisation and at staging; permanent faults in the
recovery; retry exhaustion on the serial path and the per-priority
budgets; a sick pool device quarantined while the pool serves; a
probation canary readmitting it; an empty pool
(``NoHealthyDeviceError``); a poisoned flood that must not quarantine a
healthy device; the dispatch loop crashing within and past its restart
budget (``ExecutorCrashedError``, zero hangs).
"""

import time

import jax
import numpy as np
import pytest
import torch

from spfft_tpu import TransformType as JTT
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import FaultPlan as JFaultPlan
from spfft_tpu.serve import PlanRegistry as JRegistry
from spfft_tpu.serve import ServeExecutor as JExecutor

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.serve import FaultPlan, PlanRegistry, ServeExecutor

from test_util import random_sparse_triplets

torch.set_num_threads(2)

DIMS = (12, 13, 11)


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        for f, o, c in ((faults, obs, tcfg), (jfaults, jobs, jcfg)):
            f.disarm()
            o.GLOBAL_COUNTERS.reset()
            c.set_global_config(None)
    reset()
    yield
    reset()


# name -> (executor kwargs, script, pool size, waves, seconds to sleep
# between waves, mode). A wave is a list of (payload, priority); "poison"
# is a payload of the wrong length. Mode "drain" drains each wave
# synchronously; "start" starts the dispatcher after the first wave.
SCENARIOS = {
    "poisoned_in_bucket": (
        dict(batch_window=0.0), None, 0,
        [[("good", "normal")] * 2 + [("poison", "normal")]
         + [("good", "normal")] * 2], 0, "drain"),
    "dispatch_transient": (
        dict(batch_window=0.0), "dispatch@1", 0,
        [[("good", "normal")] * 4], 0, "drain"),
    "materialise_transient": (
        dict(batch_window=0.0), "materialise@1", 0,
        [[("good", "normal")] * 4], 0, "drain"),
    "stage_transient": (
        dict(batch_window=0.0), "stage@1", 0,
        [[("good", "normal")] * 3], 0, "drain"),
    "permanent_in_recovery": (
        dict(batch_window=0.0),
        "dispatch@1:permanent,dispatch@3:permanent", 0,
        [[("good", "normal")] * 4], 0, "drain"),
    "serial_retry_exhausted": (
        dict(batching=False), "dispatch@1,dispatch@2", 0,
        [[("good", "normal")]], 0, "drain"),
    "high_budget_survives": (
        dict(batching=False), "dispatch@1,dispatch@2", 0,
        [[("good", "high")]], 0, "drain"),
    "high_budget_exhausts": (
        dict(batching=False), "dispatch@1,dispatch@2,dispatch@3", 0,
        [[("good", "high")]], 0, "drain"),
    "sick_device_quarantined": (
        dict(quarantine_after=2, quarantine_backoff=30.0), "device0@*", 2,
        [[("good", "normal")]] * 8, 0, "drain"),
    "probation_readmits": (
        dict(quarantine_after=1, quarantine_backoff=0.05), "device0@1", 2,
        [[("good", "normal")]] * 2, 0.08, "drain"),
    "empty_pool": (
        dict(quarantine_after=1, quarantine_backoff=30.0), "device0@*", 1,
        [[("good", "normal")]] * 2, 0, "drain"),
    "poisoned_flood": (
        dict(quarantine_after=2, quarantine_backoff=30.0, batching=False),
        None, 2, [[("poison", "normal")]] * 6 + [[("good", "normal")]],
        0, "drain"),
    "poison_kind_is_request_attributed": (
        dict(quarantine_after=1, quarantine_backoff=30.0, batching=False),
        "dispatch@1:poison", 2, [[("good", "normal")]] * 3, 0, "drain"),
    "loop_crash_past_budget": (
        dict(max_dispatch_restarts=0), "loop@1:permanent", 0,
        [[("good", "normal")] * 6], 0, "start"),
    "loop_crash_within_budget": (
        dict(max_dispatch_restarts=2), "loop@1", 0,
        [[("good", "normal")] * 6], 0, "start"),
}

HEALTH_KEYS = ("state", "lifecycle_state", "retries", "retries_exhausted",
               "retries_by_class", "retries_exhausted_by_class",
               "bucket_fallbacks", "quarantines", "probations",
               "readmissions", "no_healthy_device", "dispatcher_crashes",
               "dispatcher_restarts", "request_attributed_failures")


def _run(name, port):
    """One scenario through one package's executor: the outcome of each
    request (its error's type name, or the result) and the health."""
    kw, script, pool, waves, pause, mode = SCENARIOS[name]
    rng = np.random.default_rng(1)
    trip = random_sparse_triplets(rng, DIMS)
    if port:
        reg = PlanRegistry(store=False)
        sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                     precision="double", device="cpu")
        devices = ["cpu"] * pool
        fp = FaultPlan(script=script) if script else None
        ctor = ServeExecutor
    else:
        reg = JRegistry(store=False)
        sig, plan = reg.get_or_build(JTT.C2C, *DIMS, trip,
                                     precision="double")
        devices = jax.devices()[:pool]
        fp = JFaultPlan(script=script) if script else None
        ctor = JExecutor
    vrng = np.random.default_rng(2)
    n = plan.index_plan.num_values
    ex = ctor(reg, autostart=False, devices=devices or None, fault_plan=fp,
              **kw)
    futs = []
    for w, wave in enumerate(waves):
        for payload, prio in wave:
            v = vrng.uniform(-1, 1, (n, 2))
            futs.append((v if payload == "good" else np.zeros(3),
                         ex.submit(sig, v if payload == "good"
                                   else np.zeros(3), priority=prio)))
        if mode == "start":
            ex.start()
        else:
            ex._drain_once()
            if pause and w + 1 < len(waves):
                time.sleep(pause)
    outcomes = []
    for v, f in futs:
        try:
            outcomes.append(("ok", v, f.result(timeout=60)))
        except Exception as exc:
            outcomes.append((type(exc).__name__, v, None))
    h = ex.health()
    ex.close()
    return plan, outcomes, {k: h[k] for k in HEALTH_KEYS}, \
        [d["state"] for d in h["devices"]]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenario_matches_the_jax_executor(name):
    plan, got, health, devs = _run(name, port=True)
    _, want, jhealth, jdevs = _run(name, port=False)
    assert [o[0] for o in got] == [o[0] for o in want]
    assert health == jhealth
    assert devs == jdevs
    # every healthy request bit for bit the port plan's serial call
    for kind, v, res in got:
        if kind == "ok":
            assert torch.equal(res, plan.backward(v))
    if name == "poisoned_in_bucket":
        assert [o[0] for o in got].count("ok") == 4
    if name == "loop_crash_past_budget":
        assert {o[0] for o in got} == {"ExecutorCrashedError"}
        assert health["state"] == "failed"
    if name == "empty_pool":
        assert {o[0] for o in got} == {"NoHealthyDeviceError"}


def test_fault_fuzz_poisoned_and_transient_under_concurrency():
    """Mixed poisoned payloads and scripted transients under a live
    dispatcher: exactly the poisoned requests fail, every healthy one is
    bit for bit its serial call, and no future is left pending. As in the
    JAX package's fuzz the script holds no ``dispatch`` entry: recovery
    re-executions consume dispatch checks, so one could land on a healthy
    request's single retry and rightly exhaust it; stage and materialise
    checks hit whole buckets, whose recovery then runs clean."""
    import threading
    rng = np.random.default_rng(5)
    reg = PlanRegistry(store=False)
    sigs = [reg.get_or_build(sp.TransformType.C2C, *DIMS,
                             random_sparse_triplets(rng, DIMS),
                             precision="double", device="cpu")[0]
            for _ in range(2)]
    ex = ServeExecutor(reg, batch_window=0.001, pin_after=1,
                       fault_plan=FaultPlan(
                           script="stage@2,materialise@3,stage@5,materialise@7"))
    reqs, futs, lock = [], [], threading.Lock()

    def submitter(seed):
        r = np.random.default_rng(seed)
        for _ in range(10):
            sig = sigs[int(r.integers(2))]
            n = reg.get(sig).index_plan.num_values
            bad = r.random() < 0.2
            v = np.zeros(5) if bad else r.uniform(-1, 1, (n, 2))
            f = ex.submit(sig, v, priority="high" if r.random() < 0.3
                          else "normal")
            with lock:
                reqs.append((sig, bad, v))
                futs.append(f)

    threads = [threading.Thread(target=submitter, args=(s,))
               for s in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for (sig, bad, v), f in zip(reqs, futs):
        if bad:
            with pytest.raises(Exception):
                f.result(timeout=60)
        else:
            assert torch.equal(f.result(timeout=60),
                               reg.get(sig).backward(v))
    ex.close()
    assert all(f.done() for f in futs)
    snap = ex.metrics.snapshot()
    assert snap["completed"] + snap["failed"] == len(futs)
    assert snap["failed"] == sum(1 for _, bad, _ in reqs if bad)
