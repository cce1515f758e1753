"""The port's plan registry (``spfft_tpu_torch.serve.registry``) against
the JAX package's (``spfft_tpu.serve.registry``) on the CPU.

* ``index_digest``, ``signature_for`` and ``PlanSignature.of_plan`` give
  the JAX package's digest and signature EXACTLY for the same triplets:
  C2C random and centered sets, R2C sets with folded (``value_conj``)
  columns, single and double precision, both scalings;
* the same request sequence leaves both registries with the same LRU
  order and the same ``stats()`` keys and counts (the byte counts are
  each package's own device bytes);
* the single-flight build builds once under 8 threads, and a failing
  build releases every follower with the builder's error;
* the raw-bytes memo, ``warmup`` (with the zero-valued execution) and
  the byte-aware eviction over ``estimated_device_bytes``.
"""

import threading

import numpy as np
import pytest
import torch

from spfft_tpu import TransformType as JTT
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import registry as jreg

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.indexing import build_index_plan
from spfft_tpu_torch.serve import registry as treg

from test_torch_r2c import _fold_some
from test_util import (center_triplets, hermitian_triplets,
                       random_sparse_triplets)

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


CASES = {
    "c2c": lambda rng: (sp.TransformType.C2C, DIMS,
                        random_sparse_triplets(rng, DIMS)),
    "c2c_centered": lambda rng: (sp.TransformType.C2C, DIMS,
                                 center_triplets(random_sparse_triplets(
                                     rng, DIMS), DIMS)),
    "r2c_folded": lambda rng: (sp.TransformType.R2C, (12, 10, 9),
                               _fold_some(hermitian_triplets(
                                   rng, (12, 10, 9)), (12, 10, 9), rng)),
    "r2c_odd": lambda rng: (sp.TransformType.R2C, (9, 11, 8),
                            hermitian_triplets(rng, (9, 11, 8), False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("precision,scaling", [("single", "none"),
                                               ("double", "full")])
def test_digest_and_signature_equal_the_jax_package(case, precision,
                                                    scaling):
    ttype, dims, trip = CASES[case](np.random.default_rng(7))
    from spfft_tpu.indexing import build_index_plan as jbuild
    tip = build_index_plan(ttype, *dims, trip)
    jip = jbuild(JTT(ttype.value), *dims, trip)
    if case.startswith("r2c_folded"):
        assert tip.value_conj is not None and tip.value_conj.any()
    assert treg.index_digest(tip) == jreg.index_digest(jip)
    tsig = treg.signature_for(ttype, *dims, trip, precision=precision,
                              scaling=sp.Scaling(scaling))
    jsig = jreg.signature_for(JTT(ttype.value), *dims, trip,
                              precision=precision, scaling=scaling)
    assert tsig.__dict__ == jsig.__dict__
    plan = sp.TransformPlan(tip, precision=precision, device="cpu")
    assert treg.PlanSignature.of_plan(plan, sp.Scaling(scaling)) == tsig


def test_signature_invariant_to_spelling_not_to_order():
    rng = np.random.default_rng(3)
    wrapped = random_sparse_triplets(rng, DIMS)
    centered = center_triplets(wrapped, DIMS)
    a = treg.signature_for(sp.TransformType.C2C, *DIMS, wrapped)
    b = treg.signature_for(sp.TransformType.C2C, *DIMS, centered)
    c = treg.signature_for(sp.TransformType.C2C, *DIMS, wrapped[::-1])
    assert a == b and a != c


def _sequence(mod, reg, tt, sets, order):
    """Resolve ``order`` (indices into ``sets``) through ``reg``; the
    signatures in request order."""
    out = []
    for i in order:
        kwargs = {"device": "cpu"} if mod is treg else {}
        sig, _ = reg.get_or_build(tt, *DIMS, sets[i], precision="single",
                                  **kwargs)
        out.append(sig)
    return out


def test_lru_order_and_stats_equal_the_jax_registry():
    rng = np.random.default_rng(11)
    sets = [random_sparse_triplets(rng, DIMS) for _ in range(4)]
    order = [0, 1, 0, 2, 3, 1, 1, 0, 3]
    treg_ = treg.PlanRegistry(max_plans=3, store=False)
    jreg_ = jreg.PlanRegistry(max_plans=3, store=False)
    tsigs = _sequence(treg, treg_, sp.TransformType.C2C, sets, order)
    jsigs = _sequence(jreg, jreg_, JTT.C2C, sets, order)
    assert [s.__dict__ for s in tsigs] == [s.__dict__ for s in jsigs]
    assert [s.__dict__ for s in treg_.signatures()] == \
        [s.__dict__ for s in jreg_.signatures()]
    ts, js = treg_.stats(), jreg_.stats()
    assert set(ts) == set(js)
    bytes_keys = {"bytes_in_use", "max_bytes", "sig_memo_bytes"}
    assert {k: v for k, v in ts.items() if k not in bytes_keys} == \
        {k: v for k, v in js.items() if k not in bytes_keys}
    assert ts["bytes_in_use"] == sum(
        treg_.get(s).estimated_device_bytes() for s in treg_.signatures())


def test_singleflight_builds_once_under_eight_threads(monkeypatch):
    rng = np.random.default_rng(5)
    trip = random_sparse_triplets(rng, DIMS)
    reg = treg.PlanRegistry(store=False)
    calls = []
    real = treg.build_index_plan
    gate = threading.Event()

    def slow_build(*a, **k):
        calls.append(1)
        gate.wait(5)
        return real(*a, **k)

    monkeypatch.setattr(treg, "build_index_plan", slow_build)
    out = [None] * 8
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait()
        out[i] = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                  device="cpu")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(30)
    assert len(calls) == 1
    assert all(o[1] is out[0][1] for o in out)
    st = reg.stats()
    assert st["builds"] == 1 and st["build_failures"] == 0
    assert st["hits"] == 7


def test_failed_build_releases_every_follower():
    rng = np.random.default_rng(6)
    trip = random_sparse_triplets(rng, DIMS)
    reg = treg.PlanRegistry(store=False)
    faults.arm(faults.FaultPlan(script="registry.build@1:permanent"))
    errors = []
    barrier = threading.Barrier(4)

    def worker():
        barrier.wait()
        try:
            reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                             device="cpu")
        except faults.InjectedFault as exc:
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    faults.disarm()
    # the builder's error reached every caller that waited on its flight;
    # a caller arriving after the flight retired built afresh
    assert errors and reg.stats()["build_failures"] == 1
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                 device="cpu")
    assert plan is reg.get(sig)


def test_memo_fast_path_skips_the_index_build(monkeypatch):
    rng = np.random.default_rng(8)
    trip = random_sparse_triplets(rng, DIMS)
    reg = treg.PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                 device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the memo hit rebuilt the index plan")

    monkeypatch.setattr(treg, "build_index_plan", refuse)
    sig2, plan2 = reg.get_or_build(sp.TransformType.C2C, *DIMS,
                                   trip.copy(), device="cpu")
    assert sig2 == sig and plan2 is plan
    assert reg.stats()["fast_hits"] == 1


def test_warmup_runs_each_plan_and_matches_jax_signatures():
    rng = np.random.default_rng(9)
    specs = [{"transform_type": sp.TransformType.C2C, "dim_x": 12,
              "dim_y": 13, "dim_z": 11,
              "triplets": random_sparse_triplets(rng, DIMS)},
             {"transform_type": sp.TransformType.R2C, "dim_x": 12,
              "dim_y": 10, "dim_z": 9, "precision": "double",
              "triplets": hermitian_triplets(rng, (12, 10, 9))}]
    reg = treg.PlanRegistry(store=False)
    sigs = reg.warmup([dict(s, device="cpu") for s in specs], compile=True)
    jr = jreg.PlanRegistry(store=False)
    jsigs = jr.warmup([dict(s, transform_type=JTT(
        s["transform_type"].value)) for s in specs])
    assert [s.__dict__ for s in sigs] == [s.__dict__ for s in jsigs]
    assert reg.stats()["builds"] == 2
    assert obs.GLOBAL_COUNTERS.get("spfft_compile_events_total",
                                   kind="registry_build") == 2


def test_byte_budget_evicts_oldest_first():
    rng = np.random.default_rng(10)
    sets = [random_sparse_triplets(rng, DIMS) for _ in range(3)]
    probe = sp.make_local_plan(sp.TransformType.C2C, *DIMS, sets[0],
                               device="cpu")
    one = probe.estimated_device_bytes()
    reg = treg.PlanRegistry(max_bytes=int(2.5 * one), store=False)
    sigs = [reg.get_or_build(sp.TransformType.C2C, *DIMS, t,
                             device="cpu")[0] for t in sets]
    st = reg.stats()
    assert st["evictions"] >= 1 and sigs[0] not in reg and sigs[2] in reg
    assert st["bytes_in_use"] <= int(2.5 * one) or st["plans"] == 1
    with pytest.raises(sp.InvalidParameterError):
        treg.PlanRegistry(max_plans=0, store=False)
