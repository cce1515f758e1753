"""The port's pod frontend (``spfft_tpu_torch.serve.cluster``) against its
own direct plan calls and the JAX package's pod, on the CPU.

A 2-lane loopback pod over port ``ServeExecutor``s (plans on the CPU,
where the kernels run their plain versions) serves mixed single-device
and distributed traffic: every result bit for bit its direct plan call,
and within the accuracy contract (1e-6 relative l2 in single precision,
``predicted_rel_error("double", n)`` in double) of the JAX pod's result
on the same inputs. A distributed request takes the stacked ``(S,
max_values, 2)`` layout at the door (the JAX pod's per-shard list too),
and same-signature requests coalesce into one batched round, each member
bit for bit its serial call. ``load_score`` and ``simulate_routing``
equal the JAX package's exactly; reconciliation failures raise the same
class; one trace id crosses the lane boundary; the merged ``/metrics``
re-parses with no duplicate series; under ``cluster.*`` faults every
future resolves and no span is left open.
"""

import threading
import time

import numpy as np
import pytest
import torch

import spfft_tpu
from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu import parallel as jpar
from spfft_tpu.control import config as jcfg
from spfft_tpu.serve import cluster as jcluster
from spfft_tpu.serve import PlanRegistry as JRegistry
from spfft_tpu.serve import ServeExecutor as JExecutor
from spfft_tpu.serve.registry import signature_for as jsignature_for

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.benchmark import cutoff_stick_triplets
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.errors import (ClusterError, ClusterReconciliationError,
                                    DistributedPlanUnsupportedError,
                                    HostLaneError, InvalidParameterError)
from spfft_tpu_torch.faults import FaultPlan, InjectedFault
from spfft_tpu_torch.parallel import make_distributed_plan, make_mesh
from spfft_tpu_torch.serve import cluster as tcluster
from spfft_tpu_torch.serve.cluster import (HostLane, PodFrontend,
                                           SPMDCoalescer, load_score,
                                           simulate_routing)
from spfft_tpu_torch.serve.executor import ServeExecutor
from spfft_tpu_torch.serve.registry import PlanRegistry, signature_for
from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                             round_robin_stick_partition)

torch.set_num_threads(2)

N = 8
DIMS = (N, N, N)
SHARDS = 2
SINGLE_TOL = 1e-6


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


def _plans(precision):
    trip = cutoff_stick_triplets(N, N, N, 0.9, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                 precision=precision, device="cpu")
    parts = round_robin_stick_partition(trip, DIMS, SHARDS)
    planes = even_plane_split(DIMS[2], SHARDS)
    dplan = make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                  planes, mesh=make_mesh(SHARDS, "cpu"),
                                  precision=precision)
    dsig = signature_for(sp.TransformType.C2C, *DIMS, trip,
                         precision=precision, device_count=SHARDS)
    return {"trip": trip, "sig": sig, "plan": plan, "dsig": dsig,
            "dplan": dplan, "parts": parts, "planes": planes,
            "precision": precision}


@pytest.fixture(scope="module")
def pod_plans():
    """One local plan + one 2-shard distributed plan on the CPU, built
    once and shared by every pod in the module (lanes ``put`` the same
    plan objects, which is exactly what reconciliation must accept)."""
    return _plans("double")


def _make_pod(p, hosts=("h0", "h1"), with_dist=True, **kw):
    lanes = []
    for host in hosts:
        reg = PlanRegistry(store=False)
        reg.put(p["sig"], p["plan"])
        if with_dist:
            reg.put(p["dsig"], p["dplan"])
        lanes.append((host, ServeExecutor(reg)))
    return PodFrontend(lanes, **kw)


def _close_all(pod):
    pod.close()
    for lane in pod._lanes:  # close() skips dead lanes' executors
        lane.executor.close()


def _values(p, rng):
    n = len(p["trip"])
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _dlist(p, rng):
    """The JAX pod's per-shard form of a distributed request."""
    return [rng.standard_normal(s.num_values)
            + 1j * rng.standard_normal(s.num_values)
            for s in p["dplan"].dist_plan.shard_plans]


def _dvalues(p, rng):
    """The door's stacked ``(S, max_values, 2)`` form."""
    return p["dplan"].shard_values(_dlist(p, rng))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


# -- routing + execution ------------------------------------------------------
def test_pod_mixed_traffic_bit_exact(pod_plans):
    p = pod_plans
    rng = np.random.default_rng(0)
    pod = _make_pod(p)
    try:
        singles = [(v, pod.submit_backward(p["sig"], v))
                   for v in (_values(p, rng) for _ in range(8))]
        dv = _dvalues(p, rng)
        dfut = pod.submit(p["dsig"], dv)
        dl = _dlist(p, rng)
        lfut = pod.submit(p["dsig"], dl)
        for v, fut in singles:
            assert torch.equal(fut.result(timeout=60),
                               p["plan"].backward(v))
        assert torch.equal(dfut.result(timeout=60), p["dplan"].backward(dv))
        assert torch.equal(lfut.result(timeout=60), p["dplan"].backward(dl))
    finally:
        _close_all(pod)

    reg = PlanRegistry(store=False)
    reg.put(p["dsig"], p["dplan"])
    with ServeExecutor(reg) as ex:
        with pytest.raises(DistributedPlanUnsupportedError,
                           match="serve.PodFrontend"):
            ex.submit(p["dsig"], _dvalues(p, rng))


@pytest.mark.parametrize("precision", ["single", "double"])
def test_pod_matches_the_jax_pod(precision):
    """The same requests through the port's pod and the JAX pod: single
    backward, distributed backward, and their forward(FULL), each port
    result within the contract of the JAX pod's."""
    p = _plans(precision)
    tol = SINGLE_TOL if precision == "single" else \
        sp.predicted_rel_error("double", N)
    jreg = JRegistry(store=False)
    jsig, _ = jreg.get_or_build(spfft_tpu.TransformType.C2C, *DIMS,
                                p["trip"], precision=precision)
    assert jsig.__dict__ == p["sig"].__dict__
    jdplan = jpar.make_distributed_plan(
        spfft_tpu.TransformType.C2C, *DIMS, p["parts"], p["planes"],
        mesh=jpar.make_mesh(SHARDS), precision=precision)
    jdsig = jsignature_for(spfft_tpu.TransformType.C2C, *DIMS, p["trip"],
                           precision=precision, device_count=SHARDS)
    assert jdsig.__dict__ == p["dsig"].__dict__
    jreg.put(jdsig, jdplan)
    rng = np.random.default_rng(5)
    singles = [_values(p, rng) for _ in range(4)]
    dists = [_dlist(p, rng) for _ in range(2)]
    jpod = jcluster.PodFrontend([("h0", JExecutor(jreg)),
                                 ("h1", JExecutor(jreg))], seed=0)
    tpod = _make_pod(p)
    try:
        jsp = [np.asarray(jpod.submit_backward(jsig, v).result(timeout=120))
               for v in singles]
        jdp = [np.asarray(jpod.submit(jdsig, d).result(timeout=120))
               for d in dists]
        tsp = [f.result(timeout=120) for f in
               [tpod.submit_backward(p["sig"], v) for v in singles]]
        tdp = [f.result(timeout=120) for f in
               [tpod.submit(p["dsig"], p["dplan"].shard_values(d))
                for d in dists]]
        for got, want in zip(tsp + tdp, jsp + jdp):
            assert got.shape == want.shape
            assert _rel(got.numpy(), want) <= tol
        full = sp.Scaling.FULL
        jsf = [np.asarray(jpod.submit_forward(jsig, s, spfft_tpu.Scaling.FULL)
                          .result(timeout=120)) for s in jsp]
        tsf = [tpod.submit_forward(p["sig"], s, full).result(timeout=120)
               for s in tsp]
        jdf = [np.asarray(jpod.submit_forward(jdsig, s,
                                              spfft_tpu.Scaling.FULL)
                          .result(timeout=120)) for s in jdp]
        tdf = [tpod.submit_forward(p["dsig"], s, full).result(timeout=120)
               for s in tdp]
        for got, space in zip(tsf, tsp):
            assert torch.equal(got, p["plan"].forward(space, full))
        for got, space in zip(tdf, tdp):
            assert torch.equal(got, p["dplan"].forward(space, full))
        for got, want in zip(tsf + tdf, jsf + jdf):
            assert got.shape == want.shape
            assert _rel(got.numpy(), want) <= tol
    finally:
        _close_all(tpod)
        jpod.close()


def test_spmd_lane_coalesces_bit_exact(pod_plans):
    """Same-signature distributed requests queued inside one window run
    as ONE batched round; each member equals its serial call, both
    directions; the batch-size histogram and the coalesced counter
    move."""
    p = pod_plans
    rng = np.random.default_rng(6)
    tcfg.global_config().set("spmd_batch_window", 0.1, source="test",
                             reason="coalesce test")
    lane = SPMDCoalescer(max_workers=1)
    try:
        vals = [_dvalues(p, rng) for _ in range(4)]
        futs = [lane.submit(p["dsig"], p["dplan"], v, "backward",
                            sp.Scaling.NONE, None) for v in vals]
        spaces = [f.result(timeout=60) for f in futs]
        for v, got in zip(vals, spaces):
            assert torch.equal(got, p["dplan"].backward(v))
        futs = [lane.submit(p["dsig"], p["dplan"], s, "forward",
                            sp.Scaling.FULL, None) for s in spaces]
        for s, f in zip(spaces, futs):
            assert torch.equal(f.result(timeout=60),
                               p["dplan"].forward(s, sp.Scaling.FULL))
        sig = lane.signals()
        assert sig["spmd_launches"] == 2
        assert sig["spmd_batch_hist"] == {4: 2}
        assert sig["spmd_coalesced"] == 8
        assert obs.GLOBAL_COUNTERS.get(
            "spfft_cluster_spmd_coalesced_total") == 8
    finally:
        lane.close()


def test_spmd_window_holds_for_an_expected_request(pod_plans):
    """A request announced with ``expect`` joins the round of a member
    that arrived far more than a window before it: the window stays
    open until the expected request is submitted. Both results are
    their serial calls bit for bit."""
    p = pod_plans
    rng = np.random.default_rng(9)
    tcfg.global_config().set("spmd_batch_window", 0.01, source="test",
                             reason="hold test")
    lane = SPMDCoalescer(max_workers=1)
    key = lane.key(p["dsig"], "backward", sp.Scaling.NONE)
    try:
        vals = [_dvalues(p, rng) for _ in range(2)]
        lane.expect(key)
        first = lane.submit(p["dsig"], p["dplan"], vals[0], "backward",
                            sp.Scaling.NONE, None)
        time.sleep(0.3)  # thirty windows
        assert not first.done()
        second = lane.submit(p["dsig"], p["dplan"], vals[1], "backward",
                             sp.Scaling.NONE, None, expected=True)
        for v, f in zip(vals, (first, second)):
            assert torch.equal(f.result(timeout=60), p["dplan"].backward(v))
        assert lane.signals()["spmd_batch_hist"] == {2: 1}
        assert lane._incoming == {}
    finally:
        lane.close()


@pytest.mark.parametrize("how", ["release", "bound"])
def test_spmd_window_hold_ends(pod_plans, how):
    """The hold ends when the expectation is taken back (``release``),
    and without that after ``RECEIVE_HOLD_S`` (``bound``): the waiting
    member then runs alone."""
    p = pod_plans
    rng = np.random.default_rng(10)
    tcfg.global_config().set("spmd_batch_window", 0.01, source="test",
                             reason="hold test")
    lane = SPMDCoalescer(max_workers=1)
    lane.RECEIVE_HOLD_S = 600.0 if how == "release" else 0.2
    key = lane.key(p["dsig"], "backward", sp.Scaling.NONE)
    try:
        v = _dvalues(p, rng)
        lane.expect(key)
        fut = lane.submit(p["dsig"], p["dplan"], v, "backward",
                          sp.Scaling.NONE, None)
        if how == "release":
            time.sleep(0.1)
            assert not fut.done()
            lane.release(key)
        assert torch.equal(fut.result(timeout=60), p["dplan"].backward(v))
        assert lane.signals()["spmd_batch_hist"] == {1: 1}
    finally:
        lane.close()


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("policy,hosts", [("rr", 2), ("p2c", 2),
                                          ("p2c", 3), ("p2c", 5)])
def test_simulate_routing_equals_the_jax_package(policy, hosts, seed):
    assert simulate_routing(policy, hosts=hosts, seed=seed) == \
        jcluster.simulate_routing(policy, hosts=hosts, seed=seed)


def test_p2c_beats_rr_on_skewed_load():
    rr = simulate_routing("rr")
    p2c = simulate_routing("p2c")
    assert sum(rr["assigned"]) == sum(p2c["assigned"]) == 400
    assert rr["ratio"] >= 4.0
    assert p2c["ratio"] <= 2.0
    assert rr["ratio"] / p2c["ratio"] >= 2.0
    assert tcluster._run_simulate(3) == jcluster._run_simulate(3)


def test_load_score_orders_hosts():
    idle = {"queue_depth": 0, "device_execute_p50": 0.002}
    busy = {"queue_depth": 5, "device_execute_p50": 0.002}
    cold = {"queue_depth": 1, "device_execute_p50": 0.0}
    assert load_score(idle) < load_score(cold) < load_score(busy)
    rng = np.random.default_rng(2)
    for _ in range(50):
        s = {"queue_depth": int(rng.integers(0, 9)),
             "device_execute_p50": float(rng.random()) * 0.01,
             "wire_rtt": float(rng.random()) * 1e-3}
        if rng.random() < 0.2:
            s.pop("wire_rtt")
        assert load_score(s) == jcluster.load_score(s)


def test_pod_validation_errors(pod_plans):
    p = pod_plans
    with pytest.raises(InvalidParameterError):
        PodFrontend([], policy="p2c")
    with pytest.raises(InvalidParameterError):
        _make_pod(p, policy="weighted")
    with pytest.raises(InvalidParameterError):
        _make_pod(p, hosts=("h0", "h0"))
    pod = _make_pod(p, with_dist=False)
    try:
        with pytest.raises(InvalidParameterError):
            pod.submit(p["dsig"], [])  # signature never warmed up
        with pytest.raises(InvalidParameterError):
            pod.submit(p["sig"], [], kind="sideways")
    finally:
        _close_all(pod)


# -- federated telemetry ------------------------------------------------------
def test_cross_host_trace_single_trace_id(pod_plans):
    p = pod_plans
    rng = np.random.default_rng(1)
    obs.enable()
    tracer = obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)
    pod = _make_pod(p)
    try:
        futs = [pod.submit_backward(p["sig"], _values(p, rng))
                for _ in range(6)]
        futs.append(pod.submit(p["dsig"], _dvalues(p, rng)))
        for fut in futs:
            fut.result(timeout=60)
    finally:
        _close_all(pod)
        obs.disable()
    assert tracer.open_count() == 0, tracer.open_names()
    spans = [e for e in tracer.events() if isinstance(e, obs.Span)]
    roots = [s for s in spans if s.name == "cluster.request"]
    assert len(roots) == 7
    by_id = {s.span_id: s for s in spans}
    crossed = 0
    for s in spans:
        if s.name in ("serve.request", "cluster.spmd_execute"):
            parent = by_id[s.parent_id]
            assert parent.name == "cluster.request"
            assert s.trace_id == parent.trace_id
            crossed += 1
    assert crossed == 7


def test_merged_metrics_parse_and_health(pod_plans):
    p = pod_plans
    rng = np.random.default_rng(2)
    pod = _make_pod(p)
    try:
        for _ in range(6):
            pod.submit_backward(p["sig"],
                                _values(p, rng)).result(timeout=60)
        assert pod.health()["state"] == "healthy"
        parsed = obs.parse_prometheus_text(pod.metrics_text())
        hosts = {dict(labels).get("host") for (name, labels) in parsed
                 if name == "spfft_serve_completed_total"}
        assert {"h0", "h1"} <= hosts
        families = {name for name, _ in parsed}
        assert "spfft_cluster_routed_total" in families
        assert "spfft_cluster_health" in families

        pod.kill_host("h1")
        health = pod.health()
        assert health["state"] == "degraded"
        assert health["alive"] == 1
        assert health["hosts"]["h1"]["state"] == "failed"
        obs.parse_prometheus_text(pod.metrics_text())
        got = pod.submit_backward(p["sig"],
                                  _values(p, rng)).result(timeout=60)
        assert got.shape  # survivor still serves
    finally:
        _close_all(pod)


def test_merged_metrics_no_duplicate_series(pod_plans):
    p = pod_plans
    rng = np.random.default_rng(7)
    pod = _make_pod(p)
    try:
        for _ in range(4):
            pod.submit_backward(p["sig"],
                                _values(p, rng)).result(timeout=60)
        text = pod.metrics_text()
        samples = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                   if ln and not ln.startswith("#")]
        dupes = {s for s in samples if samples.count(s) > 1}
        assert not dupes, sorted(dupes)[:5]
        parsed = obs.parse_prometheus_text(text)
        hosts = {dict(labels).get("host") for (name, labels) in parsed
                 if name == "spfft_serve_completed_total"}
        assert {"h0", "h1"} <= hosts
    finally:
        _close_all(pod)


# -- reconciliation -----------------------------------------------------------
def _lanes(rows):
    return [HostLane(host, ServeExecutor(reg)) for host, reg in rows]


def _reg(p, dplan=None, with_dist=True):
    reg = PlanRegistry(store=False)
    reg.put(p["sig"], p["plan"])
    if with_dist:
        reg.put(p["dsig"], dplan or p["dplan"])
    return reg


@pytest.fixture(scope="module")
def jax_plans(pod_plans):
    """The JAX package's plans over the same sets: the local plan, the
    2-shard distributed plan and one over the permuted partition."""
    p = pod_plans
    jreg = JRegistry(store=False)
    jsig, jplan = jreg.get_or_build(spfft_tpu.TransformType.C2C, *DIMS,
                                    p["trip"], precision="double")

    def dist(parts):
        return jpar.make_distributed_plan(
            spfft_tpu.TransformType.C2C, *DIMS, parts, p["planes"],
            mesh=jpar.make_mesh(SHARDS), precision="double")

    jdsig = jsignature_for(spfft_tpu.TransformType.C2C, *DIMS, p["trip"],
                           precision="double", device_count=SHARDS)
    return {"sig": jsig, "plan": jplan, "dsig": jdsig,
            "dplan": dist(p["parts"]),
            "other": dist(list(reversed(p["parts"])))}


def _jax_error(j, rows):
    """The class name the JAX pod raises for lanes holding ``rows``
    (host -> the distributed plan or None), or None."""
    exs = []
    for _, dplan in rows:
        reg = JRegistry(store=False)
        reg.put(j["sig"], j["plan"])
        if dplan is not None:
            reg.put(j["dsig"], dplan)
        exs.append(JExecutor(reg))
    try:
        jcluster.PodFrontend([(h, ex) for (h, _), ex in zip(rows, exs)])
    except Exception as exc:  # noqa: BLE001 - the class is the verdict
        return type(exc).__name__
    finally:
        for ex in exs:
            ex.close()
    return None


def test_reconciliation_rejects_differing_plan_sets(pod_plans, jax_plans):
    p = pod_plans
    lanes = _lanes([("h0", _reg(p)), ("h1", _reg(p, with_dist=False))])
    try:
        with pytest.raises(ClusterReconciliationError,
                           match="different plan set") as ei:
            PodFrontend(lanes)
    finally:
        for lane in lanes:
            lane.executor.close()
    assert _jax_error(jax_plans, [("h0", jax_plans["dplan"]),
                                  ("h1", None)]) == type(ei.value).__name__


def test_reconciliation_rejects_fingerprint_mismatch(pod_plans, jax_plans):
    """Same signature, different sharding: h1 holds a distributed plan
    whose stick partition is permuted — the loopback digest collective
    (the port's ``validate_consistent``) catches it."""
    p = pod_plans
    other = make_distributed_plan(
        sp.TransformType.C2C, *DIMS, list(reversed(p["parts"])),
        p["planes"], mesh=make_mesh(SHARDS, "cpu"), precision="double")
    lanes = _lanes([("h0", _reg(p)), ("h1", _reg(p, dplan=other))])
    try:
        with pytest.raises(ClusterReconciliationError,
                           match="disagrees across the pod") as ei:
            PodFrontend(lanes)
    finally:
        for lane in lanes:
            lane.executor.close()
    assert _jax_error(jax_plans, [("h0", jax_plans["dplan"]),
                                  ("h1", jax_plans["other"])]) \
        == type(ei.value).__name__


def test_reconciliation_rpc_fault_is_typed(pod_plans):
    p = pod_plans
    faults.arm(FaultPlan(script="cluster.rpc@1"))
    try:
        with pytest.raises(ClusterReconciliationError,
                           match="reconciliation RPC failed"):
            _make_pod(p, with_dist=False)
    finally:
        faults.disarm()


@pytest.mark.parametrize("site", ["cluster.reconcile@1",
                                  "cluster.spmd_window@1"])
def test_cluster_fault_sites_are_typed(pod_plans, site):
    """``cluster.reconcile`` fails construction as the typed
    reconciliation error; ``cluster.spmd_window`` fails the coalesced
    round's futures with the injected fault (nothing hangs)."""
    p = pod_plans
    rng = np.random.default_rng(11)
    faults.arm(FaultPlan(script=site))
    try:
        if site.startswith("cluster.reconcile"):
            with pytest.raises(ClusterReconciliationError,
                               match="reconciliation collective failed"):
                _make_pod(p)
            return
        pod = _make_pod(p)
        try:
            fut = pod.submit(p["dsig"], _dvalues(p, rng))
            with pytest.raises(InjectedFault):
                fut.result(timeout=60)
            v = _dvalues(p, rng)
            assert torch.equal(pod.submit(p["dsig"], v).result(timeout=60),
                               p["dplan"].backward(v))
        finally:
            _close_all(pod)
    finally:
        faults.disarm()


# -- failure semantics --------------------------------------------------------
def test_dead_lane_failover(pod_plans):
    p = pod_plans
    rng = np.random.default_rng(3)
    pod = _make_pod(p, with_dist=False)
    try:
        pod._lanes[0].transport.alive = False
        v = _values(p, rng)
        got = pod.submit_backward(p["sig"], v).result(timeout=60)
        assert torch.equal(got, p["plan"].backward(v))
        assert pod._lanes[1].executor.metrics.snapshot()["completed"] >= 1
        faults.arm(FaultPlan(script="cluster.route@1"))
        try:
            with pytest.raises(InjectedFault):
                pod.submit_backward(p["sig"], v)
        finally:
            faults.disarm()
        assert pod.health()["state"] == "degraded"
    finally:
        _close_all(pod)


def test_all_lanes_dead_is_typed(pod_plans):
    p = pod_plans
    pod = _make_pod(p, with_dist=False)
    try:
        for lane in pod._lanes:
            lane.transport.alive = False
        with pytest.raises(ClusterError):
            pod.submit_backward(p["sig"], np.zeros(len(p["trip"]), complex))
        assert pod.health()["state"] == "failed"
    finally:
        _close_all(pod)


def test_fuzz_cluster_faults_zero_unclosed_spans(pod_plans):
    """8 threads hammering the pod under seeded cluster.rpc transient
    faults: every failure is typed, every issued future resolves, and
    the tracer ends with zero open spans."""
    p = pod_plans
    obs.enable()
    tracer = obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)
    pod = _make_pod(p)
    errors = []
    futures = []
    flock = threading.Lock()

    def worker(tid):
        rng = np.random.default_rng(100 + tid)
        for i in range(6):
            try:
                if i == 3:
                    fut = pod.submit(p["dsig"], _dvalues(p, rng))
                else:
                    fut = pod.submit_backward(p["sig"], _values(p, rng))
                with flock:
                    futures.append(fut)
            except (HostLaneError, ClusterError, InjectedFault) as exc:
                with flock:
                    errors.append(exc)
            except Exception as exc:  # noqa: BLE001 - untyped is a bug
                with flock:
                    errors.append(AssertionError(repr(exc)))

    faults.arm(FaultPlan(rate=0.15, seed=7, scope="cluster.rpc"))
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        faults.disarm()
    try:
        for fut in futures:
            try:
                fut.result(timeout=60)  # resolves either way
            except Exception:  # noqa: BLE001 - typed or not, it resolved
                pass
            assert fut.done()
    finally:
        _close_all(pod)
        obs.disable()
    assert not [e for e in errors if isinstance(e, AssertionError)], errors
    assert tracer.open_count() == 0, tracer.open_names()


def test_pod_frontend_importable_from_serve():
    from spfft_tpu_torch import serve
    assert serve.PodFrontend is PodFrontend
    assert serve.HostLane is HostLane
    assert serve.LoopbackTransport is tcluster.LoopbackTransport
    assert serve.load_score is load_score
    assert callable(serve.simulate_routing)


def test_cluster_cli(capsys):
    """``--smoke --device cpu`` runs the 2-host loopback pod green;
    ``--simulate`` prints the JAX package's numbers."""
    import json
    assert tcluster.main(["--smoke", "--device", "cpu"]) == 0
    assert "CLUSTER SMOKE GREEN" in capsys.readouterr().out
    assert tcluster.main(["--simulate"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(jcluster._run_simulate(0)))
