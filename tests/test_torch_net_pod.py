"""The port's real-TCP pod (``spfft_tpu_torch.net.{transport,agent,smoke}``
and the SPMD lane's admission) on the CPU, against loopback lanes and
direct plan calls.

A ``TcpHostLane`` against an in-process ``HostAgent`` (listening on
port 0) is indistinguishable from a loopback lane over the same
executor: the same bits for single-device and distributed requests
(the stacked layout and the per-shard list), in both directions; only
the result's device differs (the wire's CPU tensors). A mixed pod of
one loopback and one TCP lane serves bit-exact, carries one trace id
across the socket, feeds the wire RTT into the routing signals, keeps a
remote rejection typed, fails over typed when the agent dies, and takes
a TCP lane that joins warm off the blob tier (``builds == 0``) and
drain-leaves. The SPMD lane and the agent reject overflow as
``QueueFullError`` and expired deadlines as ``DeadlineExpiredError``;
concurrent distributed requests coalesce agent-side. Then real
subprocess agents (``--device cpu``): a two-agent pod that fails over
typed after ``kill -9``; ``python -m spfft_tpu_torch.net.smoke --device
cpu``; and an agent with no card and no ``--device cpu`` exits non-zero
with the ``DeviceError`` message. Every socket, join and process wait
has a timeout; spawned agents are killed in a ``finally``. The blob-tier
cases of the JAX file are ``tests/test_torch_blobstore.py``'s.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.benchmark import cutoff_stick_triplets
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.control.config import global_config
from spfft_tpu_torch.errors import (DeadlineExpiredError, InvalidParameterError,
                                    QueueFullError)
from spfft_tpu_torch.net import frame as tframe
from spfft_tpu_torch.net import smoke
from spfft_tpu_torch.net.agent import HostAgent
from spfft_tpu_torch.net.blobstore import FileBlobStore
from spfft_tpu_torch.net.transport import (TcpHostLane, _SocketPool,
                                           wire_overhead_probe)
from spfft_tpu_torch.parallel import make_distributed_plan, make_mesh
from spfft_tpu_torch.serve.cluster import HostLane, PodFrontend, SPMDCoalescer
from spfft_tpu_torch.serve.executor import ServeExecutor
from spfft_tpu_torch.serve.registry import PlanRegistry, signature_for
from spfft_tpu_torch.serve.store import PlanArtifactStore
from spfft_tpu_torch.types import Scaling
from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                             round_robin_stick_partition)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
DIMS = (N, N, N)
SHARDS = 2


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


@pytest.fixture(scope="module")
def plans():
    """One local + one 2-shard distributed plan on the CPU, shared
    module-wide."""
    trip = cutoff_stick_triplets(N, N, N, 0.9, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                 precision="double", device="cpu")
    parts = round_robin_stick_partition(trip, DIMS, SHARDS)
    planes = even_plane_split(DIMS[2], SHARDS)
    dplan = make_distributed_plan(sp.TransformType.C2C, *DIMS, parts,
                                  planes, mesh=make_mesh(SHARDS, "cpu"),
                                  precision="double")
    dsig = signature_for(sp.TransformType.C2C, *DIMS, trip,
                         precision="double", device_count=SHARDS)
    return {"trip": trip, "sig": sig, "plan": plan,
            "dsig": dsig, "dplan": dplan}


def _vals(plans, rng):
    n = len(plans["trip"])
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _dlist(plans, rng):
    return [rng.standard_normal(p.num_values)
            + 1j * rng.standard_normal(p.num_values)
            for p in plans["dplan"].dist_plan.shard_plans]


def _dvals(plans, rng):
    return plans["dplan"].shard_values(_dlist(plans, rng))


def _registry(plans, local=True, dist=True):
    reg = PlanRegistry(store=False)
    if local:
        reg.put(plans["sig"], plans["plan"])
    if dist:
        reg.put(plans["dsig"], plans["dplan"])
    return reg


# ---------------------------------------------------------------------------
# the two lanes, side by side
# ---------------------------------------------------------------------------

def test_tcp_lane_indistinguishable_from_loopback(plans):
    """The same requests through a pod of one loopback lane and a pod of
    one TCP lane whose agent fronts the SAME executor give the same bits:
    single backward / forward(FULL), distributed backward in the stacked
    layout and as a per-shard list, distributed forward; the wire's
    results are CPU tensors. The lanes answer the same signatures, and
    the TCP lane a plan descriptor carrying the fingerprint."""
    ex = ServeExecutor(_registry(plans))
    agent = HostAgent("w0", ex).start()
    tcp = TcpHostLane("w0", ("127.0.0.1", agent.port))
    loop = HostLane("w0", ex)
    pods = [PodFrontend([loop]), PodFrontend([tcp])]
    rng = np.random.default_rng(11)
    full = Scaling.FULL
    try:
        requests = [(plans["sig"], _vals(plans, rng)),
                    (plans["dsig"], _dvals(plans, rng)),
                    (plans["dsig"], _dlist(plans, rng))]
        for sig, v in requests:
            a, b = (pod.submit_backward(sig, v).result(timeout=60)
                    for pod in pods)
            assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
            a, b = (pod.submit_forward(sig, b, full).result(timeout=60)
                    for pod in pods)
            assert torch.equal(a.cpu(), b)
        assert loop.rpc_signatures() == tcp.rpc_signatures()
        assert tcp.rpc_plan(plans["dsig"]) == {
            "remote": True, "distributed": True,
            "fingerprint": sp.parallel.multihost.plan_fingerprint(
                plans["dplan"].dist_plan).hex()}
    finally:
        for pod in pods:
            pod.close()
        agent.close()
        ex.close(drain=False)


# ---------------------------------------------------------------------------
# SPMD-lane admission control
# ---------------------------------------------------------------------------

def test_spmd_lane_queue_full_and_deadline_purge(plans):
    release = threading.Event()

    class _Blocking:
        def backward(self, values):
            release.wait(30)
            return values

    lane = SPMDCoalescer(max_workers=1)
    cfg = global_config()
    cfg.set("max_queue", 2, source="test", reason="admission test")
    try:
        f1 = lane.submit(plans["dsig"], _Blocking(), 1, "backward",
                         Scaling.NONE, None)
        time.sleep(0.05)  # let the worker pick f1 up
        f2 = lane.submit(plans["dsig"], _Blocking(), 2, "backward",
                         Scaling.NONE, None, timeout=0.02)
        with pytest.raises(QueueFullError):
            lane.submit(plans["dsig"], _Blocking(), 3, "backward",
                        Scaling.NONE, None)
        time.sleep(0.1)  # let f2's queued deadline lapse
        release.set()
        assert f1.result(timeout=30) == 1
        with pytest.raises(DeadlineExpiredError):
            f2.result(timeout=30)
        rej = obs.GLOBAL_COUNTERS.snapshot()[
            "spfft_cluster_spmd_rejected_total"]["samples"]
        reasons = {dict(k).get("reason") for k in rej}
        assert {"queue_full", "expired"} <= reasons
    finally:
        release.set()
        lane.close()


# ---------------------------------------------------------------------------
# connection pooling
# ---------------------------------------------------------------------------

def test_socket_pool_reuses_connections(plans):
    ex = ServeExecutor(_registry(plans, dist=False))
    agent = HostAgent("pool0", ex).start()
    lane = TcpHostLane("pool0", ("127.0.0.1", agent.port))
    rng = np.random.default_rng(5)
    try:
        for _ in range(4):
            v = _vals(plans, rng)
            got = lane.rpc_submit(plans["sig"], v).result(timeout=120)
            assert torch.equal(got, plans["plan"].backward(v))
        stats = lane.transport.pool_stats()
        assert stats["misses"] >= 1
        assert stats["hits"] >= 2
        assert stats["idle"] >= 1
    finally:
        lane.close()
        agent.close()
        ex.close(drain=False)


def test_socket_pool_reaper_closes_idle():
    a, b = socket.socketpair()
    pool = _SocketPool(idle_timeout=0.12)
    try:
        pool.checkin(a)
        assert pool.stats()["idle"] == 1
        deadline = time.monotonic() + 5.0
        while pool.stats()["reaped"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        stats = pool.stats()
        assert stats["reaped"] == 1
        assert stats["idle"] == 0
    finally:
        pool.close()
        b.close()


def test_socket_pool_discards_stale_sockets():
    a, b = socket.socketpair()
    pool = _SocketPool(idle_timeout=30.0)
    try:
        pool.checkin(a)
        b.close()
        assert pool.checkout() is None
        assert pool.stats()["idle"] == 0
        assert pool.stats()["misses"] == 1
    finally:
        pool.close()


# ---------------------------------------------------------------------------
# agent-side admission and coalescing
# ---------------------------------------------------------------------------

def test_agent_rejects_expired_and_full_typed(plans):
    ex = ServeExecutor(_registry(plans, dist=False))
    agent = HostAgent("adm0", ex).start()
    lane = TcpHostLane("adm0", ("127.0.0.1", agent.port))
    rng = np.random.default_rng(6)
    try:
        with pytest.raises(DeadlineExpiredError):
            lane.rpc_submit(plans["sig"], _vals(plans, rng),
                            timeout=0.0).result(timeout=30)
        cfg = global_config()
        cfg.set("max_queue", 1, source="test",
                reason="agent admission test")
        try:
            with agent._lock:
                agent._inflight += 1  # a request parked in the seam
            with pytest.raises(QueueFullError):
                lane.rpc_submit(plans["sig"], _vals(plans, rng)) \
                    .result(timeout=30)
        finally:
            with agent._lock:
                agent._inflight -= 1
            cfg.set("max_queue", 256, source="test",
                    reason="restore after agent admission test")
        v = _vals(plans, rng)
        got = lane.rpc_submit(plans["sig"], v).result(timeout=120)
        assert torch.equal(got, plans["plan"].backward(v))
        rej = obs.GLOBAL_COUNTERS.snapshot()[
            "spfft_net_agent_rejected_total"]["samples"]
        reasons = {dict(k).get("reason") for k in rej}
        assert {"queue_full", "expired"} <= reasons
    finally:
        lane.close()
        agent.close()
        ex.close(drain=False)


def test_agent_coalesces_concurrent_distributed_requests(plans):
    """Two concurrent same-signature distributed submits over real TCP
    share one round on the agent's coalescer: both bit-exact, and the
    coalesced counter moves by exactly 2."""
    ex = ServeExecutor(_registry(plans, local=False))
    agent = HostAgent("coal0", ex).start()
    lane = TcpHostLane("coal0", ("127.0.0.1", agent.port))
    rng = np.random.default_rng(8)
    dvals = [_dvals(plans, rng) for _ in range(2)]
    oracle = [plans["dplan"].backward(v) for v in dvals]
    global_config().set("spmd_batch_window", 0.1, source="test",
                        reason="agent coalesce test")
    try:
        futs = [lane.rpc_submit(plans["dsig"], v) for v in dvals]
        got = [f.result(timeout=120) for f in futs]
    finally:
        lane.close()
        agent.close()
        ex.close(drain=False)
    for g, want in zip(got, oracle):
        assert torch.equal(g, want)
    assert obs.GLOBAL_COUNTERS.get("spfft_cluster_spmd_coalesced_total") \
        == 2


def _submit_frame(plans, values):
    """The bytes of a distributed backward submit frame, split after the
    header (what the agent has when the payload is still arriving)."""
    meta, payload = tframe.pack_values(values)
    header = {"type": "submit",
              "signature": tframe.signature_to_wire(plans["dsig"]),
              "kind": "backward", "scaling": Scaling.NONE.value,
              "timeout": None, "priority": "normal", "ctx": None,
              "epoch": None, **meta}

    class _Bytes:
        data = b""

        def sendall(self, data):
            self.data += data

    out = _Bytes()
    tframe.send_frame(out, header, payload)
    cut = len(out.data) - len(payload)
    return out.data[:cut], out.data[cut:]


@pytest.mark.parametrize("arrives", [True, False])
def test_agent_holds_a_round_for_a_request_still_arriving(plans, arrives):
    """A distributed submit whose header is in while its payload is still
    on the wire holds the round of a same-signature request that
    arrived whole, past the coalescing window: both share one round
    and are bit-exact (``arrives``). A frame cut off after its header
    gives its expectation back, and the other request runs alone."""
    ex = ServeExecutor(_registry(plans, local=False))
    agent = HostAgent("hold0", ex).start()
    # only the expected request's submit or its release ends the hold
    agent._spmd.RECEIVE_HOLD_S = 600.0
    lane = TcpHostLane("hold0", ("127.0.0.1", agent.port))
    rng = np.random.default_rng(11)
    dvals = [_dvals(plans, rng) for _ in range(2)]
    head, body = _submit_frame(plans, dvals[1])
    global_config().set("spmd_batch_window", 0.01, source="test",
                        reason="agent hold test")
    raw = socket.create_connection(("127.0.0.1", agent.port), timeout=30)
    try:
        raw.sendall(head)
        deadline = time.monotonic() + 30
        while not agent._spmd._incoming and time.monotonic() < deadline:
            time.sleep(0.01)
        assert agent._spmd._incoming
        fut = lane.rpc_submit(plans["dsig"], dvals[0])
        time.sleep(0.3)  # thirty windows
        if arrives:
            assert not fut.done()
            raw.sendall(body)
            reply = tframe.recv_frame(raw)
            got = tframe.unpack_tensors(*reply)
            assert torch.equal(got, plans["dplan"].backward(dvals[1]))
        else:
            raw.close()
        assert torch.equal(fut.result(timeout=60),
                           plans["dplan"].backward(dvals[0]))
    finally:
        raw.close()
        lane.close()
        agent.close()
        ex.close(drain=False)
    assert agent._spmd._incoming == {}
    assert obs.GLOBAL_COUNTERS.get("spfft_cluster_spmd_coalesced_total") \
        == (2 if arrives else 0)


# ---------------------------------------------------------------------------
# TcpHostLane against a live in-process agent, in a pod
# ---------------------------------------------------------------------------

@pytest.fixture()
def agent_pod(plans):
    """A PodFrontend over one loopback lane + one REAL TCP lane backed
    by an in-process HostAgent."""
    loop_ex = ServeExecutor(_registry(plans))
    tcp_ex = ServeExecutor(_registry(plans))
    agent = HostAgent("t1", tcp_ex).start()
    lane = TcpHostLane("t1", ("127.0.0.1", agent.port))
    pod = PodFrontend([("t0", loop_ex), lane], policy="rr", seed=0)
    yield {"pod": pod, "lane": lane, "agent": agent,
           "tcp_ex": tcp_ex, "loop_ex": loop_ex}
    pod.close()
    lane.close()
    agent.close()
    tcp_ex.close(drain=False)
    loop_ex.close(drain=False)


def test_mixed_pod_serves_bit_exact(agent_pod, plans):
    pod = agent_pod["pod"]
    rng = np.random.default_rng(1)
    for _ in range(4):
        v = _vals(plans, rng)
        got = pod.submit_backward(plans["sig"], v).result(timeout=120)
        assert torch.equal(got.cpu(), plans["plan"].backward(v))
    for dv in (_dvals(plans, rng), _dlist(plans, rng)):
        dgot = pod.submit(plans["dsig"], dv).result(timeout=120)
        assert torch.equal(dgot, plans["dplan"].backward(dv))


def test_trace_id_crosses_the_socket(agent_pod, plans):
    pod, lane = agent_pod["pod"], agent_pod["lane"]
    obs.enable()
    tracer = obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)
    try:
        rng = np.random.default_rng(2)
        for _ in range(4):
            pod.submit_backward(plans["sig"], _vals(plans, rng)) \
                .result(timeout=120)
        assert tracer.open_count() == 0
        roots = {s.trace_id for s in tracer.events()
                 if isinstance(s, obs.Span)
                 and s.name == "cluster.request"}
        remote = lane.rpc_spans()
        assert remote["open"] == 0
        served = [s for s in remote["spans"]
                  if s["name"] == "serve.request"]
        assert served, "agent recorded no serve.request spans"
        assert all(s["trace_id"] in roots for s in served)
    finally:
        obs.disable()


def test_wire_rtt_feeds_signals(agent_pod, plans):
    pod, lane = agent_pod["pod"], agent_pod["lane"]
    rng = np.random.default_rng(4)
    pod.submit_backward(plans["sig"], _vals(plans, rng)).result(timeout=120)
    signals = lane.rpc_signals()
    assert signals["wire_rtt"] > 0.0
    assert lane.transport.rtt == pytest.approx(signals["wire_rtt"])


def test_remote_error_stays_typed(agent_pod, plans):
    lane = agent_pod["lane"]
    bogus = signature_for(
        sp.TransformType.C2C, 6, 6, 6,
        cutoff_stick_triplets(6, 6, 6, 0.9, hermitian=False),
        precision="double")
    with pytest.raises(InvalidParameterError):
        lane.rpc_submit(bogus, np.zeros(3, complex),
                        ctx=None).result(timeout=60)
    assert lane.alive


def test_agent_death_fails_over_typed(agent_pod, plans):
    pod, agent = agent_pod["pod"], agent_pod["agent"]
    agent.close()
    agent_pod["tcp_ex"].close(drain=False)
    rng = np.random.default_rng(5)
    for _ in range(4):
        v = _vals(plans, rng)
        got = pod.submit_backward(plans["sig"], v).result(timeout=120)
        assert torch.equal(got, plans["plan"].backward(v))
    assert pod._on_ladder("t1")  # out of routing, probed
    assert pod.health()["state"] == "degraded"


def test_membership_join_prewarm_and_leave(agent_pod, plans, tmp_path):
    pod = agent_pod["pod"]
    blob = FileBlobStore(str(tmp_path / "blob"))
    seed_store = PlanArtifactStore(str(tmp_path / "seed"), remote=blob,
                                   plan_kwargs={"device": "cpu"})
    seed_store.save_plan(plans["sig"], plans["plan"], plans["trip"])
    seed_store.drain()

    reg = PlanRegistry(store=PlanArtifactStore(
        str(tmp_path / "join"), remote=blob, plan_kwargs={"device": "cpu"}))
    reg.put(plans["dsig"], plans["dplan"])  # derived, never serialized
    join_ex = ServeExecutor(reg)
    agent2 = HostAgent("t2", join_ex).start()
    lane2 = TcpHostLane("t2", ("127.0.0.1", agent2.port))
    try:
        pod.join(lane2)
        assert lane2.rpc_stats()["builds"] == 0
        rng = np.random.default_rng(6)
        for _ in range(6):
            v = _vals(plans, rng)
            got = pod.submit_backward(plans["sig"], v).result(timeout=120)
            assert torch.equal(got, plans["plan"].backward(v))
        assert obs.GLOBAL_COUNTERS.get("spfft_cluster_routed_total",
                                       host="t2", kind="single") >= 1
        left = pod.leave("t2")
        assert left["drained"]
        events = {dict(k).get("event")
                  for k in obs.GLOBAL_COUNTERS.snapshot()
                  ["spfft_cluster_membership_total"]["samples"]}
        assert {"join_started", "prewarmed", "reconciled", "joined",
                "leave_started", "drained", "left"} <= events
    finally:
        lane2.close()
        agent2.close()
        join_ex.close(drain=False)


def test_wire_overhead_probe():
    out = wire_overhead_probe(repeats=3, n=6, device="cpu")
    assert out["repeats"] == 3
    for key in ("loopback_us", "tcp_us", "tcp_pooled_us"):
        assert out[key] > 0
    assert out["pool_hits"] >= 1 and out["pool_misses"] >= 1


# ---------------------------------------------------------------------------
# the real thing: subprocess agents over localhost TCP
# ---------------------------------------------------------------------------

def _spawn(host, store, blob, warm, log):
    return smoke._spawn_agent(host, store, blob, warm, "cpu", log,
                              timeout=120)


def test_two_process_pod_over_tcp(tmp_path, plans):
    """Two real agent processes (``--device cpu``): mixed traffic
    bit-exact vs the plans here, then ``kill -9`` one agent and the
    survivor keeps the trace bit-exact; the pod degrades typed."""
    blob = str(tmp_path / "blob")
    os.makedirs(blob)
    log = str(tmp_path / "agents.log")
    procs, lanes = {}, {}
    pod = None
    try:
        for host in ("p0", "p1"):
            procs[host], port = _spawn(host, str(tmp_path / f"s-{host}"),
                                       blob, f"{N},0.9,{SHARDS},full", log)
            lanes[host] = TcpHostLane(host, ("127.0.0.1", port))
        pod = PodFrontend([lanes["p0"], lanes["p1"]], policy="rr", seed=0)
        rng = np.random.default_rng(7)
        for _ in range(6):
            v = _vals(plans, rng)
            got = pod.submit_backward(plans["sig"], v).result(timeout=120)
            assert torch.equal(got, plans["plan"].backward(v))
        dv = _dvals(plans, rng)
        dgot = pod.submit(plans["dsig"], dv).result(timeout=120)
        assert torch.equal(dgot, plans["dplan"].backward(dv))

        procs["p1"].kill()
        procs["p1"].wait(timeout=30)
        for _ in range(4):
            v = _vals(plans, rng)
            got = pod.submit_backward(plans["sig"], v).result(timeout=120)
            assert torch.equal(got, plans["plan"].backward(v))
        assert pod._on_ladder("p1")  # out of routing, probed
        assert obs.GLOBAL_COUNTERS.get("spfft_cluster_rpc_failures_total",
                                       host="p1", op="submit") >= 1
        assert pod.health()["state"] == "degraded"
    finally:
        if pod is not None:
            pod.close()
        for lane in lanes.values():
            lane.close()
        for proc in procs.values():
            proc.kill()
            proc.wait(timeout=30)


def test_pod_smoke_on_the_cpu():
    """The body of ``python -m spfft_tpu_torch.net.smoke --device cpu``
    (in process; the agents are subprocesses): no failure, and its
    numbers. Leases of 1 s instead of the CLI's 300 ms: agents starved
    of CPU beside other test workers must not miss renewals."""
    failures, numbers = smoke.run_pod_smoke(0, "cpu", lease_ttl_ms=1000)
    assert not failures, "\n".join(failures)
    assert numbers["device"] == "cpu" and numbers["spans_crossed"] >= 26
    assert numbers["kill_to_failover_s"] is not None
    assert numbers["trace_requests"] == smoke.COUNTS["singles"] + 1
    json.dumps(numbers)


def test_pod_smoke_heals_at_a_smaller_n():
    """The smoke with its join / kill / heal steps at a smaller n than
    the trace (the agents hold both plan sets, each step bit for bit
    against its own oracle) and one solo request timed apart."""
    failures, numbers = smoke.run_pod_smoke(0, "cpu", n=10, heal_n=8,
                                            solo=1, lease_ttl_ms=1000)
    assert not failures, "\n".join(failures)
    assert (numbers["n"], numbers["heal_n"]) == (10, 8)
    solo = numbers["solo"]
    assert solo["requests"] == 1
    parts = ("pack_values_s", "unpack_values_s", "plan_s", "pack_space_s",
             "unpack_space_s", "rest_s")
    assert solo["wall_s"] == pytest.approx(sum(solo[k] for k in parts))
    assert solo["wall_s"] == pytest.approx(solo["submit_s"]
                                           + solo["reply_s"])
    json.dumps(numbers)


def test_agent_without_a_card_exits_with_the_device_error():
    """No card and no ``--device cpu``: the agent exits non-zero with
    the ``DeviceError`` message and never announces a port."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the agent would hold it")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spfft_tpu_torch.net.agent", "--host", "h0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO)
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode != 0
    assert "DeviceError" in err and "CUDA" in err
    assert '"port"' not in out
