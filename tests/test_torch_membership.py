"""Self-healing pod membership in the port (``spfft_tpu_torch.net.
membership`` and its use by ``serve.cluster``), against the JAX
package's on the CPU.

``elect_coordinator`` and a signed view (the canonical JSON, HMAC-SHA256
under a secret, SHA-256 without one) equal the JAX package's exactly for
the same inputs, and each package verifies the other's views. Then the
JAX tests' contracts through the port: leases walk ``alive -> suspected
-> probed -> evicted`` at multiples of the TTL; epoch fencing rejects
stale work with the typed ``StaleEpochError`` and recovers on a view
refetch; a dead coordinator's followers converge on exactly one
successor (also over real TCP between three ``HostAgent``s, every
listener on port 0); a tampered view is the permanent ``NetAuthError``;
the frontend's resurrection ladder blocks a lane whose plan set diverged
and readmits it once the set converges, scheduling probes in the
background; TCP connects retry with a counted backoff on a refused
connect and fail fast on a timeout; two frontends over one coordinator
stay bit-exact through kill / readmit churn with no open span. Pods are
two ``ServeExecutor``s over port plans on the CPU. Every wait has a
deadline. The blob journal's GC over HTTP and with per-key failures
(the JAX file's cases that ``tests/test_torch_blobstore.py`` does not
hold) sweeps the port's ``torch/req/`` namespace.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from spfft_tpu import faults as jfaults
from spfft_tpu import obs as jobs
from spfft_tpu.control import config as jcfg
from spfft_tpu.net import membership as jmem

import spfft_tpu_torch as sp
from spfft_tpu_torch import faults, obs
from spfft_tpu_torch.benchmark import cutoff_stick_triplets
from spfft_tpu_torch.control import config as tcfg
from spfft_tpu_torch.control.config import global_config
from spfft_tpu_torch.errors import (BlobStoreError, HostLaneError,
                                    NetAuthError, StaleEpochError)
from spfft_tpu_torch.faults import FaultPlan, InjectedFault
from spfft_tpu_torch.net import membership as tmem
from spfft_tpu_torch.net.blobstore import (FileBlobStore, HttpBlobStore,
                                           gc_blobstore, serve_blobstore)
from spfft_tpu_torch.net.agent import HostAgent
from spfft_tpu_torch.net.membership import (ALIVE, EVICTED, PROBED,
                                            SUSPECTED, MembershipNode,
                                            MembershipView, ViewCoordinator,
                                            elect_coordinator)
from spfft_tpu_torch.net.transport import TcpHostLane
from spfft_tpu_torch.serve.cluster import HostLane, PodFrontend
from spfft_tpu_torch.serve.executor import ServeExecutor
from spfft_tpu_torch.serve.registry import PlanRegistry

torch.set_num_threads(2)

N = 8
DIMS = (N, N, N)
#: lease TTL every fake-clock test pins (never the live knob)
TTL = 2.0


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
def mem_plans():
    """Two distinct single-device plans on the CPU: the pod's serving
    plan plus a second signature the readmission-mismatch test
    withholds."""
    trip = cutoff_stick_triplets(N, N, N, 0.9, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip,
                                 precision="double", device="cpu")
    trip2 = cutoff_stick_triplets(N, N, N, 0.6, hermitian=False)
    sig2, plan2 = reg.get_or_build(sp.TransformType.C2C, *DIMS, trip2,
                                   precision="double", device="cpu")
    return {"trip": trip, "sig": sig, "plan": plan,
            "sig2": sig2, "plan2": plan2}


def _values(p, rng):
    n = len(p["trip"])
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def _wait(cond, seconds, what):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out after {seconds} s waiting for {what}")


# -- the JAX package's election and signed views, exactly --------------------
@pytest.mark.parametrize("states", [
    {"h2": ALIVE, "h0": EVICTED, "h1": ALIVE},
    {"h0": EVICTED}, {},
    {"b": ALIVE, "a10": SUSPECTED, "a9": ALIVE, "a1": PROBED},
])
def test_elect_coordinator_equals_the_jax_package(states):
    assert elect_coordinator(states) == jmem.elect_coordinator(states)


@pytest.mark.parametrize("secret", [None, b"pod-secret"])
def test_signed_views_equal_the_jax_package(secret):
    """The same lease history on the same fake clock gives both
    packages' coordinators the same view, signature included, and each
    verifies the other's."""
    now = [0.0]
    coords = [mod.ViewCoordinator("c0", clock=lambda: now[0],
                                  lease_ttl_s=TTL, secret=secret)
              for mod in (jmem, tmem)]
    for vc in coords:
        vc.heartbeat("a1", "127.0.0.1:1")
        vc.heartbeat("a2", "127.0.0.1:2")
        vc.ensure("h9")
    now[0] = 1.7 * TTL
    for vc in coords:
        vc.heartbeat("a2")
        vc.evict("h9")
    now[0] = 2.0 * TTL
    jview, tview = (vc.view().to_wire() for vc in coords)
    assert tview == jview
    assert tview["members"]["a1"]["state"] == PROBED
    assert MembershipView.from_wire(jview).verify(secret)
    assert jmem.MembershipView.from_wire(tview).verify(secret)
    assert coords[0].heartbeat("a3") == coords[1].heartbeat("a3")


# -- leases + expiry ladder ---------------------------------------------------
def test_lease_renewal_holds_and_expiry_walks_ladder():
    now = [0.0]
    vc = ViewCoordinator("c0", clock=lambda: now[0], lease_ttl_s=TTL,
                         secret=None)
    vc.heartbeat("a1", "127.0.0.1:1")
    e0 = vc.epoch
    for _ in range(5):
        now[0] += 0.9 * TTL
        vc.heartbeat("a1")
        assert not vc.expire()
    assert vc.view().states()["a1"] == ALIVE
    last = now[0]
    now[0] = last + 1.2 * TTL
    assert vc.expire() == [("a1", ALIVE, SUSPECTED)]
    now[0] = last + 1.8 * TTL
    assert vc.expire() == [("a1", SUSPECTED, PROBED)]
    now[0] = last + 2.8 * TTL
    assert vc.expire() == [("a1", PROBED, EVICTED)]
    assert vc.epoch == e0 + 3
    assert vc.view().states()["a1"] == EVICTED
    assert not vc.expire()
    ack = vc.heartbeat("a1")
    assert vc.view().states()["a1"] == ALIVE
    assert ack["epoch"] == vc.epoch == e0 + 4


def test_expiry_skips_rungs_for_a_long_dead_lease():
    now = [0.0]
    vc = ViewCoordinator("c0", clock=lambda: now[0], lease_ttl_s=TTL,
                         secret=None)
    vc.heartbeat("a1")
    now[0] = 10 * TTL
    assert vc.expire() == [("a1", ALIVE, EVICTED)]


def test_static_ensured_members_hold_no_lease_and_never_expire():
    now = [0.0]
    vc = ViewCoordinator("c0", clock=lambda: now[0], lease_ttl_s=TTL,
                         secret=None)
    vc.ensure("h1", "127.0.0.1:1")
    e0 = vc.epoch
    now[0] = 100 * TTL
    assert vc.expire() == []
    assert vc.view().states()["h1"] == ALIVE
    assert vc.epoch == e0
    vc.evict("h1")
    vc.readmit("h1")
    now[0] = 200 * TTL
    assert vc.expire() == []
    assert vc.view().states()["h1"] == ALIVE
    vc.heartbeat("h1")
    now[0] += 10 * TTL
    assert vc.expire() == [("h1", ALIVE, EVICTED)]


def test_heartbeat_fault_injection_is_typed_and_contained():
    vc = ViewCoordinator("c0", lease_ttl_s=TTL, secret=None)
    faults.arm(FaultPlan(script=["net.heartbeat@1"]))
    try:
        with pytest.raises(InjectedFault):
            vc.heartbeat("a1")
        ack = vc.heartbeat("a1")
        assert ack["coordinator"] == "c0"
    finally:
        faults.disarm()


# -- epoch fencing ------------------------------------------------------------
def test_epoch_fencing_stale_typed_then_current_passes():
    vc = ViewCoordinator("c0", lease_ttl_s=TTL, secret=None)
    vc.heartbeat("a1")
    vc.evict("a1")
    current = vc.epoch
    before = obs.GLOBAL_COUNTERS.get("spfft_cluster_stale_epoch_total",
                                     node="c0")
    with pytest.raises(StaleEpochError) as ei:
        vc.check_epoch(current - 1)
    assert ei.value.stale == current - 1
    assert ei.value.current == current
    assert obs.GLOBAL_COUNTERS.get("spfft_cluster_stale_epoch_total",
                                   node="c0") == before + 1
    vc.check_epoch(vc.view().epoch)
    vc.check_epoch(None)
    vc.check_epoch(current + 5)


# -- election -----------------------------------------------------------------
def test_elect_coordinator_is_pure_lowest_alive():
    assert elect_coordinator(
        {"h2": ALIVE, "h0": EVICTED, "h1": ALIVE}) == "h1"
    assert elect_coordinator({"h0": EVICTED}) is None
    assert elect_coordinator({}) is None


def test_coordinator_death_reelects_deterministically():
    now = [0.0]
    nodes, down = {}, set()

    def wire(addr, hdr):
        if addr in down:
            raise OSError(f"{addr} unreachable")
        return nodes[addr].on_heartbeat(str(hdr["host"]),
                                        hdr.get("address"))

    roster = {h: h for h in ("m0", "m1", "m2")}
    for h in roster:
        peers = {p: a for p, a in roster.items() if p != h}
        nodes[h] = MembershipNode(h, address=h, peers=peers,
                                  clock=lambda: now[0], secret=None)
    assert nodes["m0"].is_coordinator
    for h in ("m1", "m2"):
        assert nodes[h].tick(wire) == "ok"
    for h in ("m1", "m2"):
        nodes[h].adopt(nodes["m0"].on_view())
    pre = nodes["m0"].epoch
    down.add("m0")
    outcomes = [nodes["m1"].tick(wire) for _ in range(3)]
    assert outcomes == ["failed", "failed", "promoted"]
    assert nodes["m1"].is_coordinator
    assert nodes["m1"].epoch > pre
    outcomes = [nodes["m2"].tick(wire) for _ in range(4)]
    assert "re-elected" in outcomes and outcomes[-1] == "ok"
    assert not nodes["m2"].is_coordinator
    assert nodes["m2"].coordinator()[0] == "m1"
    nodes["m2"].adopt(nodes["m1"].on_view())
    assert nodes["m2"].epoch == nodes["m1"].epoch


def test_heartbeat_ack_carries_view_and_followers_adopt_it():
    coord = MembershipNode("a0", address="a0", secret=None)
    nodes = {"a0": coord}

    def wire(addr, hdr):
        return nodes[addr].on_heartbeat(str(hdr["host"]),
                                        hdr.get("address"))

    f1 = MembershipNode("a1", address="a1", peers={"a0": "a0"},
                        secret=None)
    f2 = MembershipNode("a2", address="a2", peers={"a0": "a0"},
                        secret=None)
    assert f1.tick(wire) == "ok" and f2.tick(wire) == "ok"
    assert f1.tick(wire) == "ok"
    for node in (f1, f2):
        assert node._view is not None
        assert node._view.verify(None)
    assert f1._view.states() == {"a0": ALIVE, "a1": ALIVE, "a2": ALIVE}
    assert f1.epoch == coord.epoch


def test_follower_served_view_stays_verifiable_through_failover():
    nodes, down = {}, set()

    def wire(addr, hdr):
        if addr in down:
            raise OSError(f"{addr} unreachable")
        return nodes[addr].on_heartbeat(str(hdr["host"]),
                                        hdr.get("address"))

    roster = {h: h for h in ("m0", "m1", "m2")}
    for h in roster:
        peers = {p: a for p, a in roster.items() if p != h}
        nodes[h] = MembershipNode(h, address=h, peers=peers, secret=None)
    for h in ("m1", "m2"):
        assert nodes[h].tick(wire) == "ok"
        assert nodes[h].tick(wire) == "ok"
    down.add("m0")
    outcomes = [nodes["m2"].tick(wire) for _ in range(3)]
    assert outcomes == ["failed", "failed", "re-elected"]
    served = nodes["m2"].on_view()
    assert MembershipView.from_wire(served).verify(None)
    fresh = MembershipNode("m9", peers={"m2": "m2"}, secret=None)
    assert fresh.adopt(served)
    assert nodes["m2"].coordinator()[0] == "m1"


def test_wire_coordinator_kill_exactly_one_node_promotes():
    """Three port agents over real TCP (port 0 each): kill the
    coordinator and exactly one survivor, the next-lowest id, promotes."""
    cfg = global_config()
    cfg.set("heartbeat_interval_ms", 100, source="test",
            reason="fast convergence for coordinator-kill test")
    agents: dict = {}
    exs = []
    try:
        for name in ("n0", "n1", "n2"):
            ex = ServeExecutor(PlanRegistry(store=False))
            exs.append(ex)
            peers = {h: f"127.0.0.1:{a.port}" for h, a in agents.items()}
            agents[name] = HostAgent(name, ex, peers=peers or None).start()
        assert agents["n0"].membership.is_coordinator
        _wait(lambda: all(
            agents[h].membership._view is not None
            and len(agents[h].membership._view.members) == 3
            for h in ("n1", "n2")), 20, "the full pod view on followers")
        pre = agents["n0"].membership.epoch
        agents["n0"].close()
        _wait(lambda: agents["n1"].membership.is_coordinator
              and agents["n2"].membership.coordinator()[0] == "n1", 30,
              "the survivors' convergence on a successor")
        promoted = [h for h in ("n1", "n2")
                    if agents[h].membership.is_coordinator]
        assert promoted == ["n1"]
        assert agents["n1"].membership.epoch > pre
        view = MembershipView.from_wire(agents["n1"].membership.on_view())
        assert view.coordinator == "n1"
        assert view.states()["n0"] != ALIVE
    finally:
        for agent in agents.values():
            agent.close()
        for ex in exs:
            ex.close(drain=False)


# -- signed views -------------------------------------------------------------
def test_view_sign_verify_and_tamper_rejection():
    vc = ViewCoordinator("c0", lease_ttl_s=TTL, secret=b"pod-secret")
    vc.heartbeat("a1", "127.0.0.1:1")
    view = vc.view()
    assert view.verify(b"pod-secret")
    assert not view.verify(b"wrong-secret")
    assert not view.verify(None)
    tampered = view.to_wire()
    tampered = {**tampered,
                "members": {h: dict(r)
                            for h, r in tampered["members"].items()}}
    tampered["members"]["a1"]["state"] = EVICTED
    assert not MembershipView.from_wire(tampered).verify(b"pod-secret")
    node = MembershipNode("a1", peers={"c0": "c0"}, secret=b"pod-secret")
    with pytest.raises(NetAuthError):
        node.adopt(tampered)
    assert node.adopt(view.to_wire())


def test_unsigned_views_still_carry_integrity_digest():
    vc = ViewCoordinator("c0", lease_ttl_s=TTL, secret=None)
    view = vc.view()
    assert view.verify(None)
    wire = view.to_wire()
    wire["epoch"] = view.epoch + 7
    assert not MembershipView.from_wire(wire).verify(None)


# -- frontend integration: fencing + resurrection ladder ---------------------
def _shared_pod_pair(p, mm, seed=0):
    """Two loopback frontends over the SAME executors and the SAME
    coordinator — each with its own lane objects."""
    regs = []
    for _ in range(2):
        reg = PlanRegistry(store=False)
        reg.put(p["sig"], p["plan"])
        regs.append(reg)
    exs = [ServeExecutor(r) for r in regs]
    fa = PodFrontend([HostLane("h0", exs[0]), HostLane("h1", exs[1])],
                     membership=mm, seed=seed)
    fb = PodFrontend([HostLane("h0", exs[0]), HostLane("h1", exs[1])],
                     membership=mm, seed=seed + 1)
    return fa, fb, exs


def _close(fa, fb, exs):
    fa.close()
    fb.close()
    for ex in exs:
        ex.close()


def test_stale_frontend_fenced_typed_then_recovers(mem_plans):
    p = mem_plans
    rng = np.random.default_rng(3)
    mm = ViewCoordinator("h0", lease_ttl_s=TTL, secret=None)
    fa, fb, exs = _shared_pod_pair(p, mm)
    try:
        e0 = fa.epoch
        assert fb.epoch == e0
        fa._mark_dead(fa._lanes[1])
        assert fa.epoch > e0
        before = obs.GLOBAL_COUNTERS.get(
            "spfft_cluster_stale_epoch_total", node="frontend")
        v = _values(p, rng)
        got = fb.submit(p["sig"], v).result(timeout=60)
        assert torch.equal(got, p["plan"].backward(v))
        assert obs.GLOBAL_COUNTERS.get(
            "spfft_cluster_stale_epoch_total",
            node="frontend") == before + 1
        assert fb.epoch == fa.epoch
        assert fa.view()["members"]["h1"]["state"] == EVICTED
    finally:
        _close(fa, fb, exs)


def test_readmission_blocked_on_reconcile_mismatch(mem_plans):
    p = mem_plans
    mm = ViewCoordinator("h0", lease_ttl_s=TTL, secret=None)
    fa, fb, exs = _shared_pod_pair(p, mm)
    try:
        exs[0].registry.put(p["sig2"], p["plan2"])
        lane = fa._lanes[1]
        fa._mark_dead(lane)
        lane.transport.alive = True
        assert fa.probe_dead(force=True) == {"h1": "blocked"}
        assert obs.GLOBAL_COUNTERS.get("spfft_cluster_readmits_total",
                                       host="h1",
                                       outcome="blocked") >= 1
        assert fa.view()["members"]["h1"]["state"] == EVICTED
        exs[1].registry.put(p["sig2"], p["plan2"])
        assert fa.probe_dead(force=True) == {"h1": "readmitted"}
        assert fa.view()["members"]["h1"]["state"] == ALIVE
        assert fb.view()["epoch"] == fa.epoch
        assert not fa._on_ladder("h1")
    finally:
        _close(fa, fb, exs)


def test_probe_respects_backoff_and_dead_host(mem_plans):
    p = mem_plans
    mm = ViewCoordinator("h0", lease_ttl_s=TTL, secret=None)
    fa, fb, exs = _shared_pod_pair(p, mm)
    try:
        fa._mark_dead(fa._lanes[1])
        assert fa.probe_dead(force=False) == {"h1": "backoff"}
        assert fa.probe_dead(force=True) == {"h1": "failed"}
        with fa._dead_lock:
            attempts, deadline = fa._dead["h1"]
        assert attempts == 1 and deadline > time.monotonic()
    finally:
        _close(fa, fb, exs)


def test_routing_schedules_probes_in_background(mem_plans):
    p = mem_plans
    rng = np.random.default_rng(9)
    mm = ViewCoordinator("h0", lease_ttl_s=TTL, secret=None)
    fa, fb, exs = _shared_pod_pair(p, mm)
    entered = threading.Event()
    release = threading.Event()
    try:
        lane = fa._lanes[1]
        orig_health = lane.rpc_health

        def stalled_health():
            entered.set()
            release.wait(30)
            return orig_health()

        lane.rpc_health = stalled_health
        fa._mark_dead(lane)
        lane.transport.alive = True
        with fa._dead_lock:
            fa._dead["h1"][1] = 0.0
        v = _values(p, rng)
        got = fa.submit(p["sig"], v).result(timeout=60)
        assert torch.equal(got, p["plan"].backward(v))
        assert entered.wait(10), "probe was never scheduled"
        assert fa._on_ladder("h1")
        assert fa.probe_dead(force=True).get("h1") == "probing"
        release.set()
        _wait(lambda: not fa._on_ladder("h1"), 10, "the readmission")
        assert fa.view()["members"]["h1"]["state"] == ALIVE
    finally:
        release.set()
        _close(fa, fb, exs)


# -- connect retry ------------------------------------------------------------
def test_tcp_connect_retries_are_counted():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens here any more
    before = obs.GLOBAL_COUNTERS.get("spfft_net_rpc_retries_total",
                                     verb="health")
    lane = TcpHostLane("hx", ("127.0.0.1", port))
    try:
        with pytest.raises(HostLaneError):
            lane.rpc_health()
    finally:
        lane.close()
    assert obs.GLOBAL_COUNTERS.get("spfft_net_rpc_retries_total",
                                   verb="health") >= before + 2


def test_tcp_connect_timeout_fails_fast(monkeypatch):
    import spfft_tpu_torch.net.transport as transport_mod

    calls = []

    def timed_out(address, timeout=None):
        calls.append(address)
        raise socket.timeout("connect timed out")

    monkeypatch.setattr(transport_mod.socket, "create_connection",
                        timed_out)
    before = obs.GLOBAL_COUNTERS.get("spfft_net_rpc_retries_total",
                                     verb="health")
    lane = TcpHostLane("hx", ("10.255.255.1", 9))
    try:
        with pytest.raises(HostLaneError):
            lane.rpc_health()
    finally:
        lane.close()
    assert len(calls) == 1
    assert obs.GLOBAL_COUNTERS.get("spfft_net_rpc_retries_total",
                                   verb="health") == before


# -- blob journal GC (the cases test_torch_blobstore.py does not hold) ---------
def _journal(store, root):
    base = time.time()
    for i, key in enumerate(("torch/req/old", "torch/req/mid",
                             "torch/req/new")):
        store.put(key, bytes(100))
        os.utime(os.path.join(root, *key.split("/")), (base + i, base + i))


def test_blob_gc_http_stat_delete_and_sweep(tmp_path):
    root = str(tmp_path)
    server, thread = serve_blobstore(root)
    try:
        store = HttpBlobStore(f"http://127.0.0.1:{server.server_port}")
        _journal(store, root)
        st = store.stat("torch/req/old")
        assert st is not None and st["size"] == 100
        assert store.stat("torch/req/ghost") is None
        out = gc_blobstore(store, max_bytes=100)
        assert out["removed"] == ["torch/req/old", "torch/req/mid"]
        assert out["bytes_in_use"] == 100
        assert store.delete("torch/req/new") is True
        assert store.delete("torch/req/new") is False
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_blob_gc_per_key_failures_are_nonfatal(tmp_path):
    class FlakyStore(FileBlobStore):
        def stat(self, key):
            if key == "torch/req/mid":
                raise BlobStoreError("injected stat failure")
            return super().stat(key)

    store = FlakyStore(str(tmp_path))
    _journal(store, str(tmp_path))
    assert gc_blobstore(store, max_bytes=0)["removed"] == []
    out = gc_blobstore(store, max_bytes=1)
    assert out["errors"] == 1  # the flaky key is skipped, not fatal
    assert "torch/req/mid" not in out["removed"]
    assert len(out["removed"]) == 2
    assert obs.GLOBAL_COUNTERS.get("spfft_blob_gc_total",
                                   outcome="error") == 1


# -- two-frontend convergence fuzz -------------------------------------------
def test_two_frontend_convergence_fuzz(mem_plans):
    """8 threads hammer two frontends over a shared coordinator while
    the main thread churns h1 through kill -> probe -> readmit: every
    request bit for bit its serial call, one epoch, no open span."""
    p = mem_plans
    obs.enable()
    tracer = obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)
    mm = ViewCoordinator("h0", lease_ttl_s=TTL, secret=None)
    fa, fb, exs = _shared_pod_pair(p, mm, seed=11)
    stop = threading.Event()
    errors: list = []

    def hammer(front, seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            v = _values(p, rng)
            try:
                got = front.submit(p["sig"], v).result(timeout=60)
                if not torch.equal(got, p["plan"].backward(v)):
                    errors.append("diverged result")
            except Exception as exc:  # noqa: BLE001 - fuzz verdict
                errors.append(f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=hammer,
                                args=(front, 100 + i), daemon=True)
               for i, front in enumerate([fa, fb] * 4)]
    for t in threads:
        t.start()
    try:
        for _ in range(3):
            time.sleep(0.15)
            fa._mark_dead(fa._lanes[1])
            time.sleep(0.15)
            fa._lanes[1].transport.alive = True
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if fa.probe_dead(force=True).get("h1") == "readmitted" \
                        or not fa._on_ladder("h1"):
                    break
                time.sleep(0.05)
            else:
                errors.append("churn round never readmitted h1")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        _close(fa, fb, exs)
        obs.disable()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    va, vb = fa.view(), fb.view()
    assert va["epoch"] == vb["epoch"] == mm.epoch
    assert fa.epoch == fb.epoch == mm.epoch
    assert va["members"]["h1"]["state"] == ALIVE
    assert tracer.open_count() == 0
