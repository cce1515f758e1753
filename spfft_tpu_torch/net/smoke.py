"""A REAL multi-process pod over localhost TCP (the port of
``spfft_tpu/net/smoke.py``).

``serve.cluster``'s smoke proves the pod contracts against loopback
lanes in one process; this one proves the wire. It spawns agent
processes (``python -m spfft_tpu_torch.net.agent``), fronts them with
:class:`~spfft_tpu_torch.net.transport.TcpHostLane`, and checks end to
end:

* a mixed single-device + distributed trace is bit-exact against a
  serial oracle built in THIS process — same plans, different process,
  every payload crossing the frame protocol twice;
* two CONCURRENT same-signature distributed requests provably
  coalesce agent-side: signature affinity co-locates them, the
  agents' ``spmd_batch_window`` (booted off a
  ``SPFFT_TPU_SERVE_CONFIG`` knob artifact) drains both into one
  batched round (``spfft_cluster_spmd_coalesced_total`` moves, one
  ``cluster.spmd_execute`` span carries both member trace ids) and
  both stay bit-exact;
* one trace id end-to-end: the agents' ``serve.request`` /
  ``cluster.spmd_execute`` spans (fetched over the ``spans`` RPC)
  carry the frontend's ``cluster.request`` trace ids, and neither side
  leaks an open span;
* a host JOINING mid-stream boots warm off the shared blob tier
  (remote registry ``builds == 0`` after the prewarm +
  re-reconciliation) and then serves traffic;
* ``kill -9`` of an agent fails over TYPED — survivors stay bit-exact,
  the pod degrades, nothing hangs and nothing leaks;
* the pod SELF-HEALS with zero operator intervention: the killed
  agent's lease expires on the coordinator (agents heartbeat each
  other over the wire), the eviction bumps the view epoch and TWO
  concurrent frontends converge on the same epoch/view, the agent
  restarts on the same port with a fresh store dir (warm boot off the
  shared blob tier, ``builds == 0``), heartbeats itself back into the
  view, and the routing-piggybacked probe ladder re-reconciles and
  readmits it — after which it serves bit-exact again;
* a drain-leave walks the membership ladder
  (``leave_started → drained → left``).

The defaults are the JAX smoke's (n = 10, stick cutoff 0.9, 2 shards,
double precision). ``--device`` is the oracle's device and passes
through to the agents (default: the card; agent ``i`` on card ``i mod``
the visible count; ``cpu`` runs the kernels' plain versions). Payloads
are the plans' interleaved ``(N, 2)`` values (distributed: the stacked
``(S, max_values, 2)`` layout), seeded once and scaled per request.
:func:`run_pod_smoke` takes the size, the plan set, the request
counts, a smaller size for the join, kill and heal steps and a number of
requests timed one at a time, and returns the wire numbers beside the
exit code (how ``chip_smoke.py`` drives it at 256³). Agents' stderr goes
to a log in the smoke's directory, whose tail is printed on failure.

Prints ``POD SMOKE GREEN`` and exits 0 on success.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from .transport import TcpHostLane

#: the repository root: agents run ``-m spfft_tpu_torch.net.agent`` from it
_ROOT = Path(__file__).resolve().parents[2]

#: request counts of each step (the JAX smoke's)
COUNTS = {"singles": 24, "join": 6, "kill": 6, "readmit": 8}


def _agent_device(device: torch.device, i: int) -> str:
    """Agent ``i``'s device: card ``i`` mod the visible count for a card
    without an index, else ``device`` itself."""
    if device.type == "cuda" and device.index is None:
        return f"cuda:{i % max(1, torch.cuda.device_count())}"
    return str(device)


def _tail(path: str, nbytes: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError as exc:
        return f"(no log: {exc})"


def _start_agent(host: str, store: str, blob: str, warm: str,
                 device: str, log: str, extra_env=None, port: int = 0,
                 peers: str = "") -> subprocess.Popen:
    """Start one agent process (its stderr appended to ``log``).
    ``extra_env`` boots agents off a ``SPFFT_TPU_SERVE_CONFIG`` knob
    artifact; ``port`` pins the listen port (the restart half of the
    self-healing phase rebinds the dead agent's address) and ``peers``
    seeds the agent's membership roster."""
    cmd = [sys.executable, "-m", "spfft_tpu_torch.net.agent",
           "--host", host, "--port", str(port), "--trace",
           "--store", store, "--blob", blob, "--demo-warm", warm,
           "--device", device]
    if peers:
        cmd += ["--peers", peers]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    env.update(extra_env or {})
    with open(log, "ab") as err:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err,
                                text=True, env=env, cwd=str(_ROOT))


def _await_port(proc: subprocess.Popen, host: str, log: str,
                timeout: float = 240.0) -> int:
    """The port an agent announces on stdout; raises (with the tail of
    the agents' log) if the agent dies or stays silent past ``timeout``
    seconds."""
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            break
        ready, _, _ = select.select([proc.stdout], [], [], left)
        if not ready:
            break
        line = proc.stdout.readline()
        if not line:
            break  # EOF — the agent died during warmup
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("agent") == host and "port" in rec:
            return int(rec["port"])
    proc.kill()
    proc.wait(timeout=30)
    raise RuntimeError(
        f"agent {host!r} never announced its port (exit={proc.poll()}); "
        f"its log ends:\n{_tail(log)}")


def _spawn_agent(host: str, store: str, blob: str, warm: str,
                 device: str, log: str, timeout: float = 240.0,
                 **kw) -> Tuple[subprocess.Popen, int]:
    """:func:`_start_agent` then :func:`_await_port`: ``(proc, port)``."""
    proc = _start_agent(host, store, blob, warm, device, log, **kw)
    return proc, _await_port(proc, host, log, timeout)


def _counter_sum(name: str, since: Optional[dict] = None,
                 **labels) -> float:
    """Sum this process's samples of ``name`` matching ``labels``, less
    their sum in ``since`` (a ``GLOBAL_COUNTERS.snapshot()``)."""
    def total(snapshot) -> float:
        fam = snapshot.get(name)
        if not fam:
            return 0.0
        return sum(value for key, value in fam["samples"].items()
                   if all(dict(key).get(k) == v
                          for k, v in labels.items()))
    now = total(_obs.GLOBAL_COUNTERS.snapshot())
    return now - total(since) if since is not None else now


def _agent_counter_sum(lanes, name: str) -> float:
    """Sum ``name``'s samples over the agents' ``/metrics`` text."""
    total = 0.0
    for lane in lanes:
        for line in lane.rpc_metrics_text().splitlines():
            if line.startswith(name):
                total += float(line.rsplit(None, 1)[-1])
    return total


def _await_member(pod, host: str, timeout: float = 60.0) -> dict:
    """Poll ``pod``'s view (which refreshes its epoch stamp) until
    ``host`` is an alive member; raises past ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        view = pod.view()
        if view["members"].get(host, {}).get("state") == "alive":
            return view
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"{host!r} never became an alive member of the view: "
                f"{view}")
        time.sleep(0.05)


def _oracle(spec: str, device):
    """The serial oracle: the agents' plan builds (``--demo-warm
    spec``, one set), here. Returns ``(sig, plan, dsig, dplan)``."""
    from ..serve.registry import PlanRegistry
    from .agent import _demo_warm
    reg = PlanRegistry(store=False)
    _demo_warm(reg, spec, device)
    sig, dsig = sorted(reg.signatures(), key=lambda g: g.device_count)
    return sig, reg.get(sig), dsig, reg.get(dsig)


def _solo_requests(pod, sig, plan, values, k, check) -> dict:
    """``k`` single backward requests through ``pod``, one at a time
    (nothing else in flight), each timed from the frontend: ``submit_s``
    (the lane packs the values, connects and sends the frame before the
    submit returns) and ``reply_s`` (from there to the result: the
    agent's unpack, plan call and pack, the reply's transfer, the
    frontend's receive and unpack). Beside them, the same steps' calls
    timed in this process on the same values and result:
    ``pack_values_s`` / ``unpack_values_s`` (the request's payload),
    ``plan_s`` (the plan call from host values to a host result, as the
    agent runs it) and ``pack_space_s`` / ``unpack_space_s`` (the
    reply's). ``rest_s`` is the wall time less those five: the sockets
    both ways and what else the two ends do. Medians over the ``k``."""
    from .frame import pack_values, unpack_tensors
    rows = []
    for _ in range(k):
        v = values()
        t0 = time.perf_counter()
        fut = pod.submit_backward(sig, v)
        t1 = time.perf_counter()
        got = fut.result(timeout=300)
        t2 = time.perf_counter()
        row = {"submit_s": t1 - t0, "reply_s": t2 - t1, "wall_s": t2 - t0}
        t = time.perf_counter()
        vmeta, vpay = pack_values(v)
        row["pack_values_s"] = time.perf_counter() - t
        t = time.perf_counter()
        unpack_tensors(vmeta, vpay)
        row["unpack_values_s"] = time.perf_counter() - t
        del vpay
        t = time.perf_counter()
        want = plan.backward(v).cpu()
        row["plan_s"] = time.perf_counter() - t
        check(torch.equal(got, want),
              "solo result not bit-exact vs serial oracle")
        t = time.perf_counter()
        smeta, spay = pack_values(want)
        row["pack_space_s"] = time.perf_counter() - t
        t = time.perf_counter()
        unpack_tensors(smeta, spay)
        row["unpack_space_s"] = time.perf_counter() - t
        del spay, want, got
        row["rest_s"] = row["wall_s"] - sum(
            row[key] for key in ("pack_values_s", "unpack_values_s",
                                 "plan_s", "pack_space_s",
                                 "unpack_space_s"))
        rows.append(row)
    out = {key: float(np.median([r[key] for r in rows])) for key in rows[0]}
    out["requests"] = k
    return out


def run_pod_smoke(seed: int = 0, device=None, n: int = 10,
                  cutoff: str = "0.9", shards: int = 2,
                  precision: str = "double",
                  counts: Optional[Dict[str, int]] = None,
                  log_dir: Optional[str] = None,
                  lease_ttl_ms: int = 300,
                  heartbeat_interval_ms: int = 100,
                  heal_n: Optional[int] = None,
                  solo: int = 0
                  ) -> Tuple[List[str], dict]:
    """The smoke's flow on the ``n``^3 C2C set ``cutoff`` (a stick
    sparsity or ``sphere``) over ``shards`` shards in ``precision``,
    with the oracle on ``device`` (None: the card) and the agents on
    :func:`_agent_device`'s. ``counts`` overrides :data:`COUNTS`;
    ``log_dir`` keeps the agents' log (default: the smoke's temporary
    directory). The agents' leases are ``lease_ttl_ms``, renewed every
    ``heartbeat_interval_ms`` (the JAX smoke's 300 / 100 by default; an
    agent moving 200 MB frames can miss a 300 ms renewal, and each such
    suspicion bumps the view epoch twice, so large payloads want longer
    leases). ``heal_n`` (None: ``n``) is the size of the requests the
    join, kill and self-heal steps send: the agents then hold both plan
    sets, and the trace and the coalesced pair stay at ``n``. ``solo``
    requests of the trace's size follow the trace-id checks one at a
    time, each timed alone with its frontend-side steps apart (packing,
    connect and send, the reply) and the agent's steps timed as the same
    calls in this process (unpack, the plan call, pack). Returns the
    failures and the wire numbers (an agent's ``agent_start_s`` runs
    until the smoke reads its port: the joiner's, after the trace). The
    joiner boots beside the trace and enters the membership view before
    the concurrent pair, so its epoch bump fences no member of the
    pair."""
    from ..control.config import CONFIG_ENV, ServeConfig, global_config
    from ..plan import resolve_device
    from ..serve.cluster import PodFrontend

    device = torch.device("cuda" if device is None else device)
    oracle_device = resolve_device(device)
    counts = dict(COUNTS, **(counts or {}))
    failures: List[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    heal_n = n if heal_n is None else int(heal_n)
    sizes = [n] + ([heal_n] if heal_n != n else [])
    full = ";".join(f"{k},{cutoff},{shards},full,{precision}"
                    for k in sizes)
    dist_only = ";".join(f"{k},{cutoff},{shards},dist,{precision}"
                         for k in sizes)
    sig, plan, dsig, dplan = _oracle(full.split(";")[0], oracle_device)
    hsig, hplan = (sig, plan) if heal_n == n else \
        _oracle(full.split(";")[1], oracle_device)[:2]
    real = np.float32 if precision == "single" else np.float64
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((plan.index_plan.num_values, 2)).astype(real)
    dbase = dplan.shard_values([
        rng.standard_normal((p.num_values, 2)).astype(real)
        for p in dplan.dist_plan.shard_plans])
    hbase = base if heal_n == n else rng.standard_normal(
        (hplan.index_plan.num_values, 2)).astype(real)
    issued = [0]

    def values(b=base):
        issued[0] += 1
        return b * real(1 + issued[0] / 64)

    def dvalues():
        issued[0] += 1
        return dbase * (1 + issued[0] / 64)

    def same(got, want) -> bool:
        return torch.equal(got, want.cpu())

    _obs.enable()
    # the counters are the process's: count from here (a caller may
    # have run a pod of the same host names before)
    start_counts = _obs.GLOBAL_COUNTERS.snapshot()

    def counted(name, **labels) -> float:
        return _counter_sum(name, since=start_counts, **labels)

    tracer = _obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)

    tmp = tempfile.TemporaryDirectory(prefix="spfft-pod-smoke-")
    log = os.path.join(log_dir or tmp.name, "agents.log")
    blob = os.path.join(tmp.name, "blob")
    os.makedirs(blob)
    # knob artifact the agents boot from: a generous coalescing window
    # so the coalesce phase's concurrent pair provably shares a round
    knob_cfg = ServeConfig()
    knob_cfg.set("spmd_batch_window", 0.25, source="smoke",
                 reason="pod-smoke coalesce phase window")
    # tight leases so the self-healing phase's kill -> lease-expiry ->
    # evict ladder resolves in well under a second of wall clock
    knob_cfg.set("lease_ttl_ms", lease_ttl_ms, source="smoke",
                 reason="pod-smoke fast lease expiry")
    knob_cfg.set("heartbeat_interval_ms", heartbeat_interval_ms,
                 source="smoke", reason="pod-smoke fast lease renewal")
    knob_path = os.path.join(tmp.name, "serve_config.json")
    knob_cfg.save(knob_path)
    agent_env = {CONFIG_ENV: knob_path}
    # frontend-side: keep the resurrection ladder's exponential
    # backoff short so routing-piggybacked probes readmit quickly
    cfg = global_config()
    old_backoff = cfg.lane_probe_backoff
    cfg.set("lane_probe_backoff", 0.05, source="smoke",
            reason="pod-smoke fast readmission probes")
    procs: Dict[str, subprocess.Popen] = {}
    lanes: Dict[str, TcpHostLane] = {}
    ports: Dict[str, int] = {}
    numbers: dict = {"n": n, "heal_n": heal_n, "cutoff": cutoff,
                     "shards": shards, "precision": precision,
                     "device": str(oracle_device)}
    pod = pod2 = None

    def start(host, i, store, spec, **kw):
        procs[host] = _start_agent(
            host, os.path.join(tmp.name, store), blob, spec,
            _agent_device(device, i), log, extra_env=agent_env, **kw)
        return host, store, time.perf_counter()

    def await_port(started):
        host, store, t0 = started
        port = _await_port(procs[host], host, log)
        numbers.setdefault("agent_start_s", {})[store] = \
            time.perf_counter() - t0
        return port

    def served(front, k, what):
        for _ in range(k):
            v = values(hbase)
            got = front.submit_backward(hsig, v).result(timeout=300)
            check(same(got, hplan.backward(v)),
                  f"{what} result not bit-exact vs serial oracle")

    crossed = 0
    try:
        ports["h0"] = await_port(start("h0", 0, "store-h0", full))
        peers = f"h0=127.0.0.1:{ports['h0']}"
        started_h1 = start("h1", 1, "store-h1", full, peers=peers)
        # the joiner boots now, beside h1 (its single plan comes off the
        # blob tier h0 filled before announcing); it joins mid-stream
        started_h2 = start("h2", 2, "store-h2", dist_only, peers=peers)
        ports["h1"] = await_port(started_h1)
        for host in ("h0", "h1"):
            lanes[host] = TcpHostLane(host, ("127.0.0.1", ports[host]))
        pod = PodFrontend([lanes["h0"], lanes["h1"]], policy="rr",
                          seed=seed)

        # -- mixed traffic, bit-exact across two real processes --------
        sent0 = _counter_sum("spfft_net_bytes_total", dir="send")
        recv0 = _counter_sum("spfft_net_bytes_total", dir="recv")
        t0 = time.perf_counter()
        singles = []
        for _ in range(counts["singles"]):
            v = values()
            singles.append((v, pod.submit_backward(sig, v)))
        dv = dvalues()
        dfut = pod.submit(dsig, dv)
        results = [(v, fut.result(timeout=300)) for v, fut in singles]
        dgot = dfut.result(timeout=300)
        trace_s = time.perf_counter() - t0
        sent = _counter_sum("spfft_net_bytes_total", dir="send") - sent0
        recv = _counter_sum("spfft_net_bytes_total", dir="recv") - recv0
        requests = counts["singles"] + 1
        numbers.update({
            "trace_requests": requests, "trace_s": trace_s,
            "s_per_request": trace_s / requests,
            "wire_bytes_per_request_sent": sent / requests,
            "wire_bytes_per_request_received": recv / requests,
            "rtt_ewma_s": {h: lane.transport.rtt
                           for h, lane in lanes.items()}})
        for v, got in results:
            check(same(got, plan.backward(v)),
                  "single result not bit-exact vs serial oracle")
        check(same(dgot, dplan.backward(dv)),
              "distributed result not bit-exact vs serial oracle")
        del results, singles, dgot

        # -- the joiner in the view before the pair --------------------
        # the joiner boots beside the trace; its first heartbeat makes it
        # a member, which bumps the view epoch and fences every submit
        # stamped before it. Let that happen now, with the frontend's
        # stamp refreshed after it: a fenced resend of one of the pair
        # would arrive a round trip after the other, past the window
        ports["h2"] = await_port(started_h2)
        epoch_pair = _await_member(pod, "h2")["epoch"]
        fenced0 = _agent_counter_sum(lanes.values(),
                                     "spfft_cluster_stale_epoch_total")
        numbers["trace_fenced"] = fenced0

        # -- cross-request SPMD coalescing over the real wire ----------
        # two concurrent same-signature distributed submits, each from
        # its own thread (a submit sends its whole frame before it
        # returns): signature affinity co-locates them on one agent,
        # whose window (the knob artifact above, clamped to 0.1 s)
        # drains both into ONE batched round
        dpair = [dvalues() for _ in range(2)]
        pair_futs = [None, None]

        def pair_submit(k):
            pair_futs[k] = pod.submit(dsig, dpair[k])

        threads = [threading.Thread(target=pair_submit, args=(k,))
                   for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if any(f is None for f in pair_futs):
            raise RuntimeError("a paired distributed submit did not return")
        for d, fut in zip(dpair, pair_futs):
            check(same(fut.result(timeout=300), dplan.backward(d)),
                  "coalesced distributed result not bit-exact vs "
                  "serial oracle")
        coalesced = _agent_counter_sum(
            lanes.values(), "spfft_cluster_spmd_coalesced_total")
        fenced = _agent_counter_sum(
            lanes.values(), "spfft_cluster_stale_epoch_total") - fenced0
        epochs = (epoch_pair, pod.view()["epoch"])
        numbers["pair"] = {"epochs": list(epochs), "fenced": fenced}
        check(coalesced >= 2,
              f"agent-side spfft_cluster_spmd_coalesced_total is "
              f"{coalesced}, the concurrent pair never shared a round "
              f"(view epoch {epochs[0]} before the pair, {epochs[1]} "
              f"after; {fenced} submits fenced as stale meanwhile)")

        # -- one trace id across the process boundary ------------------
        check(tracer.open_count() == 0,
              f"{tracer.open_count()} unclosed client spans")
        roots = [s for s in tracer.events()
                 if isinstance(s, _obs.Span)
                 and s.name == "cluster.request"]
        check(len(roots) == requests + 2,
              f"expected {requests + 2} cluster.request roots, got "
              f"{len(roots)}")
        root_ids = {s.trace_id for s in roots}
        shared_rounds = []
        for host, lane in lanes.items():
            remote = lane.rpc_spans()
            check(remote["open"] == 0,
                  f"{host}: {remote['open']} unclosed agent spans")
            served_spans = [s for s in remote["spans"]
                            if s["name"] in ("serve.request",
                                             "cluster.spmd_execute")]
            foreign = [s for s in served_spans
                       if s["trace_id"] not in root_ids]
            check(not foreign,
                  f"{host}: {len(foreign)} agent spans carry trace ids "
                  f"no client root issued")
            crossed += len(served_spans)
            shared_rounds += [
                s for s in remote["spans"]
                if s["name"] == "cluster.spmd_execute"
                and len(s.get("member_trace_ids") or []) >= 2]
        # the singles + the solo distributed request + ONE coalesced
        # round serving the concurrent pair
        check(crossed >= requests + 1,
              f"only {crossed} spans crossed the process boundary")
        check(len(shared_rounds) == 1
              and set(shared_rounds[0]["member_trace_ids"]) <= root_ids,
              f"expected ONE cluster.spmd_execute span serving both "
              f"paired requests, got {len(shared_rounds)}")

        # -- the trace's request again, one at a time, timed apart -----
        if solo:
            numbers["solo"] = _solo_requests(pod, sig, plan, values, solo,
                                             check)

        # -- elastic join: boots warm off the blob tier ----------------
        lanes["h2"] = TcpHostLane("h2", ("127.0.0.1", ports["h2"]))
        t0 = time.perf_counter()
        pod.join(lanes["h2"])
        numbers["join_s"] = time.perf_counter() - t0
        stats2 = lanes["h2"].rpc_stats()
        check(stats2.get("builds", -1) == 0,
              f"joiner built plans instead of booting warm: {stats2}")
        served(pod, counts["join"], "post-join")
        check(counted("spfft_cluster_routed_total",
                      host="h2") >= 1,
              "joined host h2 served no traffic")
        check(counted("spfft_cluster_membership_total",
                      event="joined") >= 1,
              "membership ladder missing the 'joined' event")

        # -- kill -9 one agent: typed failover, bit-exact survivors ----
        epoch_pre = pod.view()["epoch"]
        t_kill = time.perf_counter()
        procs["h1"].kill()
        procs["h1"].wait(timeout=30)
        failover_s = None
        for _ in range(counts["kill"]):
            v = values(hbase)
            # a submit connects and sends before it returns: a route to
            # the dead host fails over inside it
            fut = pod.submit_backward(hsig, v)
            if failover_s is None and pod._on_ladder("h1"):
                failover_s = time.perf_counter() - t_kill
            check(same(fut.result(timeout=300), hplan.backward(v)),
                  "survivor result not bit-exact after kill -9")
        numbers["kill_to_failover_s"] = failover_s
        # the lane is out of routing: on the resurrection ladder (its
        # transport flag flips on while a background probe re-tests it)
        check(pod._on_ladder("h1"),
              "killed lane h1 is not on the resurrection ladder")
        check(counted("spfft_cluster_rpc_failures_total",
                      host="h1") >= 1,
              "kill -9 produced no typed RPC failure")
        health = pod.health()
        check(health["state"] == "degraded",
              f"pod not degraded after kill -9: {health['state']}")
        check(tracer.open_count() == 0,
              "unclosed client spans after failover phase")

        # -- self-healing: lease expiry -> evict -> restart -> readmit -
        pod2 = PodFrontend(
            [TcpHostLane(h, ("127.0.0.1", ports[h]))
             for h in ("h0", "h2")], seed=seed + 1)
        evicted_view = None
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            va = pod.view()
            if (va["members"].get("h1", {}).get("state") == "evicted"
                    and va["epoch"] > epoch_pre):
                evicted_view = va
                numbers["kill_to_eviction_s"] = \
                    time.perf_counter() - t_kill
                break
            time.sleep(0.1)
        check(evicted_view is not None,
              "h1's lease never expired into an eviction on the "
              "coordinator (no epoch bump seen by frontend A)")
        vb = pod2.view()
        check(evicted_view is not None
              and vb["epoch"] == evicted_view["epoch"]
              and vb["members"].get("h1", {}).get("state") == "evicted",
              f"frontend B did not converge on the eviction view: "
              f"{vb} vs {evicted_view}")
        # restart the killed agent on the SAME port (fresh store dir:
        # its warm boot must come from the shared blob tier)
        t_restart = time.perf_counter()
        await_port(start("h1", 1, "store-h1-r", full, port=ports["h1"],
                         peers=peers))
        probe_lane = TcpHostLane("h1", ("127.0.0.1", ports["h1"]))
        try:
            check(probe_lane.rpc_stats().get("builds", -1) == 0,
                  "restarted h1 built plans instead of booting warm "
                  "off the blob tier")
        finally:
            probe_lane.close()
        # zero operator intervention: routed traffic drives frontend
        # A's probe ladder (it observed the death) until the lane is
        # re-reconciled and readmitted; frontend B keeps serving
        # through it directly
        readmit_deadline = time.monotonic() + 60.0
        while time.monotonic() < readmit_deadline:
            for front in (pod, pod2):
                served(front, 1, "readmission-window")
            if (counted("spfft_cluster_readmits_total",
                         host="h1", outcome="readmitted") >= 1):
                break
            time.sleep(0.2)
        numbers["restart_to_readmission_s"] = \
            time.perf_counter() - t_restart
        check(counted("spfft_cluster_readmits_total",
                      host="h1", outcome="readmitted") >= 1,
              "the probe ladder never readmitted restarted h1")
        check(lanes["h1"].alive,
              "restarted h1's lane still marked dead after readmission")
        alive_view = pod.view()
        check(evicted_view is not None
              and alive_view["members"].get("h1", {}).get("state")
              == "alive" and alive_view["epoch"] > evicted_view["epoch"],
              f"readmission did not re-alive h1 with an epoch bump: "
              f"{alive_view}")
        check(pod2.view()["epoch"] == alive_view["epoch"],
              "frontends did not converge after readmission")
        # the resurrected lane must actually serve again, bit-exact
        served_by_h1 = _counter_sum("spfft_cluster_routed_total",
                                    host="h1")
        served(pod, counts["readmit"], "post-readmission")
        check(_counter_sum("spfft_cluster_routed_total",
                           host="h1") > served_by_h1,
              "readmitted h1 received no routes")
        check(tracer.open_count() == 0,
              "unclosed client spans after the self-healing phase")

        # -- drain-leave: the other half of elasticity -----------------
        left = pod.leave("h2")
        check(left["drained"], f"leave did not drain h2: {left}")
        for event in ("leave_started", "drained", "left"):
            check(counted("spfft_cluster_membership_total",
                          event=event) >= 1,
                  f"membership ladder missing the {event!r} event")

        # polite shutdown for the survivors that still listen
        for host in ("h0", "h1", "h2"):
            try:
                lanes[host].rpc_shutdown()
            except Exception:  # noqa: BLE001 - a dead host is fine here
                pass
    except Exception:  # noqa: BLE001 - reported as a failure
        failures.append(traceback.format_exc())
    finally:
        if pod2 is not None:
            pod2.close()
        if pod is not None:
            pod.close()
        for lane in lanes.values():
            try:
                lane.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass
        for proc in procs.values():
            try:
                proc.kill()
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 - teardown best effort
                pass
        cfg.set("lane_probe_backoff", old_backoff, source="smoke",
                reason="restore after pod-smoke")
        _obs.disable()
        if failures:
            failures.append(f"agents' log ends:\n{_tail(log)}")
        tmp.cleanup()
    numbers["spans_crossed"] = crossed
    return failures, numbers


def main(argv=None) -> int:
    import argparse

    from ..errors import DeviceError

    ap = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.net.smoke",
        description="Multi-process pod smoke over localhost TCP.")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the oracle's device, passed through to the "
                         "agents (default: the card, agent i on card i "
                         "mod the count; 'cpu' runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    try:
        failures, numbers = run_pod_smoke(args.seed, args.device)
    except DeviceError as exc:
        print(f"pod-smoke: {type(exc).__name__}: {exc}")
        return 1
    for msg in failures:
        print(f"pod-smoke FAIL: {msg}")
    if failures:
        return 1
    print(f"pod-smoke: bit-exact across a real TCP pod on "
          f"{numbers['device']} (2 processes + 1 mid-stream join, "
          f"builds=0 on the joiner, a concurrent distributed pair "
          f"COALESCED into one round agent-side, kill -9 failover typed, "
          f"then SELF-HEALED: lease expired -> evicted with an epoch "
          f"bump seen by two frontends -> restarted warm off the blob "
          f"tier -> probe ladder readmitted, "
          f"{numbers['spans_crossed']} spans crossed the process "
          f"boundary on one trace id each)")
    print(json.dumps({"pod_smoke": numbers}))
    print("POD SMOKE GREEN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
