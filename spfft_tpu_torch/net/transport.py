"""The client side of the pod's wire: :class:`TcpTransport` +
:class:`TcpHostLane` (the port of ``spfft_tpu/net/transport.py``).

``serve.cluster.HostLane`` is the five-RPC host boundary against an
in-process executor; :class:`TcpHostLane` is the same surface with the
executor on the far side of a socket — the frontend cannot tell them
apart (``PodFrontend`` routes, reconciles, federates and fails over
identically), which is the whole point of the seam.

RPCs ride POOLED keep-alive connections: a completed round trip
returns its socket to a :class:`_SocketPool` and the next RPC reuses
it (the agent's connection loop already serves many frames per
connection), with an idle-timeout reaper closing sockets the traffic
no longer needs — ``pool=False`` gives one connect per RPC.
Connection/read failures, protocol violations and injected
``cluster.rpc``/``net.*`` faults all translate into the typed,
transient ``HostLaneError`` the frontend's route-around handling keys
on (a stale pooled socket is NOT a failure: checkout probes liveness
and a send that trips over a just-closed keep-alive falls back to a
fresh connect, so a dead host still surfaces synchronously at
``start_call`` where the frontend fails over); a typed ``error``
record in the response re-raises as its original taxonomy class (a
remote ``QueueFullError`` stays backpressure, not lane death).

The transport measures each successful round trip into an EWMA
(:attr:`TcpTransport.rtt`, exported as
``spfft_net_rpc_rtt_seconds{host}``) and :meth:`TcpHostLane.rpc_signals`
merges it into the host's signal snapshot as ``wire_rtt`` — the third
term of ``serve.cluster.load_score``, so a far-away host really does
score busier than a near one at equal queue depth.

A remote lane's results are what came off the wire, as CPU tensors
(:func:`~spfft_tpu_torch.net.frame.unpack_tensors`): the frontend need
not hold the card. A loopback lane's are its executor's tensors on the
card; the bits are the same.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

from .. import obs as _obs
from ..control.config import global_config
from ..errors import HostLaneError, NetProtocolError
from ..faults import InjectedFault
from ..serve.cluster import HostLane, LoopbackTransport
from ..serve.registry import PlanSignature
from ..types import Scaling
from .frame import (error_from_wire, pack_values, recv_frame,
                    send_frame, signature_from_wire, signature_to_wire,
                    unpack_tensors)

#: EWMA weight of the newest round-trip sample.
_RTT_ALPHA = 0.2


def _ctx_to_wire(ctx) -> Optional[dict]:
    """Trace context → frame-header form (None stays None)."""
    return None if ctx is None else ctx.to_wire()


class _SocketPool:
    """Idle keep-alive sockets for one transport's (host, address).

    ``checkout`` hands back a pooled socket after a liveness probe
    (non-blocking ``MSG_PEEK``: a server-closed keep-alive reads EOF
    and is discarded; unexpected buffered bytes mean a desynced stream
    and are discarded too) or ``None`` on a miss; ``checkin`` returns
    a socket whose RPC completed cleanly. A lazy daemon reaper closes
    sockets idle past ``idle_timeout`` seconds, so a traffic lull does
    not pin file descriptors on either side of the wire. The client
    idle timeout sits well under the agent's per-connection read
    timeout (``net_rpc_timeout_ms``, 30 s default), so the client
    side, not the server, retires idle connections."""

    def __init__(self, idle_timeout: float = 5.0, max_idle: int = 8):
        self.idle_timeout = float(idle_timeout)
        self.max_idle = int(max_idle)
        self._lock = threading.Lock()
        self._idle: List[Tuple[socket.socket, float]] = []  #: guarded by _lock
        self._closed = False  #: guarded by _lock
        self._reaper: Optional[threading.Thread] = None  #: guarded by _lock
        self.hits = 0  #: guarded by _lock
        self.misses = 0  #: guarded by _lock
        self.reaped = 0  #: guarded by _lock

    @staticmethod
    def _alive(sock) -> bool:
        try:
            sock.setblocking(False)
            try:
                chunk = sock.recv(1, socket.MSG_PEEK)
            finally:
                sock.setblocking(True)
        except (BlockingIOError, InterruptedError):
            return True  # nothing buffered: healthy idle keep-alive
        except OSError:
            return False
        # EOF (b"") = server closed; actual bytes = desynced stream —
        # either way the socket is not reusable
        del chunk
        return False

    def checkout(self):
        with self._lock:
            while self._idle:
                sock, _ = self._idle.pop()
                if self._alive(sock):
                    self.hits += 1
                    return sock
                try:
                    sock.close()
                except OSError:
                    pass
            self.misses += 1
            return None

    def checkin(self, sock) -> None:
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append((sock, time.monotonic()))
                self._ensure_reaper_locked()
                return
        try:
            sock.close()
        except OSError:
            pass

    # lock: holds(_lock)
    def _ensure_reaper_locked(self) -> None:
        if self._reaper is None or not self._reaper.is_alive():
            self._reaper = threading.Thread(
                target=self._reap_loop, daemon=True,
                name="spfft-net-pool-reaper")
            self._reaper.start()

    def _reap_loop(self) -> None:
        while True:
            time.sleep(max(self.idle_timeout / 4.0, 0.05))
            now = time.monotonic()
            stale: List[socket.socket] = []
            with self._lock:
                keep = []
                for sock, stamp in self._idle:
                    if now - stamp > self.idle_timeout:
                        stale.append(sock)
                    else:
                        keep.append((sock, stamp))
                self._idle = keep
                self.reaped += len(stale)
                done = self._closed or not self._idle
                if done:
                    self._reaper = None
            for sock in stale:
                try:
                    sock.close()
                except OSError:
                    pass
            if done:
                return

    def stats(self) -> dict:
        with self._lock:
            return {"idle": len(self._idle), "hits": self.hits,
                    "misses": self.misses, "reaped": self.reaped}

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
            self._closed = True
        for sock, _ in idle:
            try:
                sock.close()
            except OSError:
                pass


class TcpTransport(LoopbackTransport):
    """The wire twin of ``LoopbackTransport``: same ``check`` seam
    (liveness + the ``cluster.rpc`` fault site), plus :meth:`call` —
    one framed request/response round trip with its latency folded
    into :attr:`rtt`. Timeouts resolve through the control plane's
    ``net_connect_timeout_ms`` / ``net_rpc_timeout_ms`` knobs unless
    given explicitly (seconds)."""

    def __init__(self, host: str, address: Tuple[str, int],
                 connect_timeout: Optional[float] = None,
                 rpc_timeout: Optional[float] = None,
                 pool: bool = True,
                 pool_idle_timeout: float = 5.0):
        super().__init__(host)
        self.address = (str(address[0]), int(address[1]))
        cfg = global_config()
        self._connect_timeout = (
            float(connect_timeout) if connect_timeout is not None
            else cfg.net_connect_timeout_ms / 1000.0)
        self._rpc_timeout = (
            float(rpc_timeout) if rpc_timeout is not None
            else cfg.net_rpc_timeout_ms / 1000.0)
        self._rtt_lock = threading.Lock()
        self._rtt = 0.0  #: guarded by _rtt_lock
        self._pool = _SocketPool(pool_idle_timeout) if pool else None

    @property
    def rtt(self) -> float:
        """EWMA of successful RPC round trips (seconds); 0.0 until the
        first completes."""
        with self._rtt_lock:
            return self._rtt

    def _fail(self, op: str, exc: BaseException) -> HostLaneError:
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_rpc_failures_total",
                                 host=self.host, op=op)
        return HostLaneError(
            f"host lane {self.host!r} wire RPC {op!r} to "
            f"{self.address} failed: {exc}", host=self.host)

    def start_call(self, header: dict, payload: bytes = b"",
                   timeout: Optional[float] = None):
        """The SYNCHRONOUS half of an RPC: connect and send the request
        frame, returning ``(sock, op, t0)`` for :meth:`finish_call`.
        Kept separate so a submit surfaces a dead host HERE — at
        routing time, where the frontend can fail over — not later in
        a background future. Connect/send failures raise the transient
        :class:`HostLaneError`."""
        op = str(header.get("type", "?"))
        t0 = time.monotonic()
        read_timeout = timeout if timeout is not None \
            else self._rpc_timeout
        if self._pool is not None:
            sock = self._pool.checkout()
            if sock is not None:
                try:
                    sock.settimeout(read_timeout)
                    send_frame(sock, header, payload)
                    return sock, op, t0
                except OSError:
                    # the keep-alive went stale between checkout and
                    # send (server FIN in flight): fall back to a
                    # fresh connect — a genuinely dead host fails THAT
                    sock.close()
                except (NetProtocolError, InjectedFault) as exc:
                    sock.close()
                    raise self._fail(op, exc) from exc
        try:
            sock = self._connect_with_retry(op)
        except (OSError, InjectedFault) as exc:
            raise self._fail(op, exc) from exc
        try:
            sock.settimeout(read_timeout)
            send_frame(sock, header, payload)
        except (OSError, NetProtocolError, InjectedFault) as exc:
            sock.close()
            raise self._fail(op, exc) from exc
        return sock, op, t0

    #: Fresh-connect attempts before the lane is declared dead, and
    #: the base backoff between them (exponential + jitter). One
    #: refused connect from an agent mid-restart must not kill the
    #: lane; a truly dead-but-reachable host still exhausts the budget
    #: in well under a second on ECONNREFUSED. Only refused/reset-class
    #: errors retry — a connect TIMEOUT (unreachable host, blackholed
    #: route) fails fast so failover starts after ONE connect timeout,
    #: not three.
    CONNECT_ATTEMPTS = 3
    CONNECT_BACKOFF_S = 0.05
    _RETRYABLE_CONNECT_ERRORS = (ConnectionRefusedError,
                                 ConnectionResetError,
                                 ConnectionAbortedError)

    def _connect_with_retry(self, op: str):
        last = None
        for attempt in range(self.CONNECT_ATTEMPTS):
            if attempt:
                delay = self.CONNECT_BACKOFF_S * (2 ** (attempt - 1))
                time.sleep(delay * (1.0 + random.random() * 0.25))
                _obs.GLOBAL_COUNTERS.inc(
                    "spfft_net_rpc_retries_total", verb=op)
            try:
                return socket.create_connection(
                    self.address, timeout=self._connect_timeout)
            except self._RETRYABLE_CONNECT_ERRORS as exc:
                last = exc
        raise last

    def finish_call(self, sock, op: str,
                    t0: float) -> Tuple[dict, bytes]:
        """The (possibly deferred) second half: read the response
        frame, fold the measured round trip into :attr:`rtt`, and
        re-raise a typed ``error`` record as its original taxonomy
        class. A cleanly completed round trip returns its socket to
        the keep-alive pool (the stream stays framed even after a
        typed error reply — the agent's connection loop keeps
        serving); any read failure closes it."""
        try:
            reply, rpayload = recv_frame(sock)
        except (OSError, NetProtocolError, InjectedFault) as exc:
            sock.close()
            raise self._fail(op, exc) from exc
        if self._pool is not None:
            self._pool.checkin(sock)
        else:
            sock.close()
        dt = time.monotonic() - t0
        with self._rtt_lock:
            self._rtt = dt if self._rtt <= 0.0 \
                else (1.0 - _RTT_ALPHA) * self._rtt + _RTT_ALPHA * dt
            rtt = self._rtt
        _obs.GLOBAL_COUNTERS.set("spfft_net_rpc_rtt_seconds", rtt,
                                 host=self.host)
        if reply.get("type") == "error":
            raise error_from_wire(reply)
        return reply, rpayload

    def call(self, header: dict, payload: bytes = b"",
             timeout: Optional[float] = None) -> Tuple[dict, bytes]:
        """One full request/response round trip (both halves,
        blocking)."""
        sock, op, t0 = self.start_call(header, payload, timeout)
        return self.finish_call(sock, op, t0)

    def pool_stats(self) -> Optional[dict]:
        """Keep-alive pool counters (idle/hits/misses/reaped); None on
        an unpooled transport."""
        return None if self._pool is None else self._pool.stats()

    def close(self) -> None:
        """Close any idle keep-alive sockets (in-flight RPCs keep
        theirs until finish_call)."""
        if self._pool is not None:
            self._pool.close()


class TcpHostLane(HostLane):
    """A ``HostLane`` whose executor lives in another process behind a
    :class:`HostAgent`. ``executor`` is None — every ``rpc_*`` crosses
    the wire; a small thread pool makes :meth:`rpc_submit` return a
    ``Future`` immediately (the frontend's submit path stays
    non-blocking) while the round trip completes in the background."""

    def __init__(self, host: str, address: Tuple[str, int],
                 connect_timeout: Optional[float] = None,
                 rpc_timeout: Optional[float] = None,
                 max_inflight: int = 8, pool: bool = True):
        self.host = host
        self.executor = None
        self.draining = False
        self.transport = TcpTransport(host, address,
                                      connect_timeout=connect_timeout,
                                      rpc_timeout=rpc_timeout,
                                      pool=pool)
        self._pool = ThreadPoolExecutor(
            max_workers=max_inflight,
            thread_name_prefix=f"spfft-net-{host}")

    # trace: boundary(ctx)
    def rpc_submit(self, signature: PlanSignature, values,
                   kind: str = "backward",
                   scaling: Scaling = Scaling.NONE,
                   timeout: Optional[float] = None,
                   priority: str = "normal", ctx=None,
                   epoch: Optional[int] = None) -> Future:
        """Submit one request over the wire. The propagated trace
        context rides the frame header, so the agent's ``serve.request``
        root carries the frontend's trace id — one id end-to-end across
        the process boundary. ``epoch`` stamps the frontend's view
        epoch for membership fencing (the agent rejects stale stamps
        typed as ``StaleEpochError``). Connect + send run synchronously
        (a ``kill -9``'d host raises ``HostLaneError`` HERE, where the
        frontend fails over); only the response read is deferred to the
        lane's pool."""
        self.transport.check("submit")
        meta, payload = pack_values(values)
        header = {"type": "submit",
                  "signature": signature_to_wire(signature),
                  "kind": kind, "scaling": Scaling(scaling).value,
                  "timeout": timeout, "priority": priority,
                  "ctx": _ctx_to_wire(ctx), "epoch": epoch,
                  **meta}
        wire_timeout = None if timeout is None \
            else timeout + self.transport._rpc_timeout
        sock, op, t0 = self.transport.start_call(header, payload,
                                                 timeout=wire_timeout)
        return self._pool.submit(self._wire_finish, sock, op, t0)

    def _wire_finish(self, sock, op, t0):
        reply, rpayload = self.transport.finish_call(sock, op, t0)
        return unpack_tensors(reply, rpayload)

    def rpc_signals(self) -> dict:
        self.transport.check("signals")
        reply, _ = self.transport.call({"type": "signals"})
        signals = dict(reply.get("signals") or {})
        # the wire's contribution to load_score: a far host at equal
        # queue depth really is the slower choice
        signals["wire_rtt"] = self.transport.rtt
        return signals

    def rpc_signatures(self) -> List[PlanSignature]:
        self.transport.check("signatures")
        reply, _ = self.transport.call({"type": "signatures"})
        return [signature_from_wire(d)
                for d in reply.get("signatures", [])]

    def rpc_plan(self, signature: PlanSignature):
        """A remote PLAN DESCRIPTOR (the plan object itself never
        crosses the wire): ``{"remote": True, "distributed": bool,
        "fingerprint": hex|None}``, or None when unheld. The frontend
        routes and reconciles from the descriptor."""
        self.transport.check("plan")
        reply, _ = self.transport.call(
            {"type": "plan", "signature": signature_to_wire(signature)})
        if not reply.get("held"):
            return None
        return {"remote": True,
                "distributed": bool(reply.get("distributed")),
                "fingerprint": reply.get("fingerprint")}

    def rpc_metrics_text(self) -> str:
        self.transport.check("metrics")
        reply, _ = self.transport.call({"type": "metrics"})
        return str(reply.get("text", ""))

    def rpc_health(self) -> dict:
        self.transport.check("health")
        reply, _ = self.transport.call({"type": "health"})
        return dict(reply.get("health") or {})

    def rpc_prewarm(self, signatures, strict: bool = True) -> int:
        self.transport.check("prewarm")
        reply, _ = self.transport.call(
            {"type": "prewarm",
             "signatures": [signature_to_wire(s) for s in signatures],
             "strict": bool(strict)})
        return int(reply.get("warmed", 0))

    def rpc_drain(self) -> None:
        self.transport.check("drain")
        self.transport.call({"type": "drain"})

    def rpc_shutdown(self) -> None:
        self.transport.check("shutdown")
        self.transport.call({"type": "shutdown"})

    def rpc_stats(self) -> dict:
        """The remote registry's ``stats()`` — the warm-boot observable
        (``builds == 0`` after a remote-tier prewarm)."""
        self.transport.check("stats")
        reply, _ = self.transport.call({"type": "stats"})
        return dict(reply.get("registry") or {})

    def rpc_spans(self) -> dict:
        """The agent's completed-span summaries + open count — how a
        smoke asserts one trace id crossed the process boundary and
        nothing leaked."""
        self.transport.check("spans")
        reply, _ = self.transport.call({"type": "spans"})
        return {"spans": list(reply.get("spans", [])),
                "open": int(reply.get("open", 0))}

    def rpc_incident(self, reason: str) -> dict:
        """The agent process's in-memory incident bundle — the remote
        half of a pod-wide flight-recorder capture."""
        self.transport.check("incident")
        reply, _ = self.transport.call(
            {"type": "incident", "reason": str(reason)})
        return dict(reply.get("bundle") or {})

    def rpc_heartbeat(self, host: str,
                      address: Optional[str] = None) -> dict:
        """Renew ``host``'s membership lease with this lane's agent
        (redirect acks name the real coordinator)."""
        self.transport.check("heartbeat")
        reply, _ = self.transport.call(
            {"type": "heartbeat", "host": host, "address": address})
        return {k: v for k, v in reply.items() if k != "type"}

    # trace: boundary(ctx)
    def rpc_view(self, ctx=None) -> dict:
        """Fetch the agent's signed membership view (wire form). The
        propagated trace context rides the header so a view refetch
        inside a stale-epoch retry stays on the request's trace."""
        self.transport.check("view")
        reply, _ = self.transport.call(
            {"type": "view", "ctx": _ctx_to_wire(ctx)})
        return dict(reply.get("view") or {})

    def close(self) -> None:
        """Release the lane's client thread pool and any idle
        keep-alive sockets (the remote agent is NOT shut down — lanes
        don't own hosts)."""
        self._pool.shutdown(wait=True)
        self.transport.close()


def wire_overhead_probe(repeats: int = 24, n: int = 8,
                        device=None) -> dict:
    """Measure what the wire costs: median ``rpc_submit`` round trip of
    a tiny C2C backward (double precision, on ``device``: None is the
    card) through a loopback lane vs through an in-process TCP agent
    fronting the SAME executor — once over a connect-per-RPC wire and
    once over the pooled keep-alive wire. Returns microsecond medians
    plus the deltas. All paths are warmed (the kernels' first launches
    and the connection machinery) before timing so the medians compare
    steady-state transports."""
    import statistics

    import numpy as np

    from ..benchmark import cutoff_stick_triplets
    from ..serve.executor import ServeExecutor
    from ..serve.registry import PlanRegistry
    from ..types import TransformType
    from .agent import HostAgent

    trip = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    reg = PlanRegistry(store=False)
    sig, _plan = reg.get_or_build(TransformType.C2C, n, n, n, trip,
                                  precision="double", device=device)
    executor = ServeExecutor(reg)
    rng = np.random.default_rng(7)
    v = rng.standard_normal(len(trip)) \
        + 1j * rng.standard_normal(len(trip))

    def timed(lane) -> float:
        for _ in range(3):  # warm the kernels + transport path
            lane.rpc_submit(sig, v, ctx=None).result(timeout=120)
        samples = []
        for _ in range(repeats):
            t0 = time.monotonic()
            lane.rpc_submit(sig, v, ctx=None).result(timeout=120)
            samples.append(time.monotonic() - t0)
        return statistics.median(samples)

    agent = None
    tcp_lane = None
    pooled_lane = None
    try:
        loop_lane = HostLane("probe-loop", executor)
        loop_s = timed(loop_lane)
        agent = HostAgent("probe-tcp", executor)
        agent.start()
        tcp_lane = TcpHostLane("probe-tcp",
                               ("127.0.0.1", agent.port), pool=False)
        tcp_s = timed(tcp_lane)
        pooled_lane = TcpHostLane("probe-tcp-pooled",
                                  ("127.0.0.1", agent.port), pool=True)
        pooled_s = timed(pooled_lane)
        pool_stats = pooled_lane.transport.pool_stats() or {}
    finally:
        if tcp_lane is not None:
            tcp_lane.close()
        if pooled_lane is not None:
            pooled_lane.close()
        if agent is not None:
            agent.close()
        executor.close(drain=False)
    return {
        "repeats": int(repeats),
        "loopback_us": loop_s * 1e6,
        "tcp_us": tcp_s * 1e6,
        "tcp_pooled_us": pooled_s * 1e6,
        "overhead_us": max(0.0, (tcp_s - loop_s) * 1e6),
        "overhead_pooled_us": max(0.0, (pooled_s - loop_s) * 1e6),
        "pool_hits": int(pool_stats.get("hits", 0)),
        "pool_misses": int(pool_stats.get("misses", 0)),
    }
