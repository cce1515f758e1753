"""The server side of the pod's wire: :class:`HostAgent` (the port of
``spfft_tpu/net/agent.py``).

``python -m spfft_tpu_torch.net.agent --host h0`` turns one process into one
pod host: a local ``ServeExecutor`` (own registry, own artifact store,
optionally the fleet's remote blob tier) fronted by a framed-TCP
accept loop speaking the :mod:`~spfft_tpu_torch.net.frame` protocol. The
dispatch table is the ``HostLane`` seam verbatim — submit / signals /
signatures / plan / metrics / health — plus the membership and
introspection verbs the elastic pod needs (prewarm, drain, shutdown,
stats, spans).

Three contracts the agent keeps:

* **One trace id end-to-end** — a submit frame carries the frontend's
  ``TraceContext``; the agent restores it, so the local
  ``serve.request`` (or ``cluster.spmd_execute``) span is a child of
  the remote ``cluster.request`` root across the process boundary.
* **Typed errors only** — a handler that raises answers with an
  ``error`` record; :func:`~spfft_tpu_torch.net.frame.error_from_wire` maps
  it back onto the taxonomy client-side (a remote ``QueueFullError``
  stays backpressure, never lane death).
* **Plans never cross the wire** — ``plan`` answers a descriptor
  (held / distributed / fingerprint); execution happens here, next to
  the devices that compiled the plan.

``net.accept`` is the agent's fault site: a firing check drops the
inbound connection on the floor — the client sees exactly a crashed
host.

The agent is also one membership node (:mod:`~spfft_tpu_torch.net.membership`):
it holds a lease it renews over the ``heartbeat`` verb, serves the
signed pod view over ``view``, promotes itself to view coordinator
when it is the lowest alive host id, and fences stale-epoch submits
with the typed transient ``StaleEpochError`` (counted
``spfft_net_agent_rejected_total{reason="stale_epoch"}``). Frames
that fail wire authentication reject permanent ``NetAuthError`` at
the door, counted ``{reason="auth"}``.

A submit frame that names a distributed signature tells the agent's
coalescer it is coming as soon as its header is in, before its payload
(:meth:`~spfft_tpu_torch.serve.cluster.SPMDCoalescer.expect`): a round
of that signature waits for it, for at most the coalescer's
``RECEIVE_HOLD_S``. A 256^3 request's payload takes longer to receive
and decode than the largest coalescing window, so without this two
concurrent requests would share a round only by chance. The JAX agent
has no such hint.

The agent holds the card: its plans are built on ``--device`` (default
``cuda:0``; ``--device cpu`` runs the kernels' plain versions, for the
tests). Without a card and without ``--device cpu`` it exits non-zero
with the :class:`~spfft_tpu_torch.errors.DeviceError` message and never
carries on on the host. A submit's values arrive as CPU tensors
(:func:`~spfft_tpu_torch.net.frame.unpack_tensors`) and the plans move
them to their device; results leave through an explicit ``.cpu()``.
Several agents may share one card, each with its own CUDA context; the
kernels build once into ``build/torch_kernels/`` and every process loads
the same libraries.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Dict, List, Optional, Tuple

from .. import faults as _faults
from .. import obs as _obs
from ..control.config import global_config
from ..errors import (DeadlineExpiredError, InvalidParameterError,
                      NetAuthError, NetProtocolError, QueueFullError,
                      StaleEpochError)
from ..faults import InjectedFault
from ..obs.exporters import prometheus_text
from ..parallel.multihost import plan_fingerprint
from ..plan import TransformPlan
from ..serve.executor import ServeExecutor
from ..types import Scaling
from .frame import (error_to_wire, pack_values, recv_frame, send_frame,
                    signature_from_wire, signature_to_wire,
                    unpack_tensors)
from .membership import HeartbeatLoop, MembershipNode


def _jsonify(obj):
    """Make a telemetry snapshot JSON-clean: stringify non-str dict
    keys (the fused-batch histogram is int-keyed) and coerce numpy
    scalars through their Python item()."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            return str(obj)
    return obj


class HostAgent:
    """One pod host: a TCP accept loop dispatching framed requests
    onto a local :class:`ServeExecutor`. ``port=0`` binds an ephemeral
    port (read it back from :attr:`port` — how the smoke wires a pod
    of subprocesses together)."""

    def __init__(self, host: str, executor: ServeExecutor,
                 bind: str = "127.0.0.1", port: int = 0,
                 peers: Optional[Dict[str, str]] = None,
                 advertise: Optional[str] = None):
        self.host = host
        self.executor = executor
        self.closing = threading.Event()
        self._lock = threading.Lock()
        self._inflight = 0  #: guarded by _lock
        self._conns: set = set()  #: guarded by _lock
        # this host's half of the pod SPMD lane: the same coalescing
        # scheduler the in-process frontend runs, so same-signature
        # distributed requests arriving over the wire share collective
        # rounds too (serve.cluster has no net imports — no cycle)
        from ..serve.cluster import SPMDCoalescer
        self._spmd = SPMDCoalescer(span_args={"host": host})
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind, port))
        self._sock.listen(64)
        # short accept timeout: the loop notices `closing` promptly
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        # this host's membership half: lease + heartbeat + (when this
        # is the lowest alive host id) the view-coordinator role
        self.membership = MembershipNode(
            host, address=advertise or f"{bind}:{self.port}",
            peers=peers)
        self._heartbeats = HeartbeatLoop(self.membership)
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HostAgent":
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"spfft-agent-{self.host}")
        self._thread.start()
        self._heartbeats.start()
        return self

    def close(self) -> None:
        self.closing.set()
        self._heartbeats.stop()
        try:
            self._sock.close()
        except OSError:
            pass
        # sever live keep-alive connections too: a closed host must
        # look DOWN to pooled clients (EOF on their idle sockets), not
        # keep answering frames from still-parked handler threads
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._spmd.close()

    # -- the accept loop ---------------------------------------------------
    def _accept_loop(self) -> None:
        while not self.closing.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                if self.closing.is_set():
                    return
                continue
            try:
                _faults.check_site("net.accept")
            except InjectedFault:
                # a dropped inbound connection: the client observes a
                # crashed host (EOF), which is the point of the site
                conn.close()
                continue
            threading.Thread(
                target=self._handle_conn, args=(conn,), daemon=True,
                name=f"spfft-agent-{self.host}-conn").start()

    def _handle_conn(self, conn) -> None:
        cfg = global_config()
        conn.settimeout(cfg.net_rpc_timeout_ms / 1000.0)
        with self._lock:
            self._conns.add(conn)
        try:
            while not self.closing.is_set():
                # the coalescer keys this frame announced (_expect) and
                # its submit did not take back
                expected: List[tuple] = []
                try:
                    if not self._serve_frame(conn, expected):
                        return
                finally:
                    for key in expected:
                        self._spmd.release(key)
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    def _serve_frame(self, conn, expected: List[tuple]) -> bool:
        """Receive, dispatch and answer one frame; False ends the
        connection."""
        try:
            frame = recv_frame(
                conn, eof_ok=True,
                on_header=lambda h: self._expect(h, expected))
        except NetAuthError as exc:
            # the authentication door: a frame that does not verify
            # rejects typed + permanent, counted, and the stream is
            # dropped (never dispatched)
            _obs.GLOBAL_COUNTERS.inc(
                "spfft_net_agent_rejected_total", reason="auth")
            try:
                send_frame(conn, error_to_wire(exc))
            except (OSError, NetProtocolError, NetAuthError,
                    InjectedFault):
                pass
            return False
        except (NetProtocolError, InjectedFault) as exc:
            # best effort: tell the client what went wrong, then give
            # up on this (possibly desynced) stream
            try:
                send_frame(conn, error_to_wire(exc))
            except (OSError, NetProtocolError, InjectedFault):
                pass
            return False
        except OSError:
            return False
        if frame is None:
            return False
        header, payload = frame
        op = str(header.get("type", "?"))
        _obs.GLOBAL_COUNTERS.inc("spfft_net_agent_requests_total", op=op)
        try:
            reply, rpayload = self._dispatch(op, header, payload,
                                             expected)
        except Exception as exc:
            reply, rpayload = error_to_wire(exc), b""
        try:
            send_frame(conn, reply, rpayload)
        except (OSError, NetProtocolError, InjectedFault):
            return False
        return True

    def _expect(self, header: dict, expected: List[tuple]) -> None:
        """A submit frame's header is in and its payload still on the
        wire: a distributed request tells the coalescer it is coming,
        so a round of its key waits for it
        (:meth:`~spfft_tpu_torch.serve.cluster.SPMDCoalescer.expect`).
        The header is not authenticated yet; it only holds a window,
        for a bounded time."""
        if header.get("type") != "submit":
            return
        try:
            sig = signature_from_wire(header.get("signature") or {})
            key = self._spmd.key(sig, str(header.get("kind", "backward")),
                                 header.get("scaling",
                                            Scaling.NONE.value))
        except Exception:  # noqa: BLE001 - the frame fails later, typed
            return
        if sig.device_count > 1:
            self._spmd.expect(key)
            expected.append(key)

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, op: str, header: dict, payload: bytes,
                  expected: List[tuple] = ()) -> Tuple[dict, bytes]:
        if op == "submit":
            ctx = _obs.TraceContext.from_wire(header.get("ctx"))
            return self._handle_submit(header, payload, ctx, expected)
        if op == "signals":
            return ({"type": "signals_ok",
                     "signals": _jsonify(
                         self.executor.metrics.signals())}, b"")
        if op == "signatures":
            return ({"type": "signatures_ok",
                     "signatures": [
                         signature_to_wire(s) for s in
                         self.executor.registry.signatures()]}, b"")
        if op == "plan":
            sig = signature_from_wire(header.get("signature") or {})
            plan = self.executor.registry.get(sig)
            if plan is None:
                return {"type": "plan_ok", "held": False}, b""
            distributed = not isinstance(plan, TransformPlan)
            return ({"type": "plan_ok", "held": True,
                     "distributed": distributed,
                     "fingerprint":
                         plan_fingerprint(plan.dist_plan).hex()
                         if distributed else None}, b"")
        if op == "metrics":
            return ({"type": "metrics_ok",
                     "text": prometheus_text(
                         metrics=self.executor.metrics,
                         registry=self.executor.registry)}, b"")
        if op == "health":
            return ({"type": "health_ok",
                     "health": _jsonify(self.executor.health())}, b"")
        if op == "prewarm":
            sigs = [signature_from_wire(d)
                    for d in header.get("signatures", [])]
            warmed = self.executor.registry.prewarm_signatures(
                sigs, strict=bool(header.get("strict", True)))
            return ({"type": "prewarm_ok", "warmed": warmed}, b"")
        if op == "stats":
            return ({"type": "stats_ok",
                     "registry": _jsonify(
                         self.executor.registry.stats())}, b"")
        if op == "spans":
            return self._handle_spans()
        if op == "incident":
            from ..obs.recorder import build_incident_bundle
            return ({"type": "incident_ok",
                     "bundle": _jsonify(build_incident_bundle(
                         str(header.get("reason", "remote")),
                         host=self.host))}, b"")
        if op == "drain":
            self.executor.close(drain=True)
            return {"type": "drain_ok"}, b""
        if op == "shutdown":
            self.closing.set()
            return {"type": "shutdown_ok"}, b""
        if op == "ping":
            return {"type": "pong", "host": self.host}, b""
        if op == "heartbeat":
            ack = self.membership.on_heartbeat(
                str(header.get("host", "?")), header.get("address"))
            return ({"type": "heartbeat_ok", **ack}, b"")
        if op == "view":
            return ({"type": "view_ok",
                     "view": self.membership.on_view()}, b"")
        raise InvalidParameterError(f"unknown wire op {op!r}")

    def _admit(self, timeout) -> None:
        """The agent's own admission seam (mirroring the SPMD lane's):
        a submit whose deadline is already spent rejects typed without
        touching a device, and the count of submits in flight across
        ALL connections is bounded by the ``max_queue`` knob — a
        storming client cannot queue this host to death behind its
        accept loop. Raising here answers the frame with the same
        typed error record any handler failure does."""
        if timeout is not None and float(timeout) <= 0:
            _obs.GLOBAL_COUNTERS.inc("spfft_net_agent_rejected_total",
                                     reason="expired")
            raise DeadlineExpiredError(
                f"request deadline already expired at host "
                f"{self.host!r} admission")
        cap = int(global_config().max_queue)
        with self._lock:
            if self._inflight >= cap:
                _obs.GLOBAL_COUNTERS.inc(
                    "spfft_net_agent_rejected_total",
                    reason="queue_full")
                raise QueueFullError(
                    f"host {self.host!r} agent is at capacity ({cap} "
                    f"submits in flight)")
            self._inflight += 1

    # trace: boundary(ctx)
    def _handle_submit(self, header: dict, payload: bytes, ctx,
                       expected: List[tuple] = ()) -> Tuple[dict, bytes]:
        """Execute one submit frame to completion (the reply IS the
        result — the asynchrony lives client-side in the lane's thread
        pool), restoring the propagated trace context so this host's
        spans join the frontend's trace. A coalescer key in
        ``expected`` is taken back by the enqueue."""
        try:
            self.membership.check_epoch(header.get("epoch"))
        except StaleEpochError:
            _obs.GLOBAL_COUNTERS.inc("spfft_net_agent_rejected_total",
                                     reason="stale_epoch")
            raise
        sig = signature_from_wire(header.get("signature") or {})
        values = unpack_tensors(header, payload)
        kind = str(header.get("kind", "backward"))
        scaling = Scaling(header.get("scaling", Scaling.NONE.value))
        timeout = header.get("timeout")
        priority = str(header.get("priority", "normal"))
        plan = self.executor.registry.get(sig)
        if plan is None:
            raise InvalidParameterError(
                f"signature not held by host {self.host!r} "
                f"(warm up first)")
        self._admit(timeout)
        try:
            if isinstance(plan, TransformPlan):
                fut = self.executor.submit(
                    sig, values, kind, scaling=scaling, timeout=timeout,
                    priority=priority, trace_ctx=ctx)
            else:
                # the coalescer batches same-signature arrivals from
                # every connection into one collective round
                key = self._spmd.key(sig, kind, scaling)
                hinted = key in expected
                if hinted:
                    expected.remove(key)
                fut = self._spmd.submit(sig, plan, values, kind,
                                        scaling, ctx, timeout=timeout,
                                        priority=priority,
                                        expected=hinted)
            result = fut.result()
        finally:
            with self._lock:
                self._inflight -= 1
        meta, rpayload = pack_values(result)
        return {"type": "result", **meta}, rpayload

    def _handle_spans(self) -> Tuple[dict, bytes]:
        tracer = _obs.GLOBAL_TRACER
        spans = [{"name": s.name, "trace_id": s.trace_id,
                  "span_id": s.span_id, "parent_id": s.parent_id,
                  "member_trace_ids":
                      (s.args or {}).get("member_trace_ids")}
                 for s in tracer.events() if isinstance(s, _obs.Span)]
        return ({"type": "spans_ok", "spans": spans,
                 "open": tracer.open_count()}, b"")


# ---------------------------------------------------------------------------
# CLI: one process = one pod host
# ---------------------------------------------------------------------------

def _demo_warm(registry, spec: str, device=None) -> None:
    """Warm the demo plan set the smokes serve on ``device``:
    ``N,CUTOFF,SHARDS`` + an optional mode and precision — ``full``
    (default) builds the single-device C2C plan AND the matching
    distributed plan; ``dist`` builds ONLY the distributed plan (the
    joining-host case: singles come warm from the artifact tiers, and
    the distributed plan — which is never serialized — is derived
    deterministically from the same triplet set, so its fingerprint
    reconciles against the incumbents). CUTOFF is the JAX package's
    stick cutoff (``cutoff_stick_triplets``' sparsity), or ``sphere``
    for the N^3 spherical cutoff in stick-major order (the card's served
    cell); PRECISION is ``double`` (default, the JAX demo's) or
    ``single``. Several sets are separated by ``;`` (``chip_smoke.py``'s
    pod serves its trace at 256^3 and its join / kill / heal steps at a
    smaller n)."""
    if ";" in spec:
        for one in filter(None, spec.split(";")):
            _demo_warm(registry, one, device)
        return
    from ..benchmark import cutoff_stick_triplets
    from ..parallel import make_distributed_plan, make_mesh
    from ..types import TransformType
    from ..utils.workloads import (even_plane_split,
                                   round_robin_stick_partition,
                                   spherical_cutoff_triplets_stick_major)
    from ..serve.registry import signature_for

    parts = spec.split(",")
    if len(parts) not in (3, 4, 5):
        raise InvalidParameterError(
            f"--demo-warm wants N,CUTOFF,SHARDS[,MODE[,PRECISION]], got "
            f"{spec!r}")
    n, shards = int(parts[0]), int(parts[2])
    mode = parts[3] if len(parts) >= 4 else "full"
    precision = parts[4] if len(parts) == 5 else "double"
    if mode not in ("full", "dist"):
        raise InvalidParameterError(
            f"--demo-warm mode must be full|dist, got {mode!r}")
    if precision not in ("single", "double"):
        raise InvalidParameterError(
            f"--demo-warm precision must be single|double, got "
            f"{precision!r}")
    dims = (n, n, n)
    if parts[1] == "sphere":
        trip = spherical_cutoff_triplets_stick_major(n)
    else:
        trip = cutoff_stick_triplets(n, n, n, float(parts[1]),
                                     hermitian=False)
    if mode == "full":
        registry.get_or_build(TransformType.C2C, *dims, trip,
                              precision=precision, device=device)
    if shards > 1:
        sparts = round_robin_stick_partition(trip, dims, shards)
        planes = even_plane_split(dims[2], shards)
        dplan = make_distributed_plan(TransformType.C2C, *dims, sparts,
                                      planes,
                                      mesh=make_mesh(shards, device),
                                      precision=precision)
        dsig = signature_for(TransformType.C2C, *dims, trip,
                             precision=precision, device_count=shards)
        registry.put(dsig, dplan)
    if registry.store is not None:
        # flush async spills (incl. remote blob puts) before the port
        # announcement: a joiner that boots next must find them
        registry.store.drain()


def main(argv=None) -> int:
    import argparse
    import sys

    from ..errors import DeviceError
    from ..plan import resolve_device
    from ..serve.registry import PlanRegistry
    from ..serve.store import PlanArtifactStore

    ap = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.net.agent",
        description="Run one pod host: a ServeExecutor behind a "
                    "framed-TCP HostAgent.")
    ap.add_argument("--host", required=True,
                    help="this lane's host name in the pod")
    ap.add_argument("--bind", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (announced on stdout)")
    ap.add_argument("--store", default="",
                    help="plan-artifact store root (disk tier)")
    ap.add_argument("--blob", default="",
                    help="remote blob tier: http:// URL or shared "
                         "directory")
    ap.add_argument("--manifest", default="",
                    help="warmup manifest to boot from")
    ap.add_argument("--demo-warm", default="",
                    help="N,CUTOFF,SHARDS[,MODE[,PRECISION]] demo plan "
                         "set (CUTOFF a stick sparsity or 'sphere', "
                         "MODE=full|dist, PRECISION=double|single); "
                         "several sets separated by ';'")
    ap.add_argument("--trace", action="store_true",
                    help="enable tracing at sample rate 1.0")
    ap.add_argument("--peers", default="",
                    help="pod roster for lease-based membership: "
                         "name=host:port,... (empty = standalone)")
    ap.add_argument("--advertise", default="",
                    help="address peers should heartbeat this agent "
                         "at (default: bind:port)")
    ap.add_argument("--device", default="cuda:0",
                    help="the device this host's plans run on (default "
                         "cuda:0; 'cpu' runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except DeviceError as exc:
        print(f"agent {args.host}: {type(exc).__name__}: {exc}",
              file=sys.stderr, flush=True)
        return 1
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(device)
    if args.blob:
        global_config().set_path("blob_store_url", args.blob)
    if args.trace:
        _obs.enable()
        _obs.GLOBAL_TRACER.set_sample_rate(1.0)

    store = False
    if args.store:
        # plans restored from the store go to this host's device
        store = PlanArtifactStore(args.store,
                                  plan_kwargs={"device": str(device)})
    registry = PlanRegistry(store=store)
    if args.manifest:
        registry.warmup_manifest(args.manifest, compile=True)
    if args.demo_warm:
        _demo_warm(registry, args.demo_warm, device)
    peers = {}
    for entry in filter(None, args.peers.split(",")):
        name, _, addr = entry.partition("=")
        if not name or ":" not in addr:
            ap.error(f"--peers entry {entry!r} is not name=host:port")
        peers[name.strip()] = addr.strip()
    executor = ServeExecutor(registry)
    agent = HostAgent(args.host, executor, bind=args.bind,
                      port=args.port, peers=peers or None,
                      advertise=(args.advertise or None)).start()
    print(json.dumps({"agent": args.host, "port": agent.port,
                      "device": str(device)}), flush=True)
    try:
        agent.closing.wait()
    except KeyboardInterrupt:
        pass
    finally:
        agent.close()
        try:
            executor.close(drain=False)
        except Exception:
            pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
