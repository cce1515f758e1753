"""Pod-scale multi-host serving: the :class:`PodFrontend` (the port of
``spfft_tpu/serve/cluster.py``).

The reference library's execution tier is multi-rank from the ground up
(slab/pencil decomposition over an MPI communicator); the single-host
serving layer covers exactly one process's devices —
``ServeExecutor.submit`` rejects ``DistributedTransformPlan`` at the
door. This module is the scale-out tier that turns per-host throughput
into pod throughput:

* **Host lanes** — each :class:`HostLane` wraps one per-host
  ``ServeExecutor`` behind a transport seam (:class:`LoopbackTransport`
  for the in-process pod; :mod:`~spfft_tpu_torch.net.transport` swaps
  in a framed-TCP transport with the same surface). Lanes are
  *reconciled* at frontend construction over the digest-validation
  path in ``parallel.multihost``: every host must hold the same
  ``PlanSignature`` set and, for distributed plans, the same 16-byte
  plan fingerprint — anything else is a typed
  ``ClusterReconciliationError`` (the serving-tier mirror of the
  reference's cross-rank parameter checks).
* **Routing by plan type** — single-device requests go to the
  least-loaded host via power-of-two-choices over live
  ``ServeMetrics.signals()`` (queue depth x device-execute p50,
  refreshed per dispatch); ``DistributedTransformPlan`` requests are
  handed to the pod-wide SPMD lane (:class:`SPMDCoalescer`), which
  coalesces same-signature requests into one batched execution of the
  plan (``coalesce_backward`` / ``coalesce_forward``: one launch of each
  kernel a round, where N serial calls take N) — so
  ``DistributedPlanUnsupportedError`` is not the frontend's answer (it
  remains the bare single-host executor's).
* **Federated telemetry** — trace contexts propagate across the host
  boundary (``obs.TraceContext``: the frontend's ``cluster.request``
  span is the parent, each host lane's ``serve.request`` root is its
  child, one trace id end-to-end), and :meth:`PodFrontend.metrics_text`
  merges every host's Prometheus exposition into one pod-level
  ``/metrics`` (each host's series re-labelled ``host="..."``), with
  :meth:`PodFrontend.health` as the worst-health-wins ``/healthz``.
* **Fault sites** — ``cluster.route`` (the host pick),
  ``cluster.rpc`` (every lane RPC), ``cluster.reconcile`` (the
  per-host digest collective), ``cluster.spmd_window`` (a coalesced
  round) and ``cluster.readmit`` (the resurrection re-reconcile), from
  ``spfft_tpu_torch.faults``; a lane whose transport fails is marked
  dead, the pod degrades, survivors keep serving and every issued
  future still resolves.
* **Self-healing membership** — the frontend stamps every routed
  request with the membership view epoch from
  :mod:`spfft_tpu_torch.net.membership` (a private ``ViewCoordinator``
  for loopback pods, the agents' lease-based coordinator for remote
  ones). Work stamped with an older epoch is rejected typed
  (``StaleEpochError``, transient): the frontend refetches the view and
  retries. A dead lane enters a backoff-probed resurrection ladder
  (``rpc_health`` probes under exponential backoff + jitter), is
  RE-RECONCILED against an incumbent (a resurrected host serving stale
  plans is blocked, not readmitted) and only then readmitted with an
  epoch bump.

What the port decides at the seams:

* **Result types by lane.** A loopback lane returns what its executor
  returns: tensors on the plan's device (the card). A remote lane
  (``net.TcpHostLane``) returns what came off the wire as CPU tensors
  (``torch.from_numpy``), since a frontend need not hold the card. The
  values are the same bits either way; that type is the only thing
  that tells the lanes apart.
* **Distributed payloads.** At the frontend's door a distributed
  request's values are the port's stacked layout: ``(S, max_values,
  2)`` for a backward, the padded ``(S, max_planes, dim_y, dim_x[,
  2])`` space for a forward — what the distributed plan's own
  ``backward`` returns, so a result feeds the next forward unchanged.
  On the wire that is one ``single`` array. The JAX pod's per-shard
  list (``list`` on the wire) is taken too, since the plans take both;
  results are always the stacked layout.

``python -m spfft_tpu_torch.serve.cluster --smoke`` is the 2-host
loopback pod check (on the card; ``--device cpu`` runs the plans'
plain versions on the host); ``--simulate`` runs the scripted
skewed-load routing scenario.
"""

from __future__ import annotations

import heapq
import math
import random
import threading
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults as _faults
from .. import obs as _obs
from ..errors import (ClusterError, ClusterReconciliationError,
                      DeadlineExpiredError, HostLaneError,
                      InvalidParameterError, NetAuthError,
                      ParameterMismatchError, PlanArtifactError,
                      QueueFullError, StaleEpochError)
from ..faults import InjectedFault
from ..obs.counters import METRIC_SPECS
from ..obs.exporters import _PromBuilder, parse_prometheus_text, \
    prometheus_text
from ..parallel.multihost import plan_fingerprint, validate_consistent
from ..plan import TransformPlan
from ..types import Scaling
from .executor import ServeExecutor
from .registry import PlanSignature

#: Lifecycle states ordered bad-to-worse; the pod's aggregate health is
#: the worst ALIVE lane's state, floored at "degraded" while any lane
#: is dead, and "failed" only once no lane is alive.
_STATE_ORDER = ("healthy", "degraded", "draining", "failed")
_STATE_RANK = {s: i for i, s in enumerate(_STATE_ORDER)}

_PRIORITIES = ("normal", "high")

#: Resurrection-ladder backoff growth cap: a probed-forever lane
#: settles at ``lane_probe_backoff * 64`` between probes, never more.
_PROBE_BACKOFF_CAP = 64

#: Metric families that belong to one LANE's executor (per-lane
#: ``ServeMetrics`` / ``PlanRegistry`` facts): the only families an
#: IN-PROCESS lane contributes to the federated pod exposition.
#: Everything else an in-process lane renders — compile, faults, SLO,
#: store, cluster, membership, recorder, timing, trace — reads this
#: process's shared globals, which :meth:`PodFrontend.metrics_text`
#: renders exactly once; re-exporting them per lane duplicated every
#: process-wide series under per-lane ``host`` labels, with the
#: surviving copy dependent on lane iteration order.
_LANE_LEVEL_FAMILIES = ("spfft_serve_", "spfft_registry_")


def _membership_module():
    """Deferred import of :mod:`spfft_tpu_torch.net.membership` —
    ``net.transport`` imports THIS module at its top level, so the
    membership plane must resolve lazily to keep the package acyclic."""
    from ..net import membership
    return membership


def load_score(signals: dict) -> Tuple[float, float, float]:
    """The routing load of one host from its live
    ``ServeMetrics.signals()``: expected queue drain time (queue depth x
    device-execute p50) plus the measured wire round-trip to reach the
    host (``wire_rtt``, merged in by ``net.TcpHostLane.rpc_signals``;
    0 for in-process lanes), tie-broken by raw depth then raw p50.
    Small is idle. A host with no execute history yet scores by wire
    distance and depth alone — two cold in-process hosts compare equal
    and the sampler's order decides."""
    depth = float(signals.get("queue_depth", 0) or 0)
    dx50 = float(signals.get("device_execute_p50", 0.0) or 0.0)
    rtt = float(signals.get("wire_rtt", 0.0) or 0.0)
    return (depth * max(dx50, 1e-6) + rtt, depth, dx50)


class LoopbackTransport:
    """The in-process host-boundary seam. Every lane RPC funnels
    through :meth:`check`, which consults the package ``cluster.rpc``
    fault site and the lane's liveness — exactly where a real pod's
    RPC stub would surface connection errors. A failing check raises
    the typed, transient :class:`HostLaneError` the frontend's
    route-around handling keys on."""

    def __init__(self, host: str):
        self.host = host
        self.alive = True

    def check(self, op: str) -> None:
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_rpcs_total",
                                 host=self.host, op=op)
        if not self.alive:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_rpc_failures_total",
                                     host=self.host, op=op)
            raise HostLaneError(
                f"host lane {self.host!r} is dead (transport down)",
                host=self.host)
        try:
            _faults.check_site("cluster.rpc")
        except InjectedFault as exc:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_rpc_failures_total",
                                     host=self.host, op=op)
            raise HostLaneError(
                f"host lane {self.host!r} RPC {op!r} failed: {exc}",
                host=self.host) from exc


class HostLane:
    """One per-host serving lane: a host descriptor, its
    ``ServeExecutor`` and the transport the frontend reaches it
    through. The ``rpc_*`` surface is the complete host boundary — a
    real multi-process pod implements exactly these five calls over its
    RPC layer; the emulation calls them in-process behind the
    ``cluster.rpc`` fault seam."""

    def __init__(self, host: str, executor: ServeExecutor,
                 transport: Optional[LoopbackTransport] = None):
        self.host = host
        self.executor = executor
        self.transport = transport or LoopbackTransport(host)
        # set by PodFrontend.leave(): a draining lane finishes its
        # queue but receives no new routes
        self.draining = False

    @property
    def alive(self) -> bool:
        return self.transport.alive

    # trace: boundary(ctx)
    def rpc_submit(self, signature: PlanSignature, values,
                   kind: str = "backward",
                   scaling: Scaling = Scaling.NONE,
                   timeout: Optional[float] = None,
                   priority: str = "normal", ctx=None,
                   epoch: Optional[int] = None) -> Future:
        """Submit one single-device request to this host's executor,
        restoring the propagated trace context so the host's
        ``serve.request`` root is a child of the frontend span. The
        ``epoch`` stamp is accepted for surface parity with the remote
        lane but not fenced here: an in-process pod fences at the
        frontend's door (``PodFrontend.submit``), where the one shared
        ``ViewCoordinator`` lives."""
        self.transport.check("submit")
        return self.executor.submit(signature, values, kind,
                                    scaling=scaling, timeout=timeout,
                                    priority=priority, trace_ctx=ctx)

    def rpc_signals(self) -> dict:
        """Live ``ServeMetrics.signals()`` — the routing input."""
        self.transport.check("signals")
        return self.executor.metrics.signals()

    def rpc_signatures(self) -> List[PlanSignature]:
        """The registry's signature set — the reconciliation input."""
        self.transport.check("signatures")
        return self.executor.registry.signatures()

    def rpc_plan(self, signature: PlanSignature):
        """The plan object behind ``signature`` (None if unheld)."""
        self.transport.check("plan")
        return self.executor.registry.get(signature)

    def rpc_metrics_text(self) -> str:
        """This host's full Prometheus exposition — what its own
        ``MetricsServer`` would serve; the federation input."""
        self.transport.check("metrics")
        return prometheus_text(metrics=self.executor.metrics,
                               registry=self.executor.registry)

    def rpc_health(self) -> dict:
        """This host's executor ``health()`` snapshot."""
        self.transport.check("health")
        return self.executor.health()

    def rpc_prewarm(self, signatures, strict: bool = True) -> int:
        """Pull a signature set warm through this host's artifact
        tiers — the joining-lane half of elastic membership."""
        self.transport.check("prewarm")
        return self.executor.registry.prewarm_signatures(
            list(signatures), strict=strict)

    def rpc_drain(self) -> None:
        """Drain this host's queue to completion — the leaving-lane
        half of elastic membership."""
        self.transport.check("drain")
        self.executor.close(drain=True)

    def rpc_stats(self) -> dict:
        """This host's registry ``stats()`` (the warm-boot
        observable)."""
        self.transport.check("stats")
        return self.executor.registry.stats()

    def rpc_incident(self, reason: str) -> dict:
        """This host's flight-recorder incident bundle, built in
        memory — the caller owns persistence (a pod capture writes
        ONE file). In-process lanes share the process's journal, so
        :meth:`PodFrontend.capture_incident` asks only remote lanes;
        the verb exists here for surface parity with the agent."""
        self.transport.check("incident")
        from ..obs.recorder import build_incident_bundle
        return build_incident_bundle(reason, host=self.host)


class _SPMDRequest:
    """One queued distributed request inside the coalescer."""

    __slots__ = ("plan", "values", "root", "deadline", "priority",
                 "future")

    def __init__(self, plan, values, root, deadline, priority):
        self.plan = plan
        self.values = values
        self.root = root
        self.deadline = deadline
        self.priority = priority
        self.future: Future = Future()


class SPMDCoalescer:
    """The pod-wide distributed lane, grown into a coalescing
    scheduler: N queued same-signature distributed requests drain into
    ONE batched SPMD execution whose exchange moves all N payloads in a
    single collective round (the reference's shared-``Grid``
    amortization, resurrected for the pod — the distributed twin of the
    executor's fused batching win).

    Requests queue per ``(signature, kind, scaling)`` key in EDF order
    (high priority first, then earliest deadline, then arrival). A
    per-key drainer waits out a ``spmd_batch_window``-long batching
    window — closed EARLY when a queued deadline would lapse inside it
    or a high-priority member is already aboard — then executes up to
    ``spmd_max_batch`` requests through the plan's
    ``coalesce_backward``/``coalesce_forward`` batched entry points and
    demuxes per-request results. Plans without batched entry points
    (and comm-size-1 delegates, and windows that close with a single
    member) fall back to the per-request serial path, so coalescing is
    strictly an optimization: every interleaving is bit-exact vs serial
    execution.

    Admission: the queue is bounded
    by the ``max_queue`` knob (typed ``QueueFullError``), and expired
    deadlines purge as ``DeadlineExpiredError`` — now also at
    window-drain time, so a request that dies while queued never rides
    a collective round.

    Requests that are still arriving: a host agent calls
    :meth:`expect` when a submit frame's header is in and its payload
    still on the wire, and the request's :meth:`submit` (``expected=
    True``) or :meth:`release` takes the expectation back. A window that
    closes while a same-key request is expected stays open until none
    is, for at most ``RECEIVE_HOLD_S`` past its end: a 256^3 payload
    takes longer to receive and decode than the knob's largest window
    (0.1 s), so without the hold two concurrent requests sent over the
    wire would meet only by chance. (Not in the JAX package, whose
    lane opens its window at enqueue only; an in-process frontend never
    expects, so its rounds are the JAX package's.)"""

    #: bound on the launch-duration reservoir feeding signals()
    _RESERVOIR = 256
    #: the longest a window stays open past its end for expected
    #: requests (seconds): bounds what a stalled or lying sender costs
    RECEIVE_HOLD_S = 2.0

    def __init__(self, max_workers: int = 2,
                 span_args: Optional[dict] = None):
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="spfft-pod-spmd")
        self._cv = threading.Condition()
        self._queues: Dict[tuple, list] = {}  #: guarded by _cv
        self._incoming: Dict[tuple, int] = {}  #: guarded by _cv
        self._active: set = set()  #: guarded by _cv
        self._depth = 0  #: guarded by _cv
        self._seq = 0  #: guarded by _cv
        self._closed = False  #: guarded by _cv
        self._launches = 0  #: guarded by _cv
        self._coalesced = 0  #: guarded by _cv
        self._batch_hist: Dict[int, int] = {}  #: guarded by _cv
        self._launch_s: List[float] = []  #: guarded by _cv
        self._span_args = dict(span_args or {})

    # -- admission ----------------------------------------------------------
    @staticmethod
    def key(signature: PlanSignature, kind: str, scaling) -> tuple:
        """The queue a request joins: same key, same rounds."""
        return (signature, kind, Scaling(scaling))

    def expect(self, key) -> None:
        """A request of ``key`` is arriving: hold closing windows of
        ``key`` until its :meth:`submit` or :meth:`release`."""
        with self._cv:
            self._incoming[key] = self._incoming.get(key, 0) + 1

    def release(self, key) -> None:
        """Take back one :meth:`expect` of ``key`` (the request will
        not be submitted)."""
        with self._cv:
            self._release_locked(key)
            self._cv.notify_all()

    # lock: holds(_cv)
    def _release_locked(self, key) -> None:
        left = self._incoming.get(key, 0) - 1
        if left > 0:
            self._incoming[key] = left
        else:
            self._incoming.pop(key, None)

    def submit(self, signature: PlanSignature, plan, values, kind: str,
               scaling: Scaling, root,
               timeout: Optional[float] = None,
               priority: str = "normal",
               expected: bool = False) -> Future:
        """Admission-controlled enqueue: the lane's queue is bounded by
        the control plane's ``max_queue`` knob (overflow is the same
        typed ``QueueFullError`` backpressure the single-host executor
        answers), and a request carrying a deadline that expires while
        queued is purged as ``DeadlineExpiredError`` instead of burning
        the whole mesh on an answer nobody awaits. ``expected`` takes
        back this request's :meth:`expect`, admitted or not."""
        from ..control.config import global_config
        cap = int(global_config().max_queue)
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        req = _SPMDRequest(plan, values, root, deadline, priority)
        key = self.key(signature, kind, scaling)
        with self._cv:
            if expected:
                self._release_locked(key)
                self._cv.notify_all()
            if self._closed:
                raise ClusterError("pod SPMD lane is closed")
            if self._depth >= cap:
                _obs.GLOBAL_COUNTERS.inc(
                    "spfft_cluster_spmd_rejected_total",
                    reason="queue_full")
                raise QueueFullError(
                    f"pod SPMD lane queue is full ({cap})")
            self._depth += 1
            self._seq += 1
            rank = (0 if priority == "high" else 1,
                    math.inf if deadline is None else deadline,
                    self._seq)
            heapq.heappush(self._queues.setdefault(key, []),
                           rank + (req,))
            if key not in self._active:
                self._active.add(key)
                self._pool.submit(self._drain_key, key)
            self._cv.notify_all()
        return req.future

    # -- the drain loop -----------------------------------------------------
    def _drain_key(self, key) -> None:
        """Form and execute coalescing rounds for one key until its
        queue is dry. Between rounds the drainer hands its pool slot
        back (resubmitting itself) so other signatures' drainers get a
        turn under a small pool."""
        while True:
            bucket = self._collect(key)
            if bucket:
                self._execute_round(key, bucket)
            with self._cv:
                if not self._queues.get(key):
                    self._active.discard(key)
                    self._queues.pop(key, None)
                    return
                if not self._closed:
                    try:
                        self._pool.submit(self._drain_key, key)
                        return
                    except RuntimeError:  # pragma: no cover
                        pass  # pool shutting down: finish inline

    def _collect(self, key) -> List[_SPMDRequest]:
        """Wait out the batching window, absorbing same-key arrivals
        until the bucket is full or the window closes (early on an
        imminent member deadline or a high-priority member). Expired
        queued requests purge here — the drain-time half of the
        deadline contract."""
        from ..control.config import global_config
        cfg = global_config()
        window = float(cfg.spmd_batch_window)
        cap = max(1, int(cfg.spmd_max_batch))
        bucket: List[_SPMDRequest] = []
        purged: List[_SPMDRequest] = []
        until = None
        with self._cv:
            while True:
                now = time.monotonic()
                lane = self._queues.get(key) or []
                expired = [e for e in lane if e[1] <= now]
                if expired:
                    lane[:] = [e for e in lane if e[1] > now]
                    heapq.heapify(lane)
                    purged.extend(e[3] for e in expired)
                    self._depth -= len(expired)
                while lane and len(bucket) < cap:
                    bucket.append(heapq.heappop(lane)[3])
                if len(bucket) >= cap or self._closed or not bucket:
                    break
                if until is None:
                    until = now + window
                hold = until + self.RECEIVE_HOLD_S \
                    if self._incoming.get(key) else until
                close_at = min(hold,
                               min((r.deadline for r in bucket
                                    if r.deadline is not None),
                                   default=math.inf))
                if close_at - now <= 0 \
                        or any(r.priority == "high" for r in bucket):
                    break
                self._cv.wait(close_at - now)
        # purged futures resolve OUTSIDE the lock (done callbacks run
        # arbitrary frontend code)
        for req in purged:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_spmd_rejected_total",
                                     reason="expired")
            req.future.set_exception(DeadlineExpiredError(
                "distributed request deadline expired in the SPMD "
                "lane queue"))
        return bucket

    # -- one coalesced round ------------------------------------------------
    def _execute_round(self, key, bucket: List[_SPMDRequest]) -> None:
        signature, kind, scaling = key
        batch = len(bucket)
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_spmd_requests_total",
                                 batch)
        span = None
        traced = [r for r in bucket if r.root is not None]
        if traced and _obs.active():
            first = traced[0].root
            args = {"kind": kind, "batch": batch,
                    "member_trace_ids": [r.root.trace_id
                                         for r in traced]}
            args.update(self._span_args)
            # span: closed-by(SPMDCoalescer._execute_round)
            span = _obs.GLOBAL_TRACER.begin(
                "cluster.spmd_execute", cat="cluster",
                trace_id=first.trace_id, parent=first,
                track="pod:spmd", args=args)
        t0 = time.perf_counter()
        try:
            _faults.check_site("cluster.spmd_window")
            results = self._execute(bucket[0].plan,
                                    [r.values for r in bucket],
                                    kind, scaling)
        except BaseException as exc:
            if span is not None:
                _obs.GLOBAL_TRACER.finish(span, status="error",
                                          error=type(exc).__name__)
            self._finish_round(batch, time.perf_counter() - t0)
            for req in bucket:
                req.future.set_exception(exc)
            return
        if span is not None:
            _obs.GLOBAL_TRACER.finish(span)
        self._finish_round(batch, time.perf_counter() - t0)
        if batch > 1:
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_spmd_coalesced_total",
                                     batch)
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_spmd_batch_size_total",
                                 size=str(batch))
        for req, result in zip(bucket, results):
            req.future.set_result(result)

    def _finish_round(self, batch: int, seconds: float) -> None:
        with self._cv:
            self._depth -= batch
            self._launches += 1
            self._batch_hist[batch] = self._batch_hist.get(batch, 0) + 1
            if batch > 1:
                self._coalesced += batch
            self._launch_s.append(seconds)
            del self._launch_s[:-self._RESERVOIR]

    @staticmethod
    def _execute(plan, values_list, kind, scaling):
        """Batched execution when the plan offers it; the per-request
        serial path otherwise (duck-typed test plans, remote
        descriptors). ``coalesce_*`` itself serializes batch==1 and
        comm-size-1 delegates, so this seam is bit-exactness-neutral."""
        if kind == "backward":
            coalesce = getattr(plan, "coalesce_backward", None)
            if coalesce is not None:
                return coalesce(values_list)
            return [plan.backward(v) for v in values_list]
        coalesce = getattr(plan, "coalesce_forward", None)
        if coalesce is not None:
            return coalesce(values_list, scaling)
        return [plan.forward(v, scaling) for v in values_list]

    # -- telemetry ----------------------------------------------------------
    def signals(self) -> dict:
        """Live coalescer signals for the controller's
        ``spmd_batch_window``/``spmd_max_batch`` rule."""
        with self._cv:
            depth = self._depth
            launches = self._launches
            coalesced = self._coalesced
            hist = dict(self._batch_hist)
            samples = sorted(self._launch_s)
        p50 = samples[len(samples) // 2] if samples else 0.0
        return {"spmd_queue_depth": depth, "spmd_launches": launches,
                "spmd_coalesced": coalesced, "spmd_launch_p50": p50,
                "spmd_batch_hist": hist}

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._pool.shutdown(wait=True)


class PodFrontend:
    """N host lanes + one pod-wide SPMD lane behind a single
    ``submit()``.

    ``lanes`` is a sequence of :class:`HostLane` (or ``(host, executor)``
    pairs). Construction RECONCILES the pod (see :meth:`reconcile`) —
    a frontend never starts routing onto hosts that disagree about the
    plan set. ``policy`` is ``"p2c"`` (power-of-two-choices, default)
    or ``"rr"`` (round-robin; kept for the routing benchmark and as the
    degenerate fallback). ``seed`` fixes the choice sampler, so a
    replayed trace routes identically.

    ``membership`` is the :class:`net.membership.ViewCoordinator` this
    frontend fences against: None builds a private one (a loopback pod
    is trivially its own coordinator); two frontends over the same
    lanes share one coordinator to converge on a single epoch-fenced
    view. When any lane is remote (it carries ``rpc_view``), the
    AGENTS' lease-based coordinator is the authority instead and the
    local coordinator is only this frontend's fencing mirror.
    """

    def __init__(self, lanes: Sequence, policy: str = "p2c",
                 seed: int = 0, reconcile: bool = True,
                 membership=None):
        if policy not in ("p2c", "rr"):
            raise InvalidParameterError(
                f"routing policy must be 'p2c' or 'rr', got {policy!r}")
        self._lanes: List[HostLane] = []
        for lane in lanes:
            if isinstance(lane, HostLane):
                self._lanes.append(lane)
            else:
                host, executor = lane
                self._lanes.append(HostLane(host, executor))
        if not self._lanes:
            raise InvalidParameterError("a pod needs at least one lane")
        names = [ln.host for ln in self._lanes]
        if len(set(names)) != len(names):
            raise InvalidParameterError(
                f"duplicate host names in pod: {names}")
        self.policy = policy
        self._rng = random.Random(seed)  #: guarded by _rng_lock
        self._rng_lock = threading.Lock()
        self._rr_next = 0  #: guarded by _rng_lock
        self._spmd = SPMDCoalescer()
        self._tracer = _obs.GLOBAL_TRACER
        self._closed = False
        # -- membership plane: the epoch this frontend fences against
        self._remote = any(hasattr(ln, "rpc_view") for ln in self._lanes)
        if membership is None:
            membership = _membership_module().ViewCoordinator(
                min(names))
        self._membership = membership
        for ln in self._lanes:
            self._membership.ensure(ln.host)
        #: resurrection ladder: host -> [failed probes, next-probe
        #: deadline (monotonic)]  #: guarded by _dead_lock
        self._dead: Dict[str, list] = {}
        self._dead_lock = threading.Lock()
        #: hosts with a probe in flight (background worker or an
        #: explicit probe_dead walk) — one prober per host at a time
        #: guarded by _dead_lock
        self._probing: set = set()
        #: background prober: routing only SCHEDULES due probes here —
        #: the health RPC and the strict prewarm + re-reconcile
        #: readmission gate (which may compile plans) must never run
        #: inline on a live submit
        self._probe_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="spfft-pod-probe")
        self._stamp = self._membership.epoch  # refreshed via view()
        if self._remote:
            try:
                self.view()
            except (ClusterError, HostLaneError):
                pass  # no agent reachable yet; first submit refetches
        if reconcile:
            self.reconcile()
        # flight recorder: route auto triggers (SLO page, health
        # degrade, lane death) through the POD capture, so one rising
        # edge snapshots every alive host, not just this process
        from ..obs import recorder as _recorder
        self._incident_capturer = self.capture_incident
        _recorder.set_incident_capturer(self._incident_capturer)
        _recorder.set_health_provider(self.health)

    # -- reconciliation -----------------------------------------------------
    def reconcile(self) -> None:
        """Verify every alive lane agrees on the plan set: identical
        ``PlanSignature`` sets, and for each distributed plan an
        identical ``parallel.multihost`` fingerprint, checked through
        ``validate_consistent`` with a loopback collective per host
        (the ``cluster.reconcile`` fault site fires once per host per
        plan, where a real pod's allgather would run). Raises
        :class:`ClusterReconciliationError` naming the disagreement."""
        lanes = [ln for ln in self._lanes if ln.alive]
        if not lanes:
            raise ClusterError("no alive host lanes to reconcile")
        try:
            sig_sets = [ln.rpc_signatures() for ln in lanes]
        except HostLaneError as exc:
            self._count_reconcile("failed")
            raise ClusterReconciliationError(
                f"reconciliation RPC failed: {exc}") from exc
        base = set(sig_sets[0])
        for ln, sigs in zip(lanes[1:], sig_sets[1:]):
            if set(sigs) != base:
                self._count_reconcile("mismatch")
                raise ClusterReconciliationError(
                    f"host {ln.host!r} holds a different plan set than "
                    f"host {lanes[0].host!r}: "
                    f"{sorted(set(sigs) ^ base, key=repr)} differ")
        for sig in sorted(base, key=repr):
            plans = [ln.rpc_plan(sig) for ln in lanes]
            if any(p is None for p in plans):
                self._count_reconcile("mismatch")
                missing = [ln.host for ln, p in zip(lanes, plans)
                           if p is None]
                raise ClusterReconciliationError(
                    f"host(s) {missing} no longer hold {sig}")
            if any(isinstance(p, dict) for p in plans):
                # at least one remote lane: plans never cross the wire,
                # so agreement reduces to descriptor rows
                self._reconcile_descriptors(sig, lanes, plans)
                continue
            if isinstance(plans[0], TransformPlan):
                continue  # local plans: signature equality IS the digest
            rows = [np.frombuffer(plan_fingerprint(p.dist_plan), np.uint8)
                    for p in plans]
            for i, (ln, plan) in enumerate(zip(lanes, plans)):
                try:
                    _faults.check_site("cluster.reconcile")
                    validate_consistent(
                        plan.dist_plan,
                        collective=(_loopback_allgather(rows, i),
                                    len(lanes), i))
                except ParameterMismatchError as exc:
                    self._count_reconcile("mismatch")
                    raise ClusterReconciliationError(
                        f"distributed plan {sig} disagrees across the "
                        f"pod (observed from host {ln.host!r}): {exc}"
                    ) from exc
                except InjectedFault as exc:
                    self._count_reconcile("failed")
                    raise ClusterReconciliationError(
                        f"reconciliation collective failed on host "
                        f"{ln.host!r}: {exc}") from exc
        self._count_reconcile("ok")

    @staticmethod
    def _count_reconcile(outcome: str) -> None:
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_reconciliations_total",
                                 outcome=outcome)

    def _reconcile_descriptors(self, sig, lanes, plans) -> None:
        """Digest agreement when any lane answers a remote plan
        DESCRIPTOR (``net.TcpHostLane.rpc_plan``): every lane's answer
        — descriptor, local single plan, or local distributed plan —
        reduces to a ``(distributed, fingerprint-hex)`` row and all
        rows must be identical; the wire analogue of the loopback
        fingerprint collective."""
        rows = []
        for lane, p in zip(lanes, plans):
            try:
                _faults.check_site("cluster.reconcile")
            except InjectedFault as exc:
                self._count_reconcile("failed")
                raise ClusterReconciliationError(
                    f"reconciliation failed on host {lane.host!r}: "
                    f"{exc}") from exc
            if isinstance(p, dict):
                rows.append((bool(p.get("distributed")),
                             p.get("fingerprint")))
            elif isinstance(p, TransformPlan):
                rows.append((False, None))
            else:
                rows.append((True, plan_fingerprint(p.dist_plan).hex()))
        if len(set(rows)) != 1:
            self._count_reconcile("mismatch")
            detail = {lane.host: row
                      for lane, row in zip(lanes, rows)}
            raise ClusterReconciliationError(
                f"plan {sig} disagrees across the pod: {detail}")

    # -- membership view ----------------------------------------------------
    @property
    def epoch(self) -> int:
        """The view epoch this frontend currently stamps on routed
        work (the last one :meth:`view` fetched)."""
        return self._stamp

    def view(self) -> dict:
        """Fetch, verify and adopt the pod's current signed membership
        view; returns its wire form and refreshes the fencing stamp.
        Loopback pods serve it from the frontend's own coordinator;
        remote pods fetch it from the first reachable agent (every
        agent converges on the coordinator's view). A view whose
        signature does not verify is the permanent
        :class:`NetAuthError` — never silently adopted."""
        mm = _membership_module()
        if not self._remote:
            v = self._membership.view()
            self._stamp = v.epoch
            return v.to_wire()
        last: Optional[Exception] = None
        for lane in self._lanes:
            if not hasattr(lane, "rpc_view") or not lane.alive:
                continue
            try:
                wire = lane.rpc_view(ctx=None)
            except HostLaneError as exc:
                last = exc
                continue
            v = mm.MembershipView.from_wire(wire)
            if not v.verify(mm._secret()):
                _obs.GLOBAL_COUNTERS.inc(
                    "spfft_membership_views_total", outcome="bad_sig")
                raise NetAuthError(
                    f"membership view from host {lane.host!r} does "
                    f"not verify")
            _obs.GLOBAL_COUNTERS.inc("spfft_membership_views_total",
                                     outcome="adopted")
            self._stamp = v.epoch
            return v.to_wire()
        raise ClusterError(
            "no alive host lane served the membership view"
            + (f" (last transport error: {last})" if last else ""))

    # -- submission ---------------------------------------------------------
    def submit(self, signature: PlanSignature, values,
               kind: str = "backward",
               scaling: Scaling = Scaling.NONE,
               timeout: Optional[float] = None,
               priority: str = "normal") -> Future:
        """Route one request into the pod; returns its Future.

        Single-device signatures go to the least-loaded host
        (power-of-two-choices under the default policy) and retain
        every single-host semantics (deadlines, priorities,
        backpressure — a chosen host's ``QueueFullError`` propagates).
        Distributed signatures execute on the pod-wide SPMD lane.
        Either way the frontend's ``cluster.request`` span is the
        request's trace root and resolves exactly when the future
        does."""
        if self._closed:
            raise ClusterError("pod frontend is closed")
        if kind not in ("backward", "forward"):
            raise InvalidParameterError(
                f"kind must be 'backward' or 'forward', got {kind!r}")
        if priority not in _PRIORITIES:
            raise InvalidParameterError(
                f"priority must be 'normal' or 'high', got {priority!r}")
        scaling = Scaling(scaling)
        if not self._remote:
            # loopback fencing happens at the frontend's own door: a
            # stamp gone stale (another frontend over the shared
            # coordinator changed the membership) is rejected typed —
            # and recovered exactly as the contract says, by refetching
            # the view and retrying with the fresh epoch.
            try:
                self._membership.check_epoch(self._stamp,
                                             node="frontend")
            except StaleEpochError:
                self._stamp = self._membership.epoch
        plan = self._resolve_plan(signature)
        # a dict is a remote plan DESCRIPTOR (net.TcpHostLane.rpc_plan
        # — the plan object itself never crosses the wire): execution
        # happens host-side, so even a distributed descriptor routes
        # through the lane path
        remote = isinstance(plan, dict)
        if remote:
            distributed = bool(plan.get("distributed"))
        else:
            distributed = not isinstance(plan, TransformPlan)
        root = None
        if _obs.active() and self._tracer.sample():
            # span: closed-by(PodFrontend._settle)
            root = self._tracer.begin(
                "cluster.request", cat="cluster",
                trace_id=self._tracer.new_trace_id(), track="pod",
                args={"kind": kind,
                      "plan": "distributed" if distributed else "single"})
        try:
            if distributed and not remote:
                fut = self._spmd.submit(signature, plan, values, kind,
                                        scaling, root, timeout=timeout,
                                        priority=priority)
                _obs.GLOBAL_COUNTERS.inc("spfft_cluster_routed_total",
                                         host="pod", kind="distributed")
            else:
                # remote distributed descriptors route with SIGNATURE
                # AFFINITY: the agent-side coalescing window can only
                # merge what routing co-locates, so concurrent
                # same-signature requests must land on the same host
                fut = self._submit_single(
                    signature, values, kind, scaling, timeout, priority,
                    _obs.span_context(root),
                    routed_kind="distributed" if distributed
                    else "single",
                    affinity=signature if distributed else None)
        except BaseException as exc:
            self._settle(root, exc)
            raise
        fut.add_done_callback(
            lambda f, _root=root: self._settle(_root, f.exception()))
        return fut

    def submit_backward(self, signature, values,
                        timeout: Optional[float] = None,
                        priority: str = "normal") -> Future:
        return self.submit(signature, values, "backward",
                           timeout=timeout, priority=priority)

    def submit_forward(self, signature, space,
                       scaling: Scaling = Scaling.NONE,
                       timeout: Optional[float] = None,
                       priority: str = "normal") -> Future:
        return self.submit(signature, space, "forward", scaling=scaling,
                           timeout=timeout, priority=priority)

    def _settle(self, root, exc: Optional[BaseException]) -> None:
        """The one closer of the frontend's ``cluster.request`` span —
        every resolution path (submit-time raise, future success,
        future failure) funnels through it, which is how the
        zero-unclosed-spans contract extends across the pod."""
        if root is None:
            return
        if exc is None:
            self._tracer.finish(root)
        else:
            self._tracer.finish(root, status="error",
                                error=type(exc).__name__)

    def _resolve_plan(self, signature: PlanSignature):
        """The plan behind ``signature`` from the first alive lane
        (reconciliation guarantees every lane agrees)."""
        last: Optional[HostLaneError] = None
        for lane in self._lanes:
            if not lane.alive:
                continue
            try:
                plan = lane.rpc_plan(signature)
            except HostLaneError as exc:
                self._mark_dead(lane)
                last = exc
                continue
            if plan is None:
                raise InvalidParameterError(
                    f"signature not held by the pod (warm up first): "
                    f"{signature}")
            return plan
        raise ClusterError(
            f"no alive host lanes to resolve {signature}"
            + (f" (last transport error: {last})" if last else ""))

    def _submit_single(self, signature, values, kind, scaling, timeout,
                       priority, ctx,
                       routed_kind: str = "single",
                       affinity=None) -> Future:
        """Pick a host (p2c or rr; signature affinity when given), fail
        over across survivors on transport errors. Backpressure
        (``QueueFullError``) and every other executor-side error
        propagate untranslated — routing only absorbs the
        lane-is-unreachable failure mode."""
        _faults.check_site("cluster.route")
        candidates = (self._candidates() if affinity is None
                      else self._affinity_candidates(affinity))
        for lane in candidates:
            try:
                fut = lane.rpc_submit(signature, values, kind,
                                      scaling=scaling, timeout=timeout,
                                      priority=priority, ctx=ctx,
                                      epoch=self._stamp)
            except HostLaneError:
                self._mark_dead(lane)
                continue
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_routed_total",
                                     host=lane.host, kind=routed_kind)
            if self._remote:
                fut = self._fence_retry(
                    fut, lane, (signature, values, kind, scaling,
                                timeout, priority, ctx))
            return fut
        raise ClusterError(
            "no alive host lanes accepted the request (all transports "
            "down)")

    def _fence_retry(self, fut: Future, lane, request) -> Future:
        """Wrap a remote submit future with the epoch-fencing recovery
        contract: an agent-side :class:`StaleEpochError` (typed,
        transient) refetches the view and resubmits ONCE with the
        fresh stamp — transparent to the caller's future. Any other
        resolution passes through untouched."""
        outer: Future = Future()
        outer.set_running_or_notify_cancel()
        signature, values, kind, scaling, timeout, priority, ctx = \
            request

        def _copy(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                outer.set_result(f.result())
            else:
                outer.set_exception(exc)

        def _first(f: Future) -> None:
            exc = f.exception()
            if not isinstance(exc, StaleEpochError):
                _copy(f)
                return
            try:
                self.view()
                retry = lane.rpc_submit(
                    signature, values, kind, scaling=scaling,
                    timeout=timeout, priority=priority, ctx=ctx,
                    epoch=self._stamp)
            except BaseException as rexc:
                outer.set_exception(rexc)
                return
            retry.add_done_callback(_copy)

        fut.add_done_callback(_first)
        return outer

    def _candidates(self) -> List[HostLane]:
        """Lanes in dispatch-preference order: the policy's pick first,
        then every other alive, non-draining lane as failover. Lanes on
        the resurrection ladder are NOT candidates — readmission, not
        the raw transport flag, controls candidacy."""
        self._maybe_probe()
        alive = [ln for ln in self._lanes
                 if ln.alive and not ln.draining
                 and not self._on_ladder(ln.host)]
        if len(alive) <= 1:
            return alive
        if self.policy == "rr":
            with self._rng_lock:
                start = self._rr_next % len(alive)
                self._rr_next += 1
            return alive[start:] + alive[:start]
        # power-of-two-choices: sample two distinct lanes, rank them by
        # live load, then append the rest as failover.
        with self._rng_lock:
            pair = self._rng.sample(range(len(alive)), 2)
        scored = []
        for i in pair:
            lane = alive[i]
            try:
                score = load_score(lane.rpc_signals())
            except HostLaneError:
                self._mark_dead(lane)
                continue
            scored.append((score, i, lane))
        scored.sort(key=lambda t: t[:2])
        picked = [lane for _, _, lane in scored]
        rest = [ln for ln in alive
                if ln.alive and ln not in picked]
        return picked + rest

    def _affinity_candidates(self, signature) -> List[HostLane]:
        """Lanes in dispatch order for a remote DISTRIBUTED request: a
        stable per-signature primary (crc32 of the signature's repr mod
        the alive-lane count) so concurrent same-signature requests
        co-locate and the host agent's coalescing window can merge
        them; the remaining alive lanes follow as failover."""
        self._maybe_probe()
        alive = [ln for ln in self._lanes
                 if ln.alive and not ln.draining
                 and not self._on_ladder(ln.host)]
        if len(alive) <= 1:
            return alive
        start = zlib.crc32(repr(signature).encode()) % len(alive)
        return alive[start:] + alive[:start]

    def _mark_dead(self, lane: HostLane) -> None:
        """A transport failure takes the lane out of routing — but no
        longer forever. The lane enters the resurrection ladder: its
        eviction bumps the view epoch (both frontends over a shared
        coordinator observe it), and backoff-spaced health probes keep
        testing it until re-reconciliation readmits it warm."""
        if lane.transport.alive:
            lane.transport.alive = False
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_lane_deaths_total",
                                 host=lane.host)
        with self._dead_lock:
            fresh = lane.host not in self._dead
            if fresh:
                base = self._probe_backoff()
                with self._rng_lock:
                    jitter = 1.0 + self._rng.random() * 0.25
                self._dead[lane.host] = [0,
                                         time.monotonic() + base * jitter]
        if fresh:
            _obs.record_event("lane.death", host=lane.host)
            self._membership.evict(lane.host)
            self._count_membership("evicted")
            if not self._remote:
                self._stamp = self._membership.epoch
            # a lane death is a flight-recorder auto trigger: the pod
            # just lost capacity, snapshot the black box while the
            # failure's trace tail is still in the retained ring
            _obs.maybe_auto_capture("lane_death", lane.host)

    def _probe_backoff(self) -> float:
        from ..control.config import global_config
        return float(global_config().lane_probe_backoff)

    def _on_ladder(self, host: str) -> bool:
        with self._dead_lock:
            return host in self._dead

    def _maybe_probe(self, now: Optional[float] = None) -> None:
        """Opportunistic resurrection: routing notices a dead lane
        whose backoff deadline has passed and SCHEDULES its probe on
        the background worker. The submit path never blocks on the
        health RPC or the readmission gate (strict prewarm +
        re-reconcile, which may compile plans) — a due probe costs a
        live request one set-membership check and a thread-pool
        enqueue."""
        if now is None:
            now = time.monotonic()
        with self._dead_lock:
            due = [h for h, (_, deadline) in self._dead.items()
                   if now >= deadline and h not in self._probing]
            self._probing.update(due)
        for host in due:
            try:
                self._probe_pool.submit(self._probe_bg, host)
            except RuntimeError:  # pool shut down mid-close
                with self._dead_lock:
                    self._probing.discard(host)

    def _probe_bg(self, host: str) -> None:
        """One scheduled background probe (the worker half of
        :meth:`_maybe_probe`)."""
        try:
            lane = next((ln for ln in self._lanes if ln.host == host),
                        None)
            if lane is None:  # left the pod while on the ladder
                with self._dead_lock:
                    self._dead.pop(host, None)
                return
            if not self._closed:
                self._probe(lane, time.monotonic())
        finally:
            with self._dead_lock:
                self._probing.discard(host)

    def probe_dead(self, force: bool = False) -> Dict[str, str]:
        """Ops/chaos entry point: walk the resurrection ladder NOW
        (synchronously — unlike routing's background scheduling).
        Returns per-host outcomes (``backoff`` when the next probe is
        not yet due and ``force`` is False, ``probing`` when a
        background probe already has the host in flight, else
        ``failed`` / ``blocked`` / ``readmitted``)."""
        now = time.monotonic()
        with self._dead_lock:
            entries = [(h, deadline)
                       for h, (_, deadline) in self._dead.items()]
        out: Dict[str, str] = {}
        for host, deadline in entries:
            if not force and now < deadline:
                out[host] = "backoff"
                continue
            with self._dead_lock:
                if host in self._probing:
                    out[host] = "probing"
                    continue
                self._probing.add(host)
            try:
                lane = next(
                    (ln for ln in self._lanes if ln.host == host),
                    None)
                if lane is None:
                    with self._dead_lock:
                        self._dead.pop(host, None)
                    continue
                out[host] = self._probe(lane, now)
            finally:
                with self._dead_lock:
                    self._probing.discard(host)
        return out

    def _probe(self, lane: HostLane, now: float) -> str:
        """One ladder step: health-probe the dead lane; on success run
        the readmission re-reconcile. A remote lane's death is only a
        cached belief about another process, so the probe re-tests the
        wire (the transport flag flips back on failure); a loopback
        lane's flag IS the simulated host state and is respected."""
        remote = hasattr(lane, "rpc_view")
        revived = False
        if remote and not lane.transport.alive:
            lane.transport.alive = True
            revived = True
        try:
            lane.rpc_health()
        except (HostLaneError, InjectedFault):
            if revived:
                lane.transport.alive = False
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_probes_total",
                                     host=lane.host, outcome="failed")
            _obs.record_event("lane.probe", host=lane.host,
                              outcome="failed")
            self._defer_probe(lane.host, now)
            return "failed"
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_probes_total",
                                 host=lane.host, outcome="ok")
        _obs.record_event("lane.probe", host=lane.host, outcome="ok")
        return self._readmit_lane(lane, now, revived)

    def _readmit_lane(self, lane: HostLane, now: float,
                      revived: bool) -> str:
        """The gate between 'answers health probes' and 'receives
        routes': re-reconcile the resurrected lane against an incumbent
        over the plan-fingerprint digest path. A host that came
        back serving a DIFFERENT plan set is blocked (typed, counted),
        not silently readmitted."""
        base = next(
            (ln for ln in self._lanes
             if ln.alive and not ln.draining and ln is not lane
             and not self._on_ladder(ln.host)), None)
        try:
            _faults.check_site("cluster.readmit")
            if base is not None:
                sigs = base.rpc_signatures()
                lane.rpc_prewarm(sigs, strict=True)
                self._reconcile_join(lane, base, sigs)
        except (ClusterReconciliationError, HostLaneError,
                PlanArtifactError, InjectedFault):
            if revived:
                lane.transport.alive = False
            _obs.GLOBAL_COUNTERS.inc("spfft_cluster_readmits_total",
                                     host=lane.host, outcome="blocked")
            self._defer_probe(lane.host, now)
            return "blocked"
        with self._dead_lock:
            self._dead.pop(lane.host, None)
        lane.transport.alive = True
        lane.draining = False
        self._membership.readmit(lane.host)
        self._count_membership("readmitted")
        if not self._remote:
            self._stamp = self._membership.epoch
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_readmits_total",
                                 host=lane.host, outcome="readmitted")
        _obs.record_event("lane.readmit", host=lane.host)
        return "readmitted"

    def _defer_probe(self, host: str, now: float) -> None:
        """Push the host's next probe out: exponential backoff from
        the ``lane_probe_backoff`` knob, capped at 64x, jittered from
        the frontend's seeded sampler (deterministic under chaos
        replay)."""
        with self._dead_lock:
            entry = self._dead.get(host)
            if entry is None:
                return
            entry[0] += 1
            delay = self._probe_backoff() * min(2 ** entry[0],
                                                _PROBE_BACKOFF_CAP)
            with self._rng_lock:
                delay *= 1.0 + self._rng.random() * 0.25
            entry[1] = now + delay

    def kill_host(self, host: str) -> None:
        """Chaos/ops entry point: take one lane out of the pod. Its
        executor is closed (resolving every queued future — completed
        or typed failure, never a hang), the lane stops receiving
        routes, and pod health degrades while survivors keep serving."""
        for lane in self._lanes:
            if lane.host == host:
                self._mark_dead(lane)
                if lane.executor is not None:
                    lane.executor.close()
                return
        raise InvalidParameterError(f"no lane named {host!r}")

    # -- elastic membership -------------------------------------------------
    @staticmethod
    def _count_membership(event: str) -> None:
        _obs.GLOBAL_COUNTERS.inc("spfft_cluster_membership_total",
                                 event=event)

    def join(self, lane) -> None:
        """Admit one lane into the LIVE pod. The joiner prewarms from
        an incumbent's signature set first (``rpc_prewarm`` resolves
        every single-device signature through the joiner's artifact
        tiers — memory, disk, remote blob — with zero builds; the
        distributed plans it must already have derived, they are never
        serialized), then an INCREMENTAL re-reconciliation checks the
        newcomer against one incumbent (the rest of the pod already
        agrees with it), and only then does the lane start receiving
        routes. A failed join leaves the membership exactly as it was
        and raises typed."""
        if self._closed:
            raise ClusterError("pod frontend is closed")
        if not isinstance(lane, HostLane):
            host, executor = lane
            lane = HostLane(host, executor)
        if any(ln.host == lane.host for ln in self._lanes):
            raise InvalidParameterError(
                f"host {lane.host!r} is already a pod member")
        self._count_membership("join_started")
        base = next(
            (ln for ln in self._lanes if ln.alive and not ln.draining),
            None)
        try:
            if base is None:
                raise ClusterError(
                    "no alive incumbent lane to join against")
            sigs = base.rpc_signatures()
            lane.rpc_prewarm(sigs, strict=True)
            self._count_membership("prewarmed")
            self._reconcile_join(lane, base, sigs)
            self._count_membership("reconciled")
        except Exception:
            self._count_membership("join_failed")
            raise
        self._lanes.append(lane)
        self._membership.ensure(lane.host)
        if not self._remote:
            self._stamp = self._membership.epoch
        self._count_membership("joined")

    def _reconcile_join(self, lane: HostLane, base: HostLane,
                        sigs) -> None:
        """The incremental half of :meth:`reconcile`: joiner vs one
        incumbent, signature-set containment plus per-plan descriptor
        agreement."""
        held = set(lane.rpc_signatures())
        missing = [s for s in sigs if s not in held]
        if missing:
            self._count_reconcile("mismatch")
            raise ClusterReconciliationError(
                f"joining host {lane.host!r} does not hold "
                f"{missing[:4]} after prewarm")
        for sig in sorted(sigs, key=repr):
            pair = [base.rpc_plan(sig), lane.rpc_plan(sig)]
            if any(p is None for p in pair):
                self._count_reconcile("mismatch")
                raise ClusterReconciliationError(
                    f"{sig} vanished during join reconciliation")
            self._reconcile_descriptors(sig, [base, lane], pair)
        self._count_reconcile("ok")

    def leave(self, host: str, drain: bool = True) -> dict:
        """Remove one lane from the live pod: it stops receiving new
        routes immediately (``draining``), optionally drains its queue
        to completion (every accepted future resolves), then leaves the
        membership."""
        lane = next((ln for ln in self._lanes if ln.host == host), None)
        if lane is None:
            raise InvalidParameterError(f"no lane named {host!r}")
        self._count_membership("leave_started")
        lane.draining = True
        drained = False
        if drain and lane.alive:
            try:
                lane.rpc_drain()
            except HostLaneError:
                self._mark_dead(lane)
            else:
                drained = True
                self._count_membership("drained")
        self._lanes.remove(lane)
        with self._dead_lock:
            self._dead.pop(host, None)
        self._membership.leave(host)
        if not self._remote:
            self._stamp = self._membership.epoch
        self._count_membership("left")
        return {"host": host, "drained": drained}

    # -- federated telemetry ------------------------------------------------
    def health(self) -> dict:
        """The pod ``/healthz`` snapshot: per-host states plus the
        aggregate. Worst alive-lane health wins; any dead lane floors
        the pod at ``degraded``; no alive lane at all is ``failed``."""
        hosts: Dict[str, dict] = {}
        worst = "healthy"
        dead = 0
        for lane in self._lanes:
            if not lane.alive:
                dead += 1
                hosts[lane.host] = {"state": "failed",
                                    "reason": "lane dead"}
                continue
            try:
                snap = lane.rpc_health()
            except HostLaneError:
                self._mark_dead(lane)
                dead += 1
                hosts[lane.host] = {"state": "failed",
                                    "reason": "health RPC failed"}
                continue
            hosts[lane.host] = snap
            state = snap.get("state", "healthy")
            if _STATE_RANK.get(state, 0) > _STATE_RANK[worst]:
                worst = state
        if dead:
            if dead == len(self._lanes):
                worst = "failed"
            elif _STATE_RANK[worst] < _STATE_RANK["degraded"]:
                worst = "degraded"
        counts = {s: 0 for s in _STATE_ORDER}
        for snap in hosts.values():
            counts[snap.get("state", "healthy")] = \
                counts.get(snap.get("state", "healthy"), 0) + 1
        for s in _STATE_ORDER:
            _obs.GLOBAL_COUNTERS.set("spfft_cluster_hosts",
                                     counts.get(s, 0), state=s)
            _obs.GLOBAL_COUNTERS.set("spfft_cluster_health",
                                     1.0 if s == worst else 0.0,
                                     state=s)
        return {"state": worst, "hosts": hosts,
                "alive": len(self._lanes) - dead,
                "lanes": len(self._lanes), "epoch": self._stamp}

    def metrics_text(self) -> str:
        """The pod ``/metrics``: this process's FULL exposition
        rendered exactly once (pod-level cluster series plus every
        process-global family — compile, faults, SLO, recorder,
        timing, trace — that an in-process lane's own exposition also
        carries), then every alive host's lane-level families with a
        ``host`` label merged in — parsed, not concatenated, so the
        result is one valid exposition document (one HELP/TYPE header
        per family) a scraper consumes directly.

        The merge is IDEMPOTENT: an in-process lane shares this
        process's counter registry, so only its per-executor
        ``spfft_serve_*`` / ``spfft_registry_*`` families federate
        (anything else it renders is a process-global already emitted
        above — re-exporting those once per lane double-counted every
        process-wide series under per-lane ``host`` labels). A remote
        lane's exposition is its own process's facts and merges whole;
        families that already carry a ``host`` label (membership, net)
        keep their own rather than being clobbered with the lane's."""
        self.health()  # refresh the aggregate gauges first
        b = _PromBuilder()
        seen = set()

        def _merge(name, value, labels):
            key = (name, tuple(sorted(labels.items())))
            if key in seen:
                return
            seen.add(key)
            mtype, help_ = METRIC_SPECS.get(name, ("gauge", name))
            b.add(name, mtype, help_, value, labels)

        for (name, labels), value in parse_prometheus_text(
                prometheus_text()).items():
            _merge(name, value, dict(labels))
        for lane in self._lanes:
            if not lane.alive:
                continue
            try:
                text = lane.rpc_metrics_text()
            except HostLaneError:
                self._mark_dead(lane)
                continue
            local = lane.executor is not None
            for (name, labels), value in \
                    parse_prometheus_text(text).items():
                if local and not name.startswith(_LANE_LEVEL_FAMILIES):
                    continue  # an in-process lane's process-globals
                merged = dict(labels)
                merged.setdefault("host", lane.host)
                _merge(name, value, merged)
        return b.text()

    def capture_incident(self, reason: str = "manual",
                         directory: Optional[str] = None
                         ) -> Optional[str]:
        """Pod-wide flight-recorder capture: gather every alive
        REMOTE lane's incident bundle over the wire (in-process lanes
        share this process's journal, contributed once under the
        coordinator's host name) and atomically write ONE
        host-labelled pod bundle with a single merged timeline.
        Returns the written path, or None on failure (counted,
        non-fatal). Registered as the recorder's incident capturer on
        construction, so auto triggers capture the whole pod."""
        from ..obs import recorder as _recorder
        local = self._membership.host
        bundles: Dict[str, dict] = {
            local: _recorder.build_incident_bundle(reason, host=local)}
        for lane in self._lanes:
            if lane.executor is not None or not lane.alive:
                continue  # in-process lanes share the local bundle
            try:
                bundles[lane.host] = lane.rpc_incident(reason)
            except (HostLaneError, ClusterError) as exc:
                bundles[lane.host] = {
                    "error": f"{type(exc).__name__}: {exc}"}
        pod = _recorder.merge_pod_bundle(reason, bundles)
        try:
            pod["health"] = self.health()
        except (ClusterError, HostLaneError):
            pass  # a mid-capture lane death must not lose the bundle
        try:
            path = _recorder.write_bundle(pod, directory=directory)
        except Exception as exc:
            _obs.GLOBAL_COUNTERS.inc(
                "spfft_recorder_incident_failures_total")
            _obs.record_event("incident.capture", reason=reason,
                              outcome=f"failed: {type(exc).__name__}")
            return None
        _obs.GLOBAL_COUNTERS.inc("spfft_recorder_incidents_total",
                                 trigger=reason.split(":", 1)[0])
        _obs.record_event("incident.capture", reason=reason,
                          outcome="written")
        return path

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Close the SPMD lane and every alive lane's executor (remote
        lanes release their client pool; the agent process they front
        is not ours to stop)."""
        if self._closed:
            return
        self._closed = True
        from ..obs import recorder as _recorder
        if getattr(_recorder, "_capturer", None) \
                is self._incident_capturer:
            _recorder.set_incident_capturer(None)
            _recorder.set_health_provider(None)
        self._probe_pool.shutdown(wait=True, cancel_futures=True)
        self._spmd.close()
        for lane in self._lanes:
            if lane.executor is None:
                close = getattr(lane, "close", None)
                if close is not None:
                    close()
            elif lane.alive:
                lane.executor.close()

    def __enter__(self) -> "PodFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _loopback_allgather(rows: List[np.ndarray], index: int):
    """An emulated per-host allgather over precomputed per-host rows:
    host ``index``'s own contribution replaces its row (so a host lying
    about its digest is caught exactly as the real collective would)."""
    def allgather(x):
        out = [np.asarray(r) for r in rows]
        out[index] = np.asarray(x)
        return np.stack(out)
    return allgather


# ---------------------------------------------------------------------------
# Routing-policy simulation (the skewed-load scenario)
# ---------------------------------------------------------------------------

def simulate_routing(policy: str = "p2c", hosts: int = 2,
                     requests: int = 400, arrival_dt: float = 0.75,
                     heavy_cost: float = 8.0, light_cost: float = 1.0,
                     window: int = 32, seed: int = 0) -> Dict[str, object]:
    """Discrete-event skew scenario driving the REAL :func:`load_score`.

    Request ``i`` is heavy (``heavy_cost``) when ``i % hosts == 0``,
    light otherwise — precisely the arrival pattern that aliases every
    heavy request onto host 0 under round-robin (rotating start index
    ``i % hosts``), starving it while the other hosts idle. Each host
    is a single-server FIFO queue on a virtual clock; the signals a
    policy sees at dispatch time are what a live lane would report:
    ``queue_depth`` (requests assigned but not finished) and
    ``device_execute_p50`` (nearest-rank p50 of the last ``window``
    completed costs). Power-of-two-choices samples two hosts and takes
    the lower :func:`load_score`.

    Returns ``{"policy", "assigned", "completed", "ratio"}`` where
    ``completed`` counts per-host requests finished inside the arrival
    horizon and ``ratio`` is busiest/least-busy completed — the
    acceptance metric (rr ≥ 4, p2c ≤ 2 on the default scenario).
    """
    if policy not in ("p2c", "rr"):
        raise InvalidParameterError(
            f"policy must be 'p2c' or 'rr', got {policy!r}")
    rng = random.Random(seed)
    free_at = [0.0] * hosts           # server-busy-until, per host
    done: List[List[Tuple[float, float]]] = [[] for _ in range(hosts)]
    assigned = [0] * hosts

    def signals(h: int, now: float) -> Dict[str, float]:
        depth = sum(1 for t1, _ in done[h] if t1 > now)
        finished = sorted(t1 for t1, _ in done[h] if t1 <= now)
        costs = [c for t1, c in done[h] if t1 <= now]
        if costs:
            costs = costs[-window:]
            costs.sort()
            p50 = costs[(len(costs) - 1) // 2]
        else:
            p50 = 0.0
        del finished
        return {"queue_depth": depth, "device_execute_p50": p50}

    for i in range(requests):
        now = i * arrival_dt
        cost = heavy_cost if i % hosts == 0 else light_cost
        if policy == "rr" or hosts == 1:
            h = i % hosts
        else:
            a, b = rng.sample(range(hosts), 2)
            h = min((a, b),
                    key=lambda x: (load_score(signals(x, now)), x))
        start = max(now, free_at[h])
        free_at[h] = start + cost
        done[h].append((free_at[h], cost))
        assigned[h] += 1

    horizon = requests * arrival_dt
    completed = [sum(1 for t1, _ in d if t1 <= horizon) for d in done]
    ratio = max(completed) / max(1, min(completed))
    return {"policy": policy, "assigned": assigned,
            "completed": completed, "ratio": ratio}


# ---------------------------------------------------------------------------
# CLI: --smoke (2-host loopback pod) and --simulate (routing scenario)
# ---------------------------------------------------------------------------

def _run_simulate(seed: int = 0) -> Dict[str, object]:
    rr = simulate_routing("rr", seed=seed)
    p2c = simulate_routing("p2c", seed=seed)
    speedup = rr["ratio"] / max(p2c["ratio"], 1e-9)
    return {"rr_ratio": rr["ratio"], "p2c_ratio": p2c["ratio"],
            "rr_completed": rr["completed"],
            "p2c_completed": p2c["completed"],
            "imbalance_reduction_x": speedup}


def _run_smoke(seed: int = 0, device=None) -> int:
    """The 2-host loopback pod smoke: a mixed single-device +
    distributed trace, checked for bit-exactness against direct plan
    calls, balanced routing, one trace id across the host boundary with
    valid parent/child nesting, a merged /metrics document that
    re-parses, and survivor serving after a lane death. ``device`` is
    the plans' (None: the card). Returns a process exit code."""
    import torch

    from ..benchmark import cutoff_stick_triplets
    from ..parallel import make_distributed_plan, make_mesh
    from ..types import TransformType
    from ..utils.workloads import (even_plane_split,
                                   round_robin_stick_partition)
    from .registry import PlanRegistry, signature_for

    failures: List[str] = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    n = 10
    dims = (n, n, n)
    trip = cutoff_stick_triplets(n, n, n, 0.9, hermitian=False)
    rng = np.random.default_rng(seed)
    shards = 2

    _obs.enable()
    tracer = _obs.GLOBAL_TRACER
    tracer.reset()
    tracer.set_sample_rate(1.0)

    lanes = []
    local_plan = None
    local_sig = None
    dist_sig = None
    dplan0 = None
    for host in ("h0", "h1"):
        reg = PlanRegistry(store=False)
        sig, plan = reg.get_or_build(TransformType.C2C, *dims, trip,
                                     precision="double", device=device)
        parts = round_robin_stick_partition(trip, dims, shards)
        planes = even_plane_split(dims[2], shards)
        dplan = make_distributed_plan(TransformType.C2C, *dims, parts,
                                      planes,
                                      mesh=make_mesh(shards, device),
                                      precision="double")
        dsig = signature_for(TransformType.C2C, *dims, trip,
                             precision="double", device_count=shards)
        reg.put(dsig, dplan)
        lanes.append((host, ServeExecutor(reg)))
        if local_plan is None:
            local_plan, local_sig, dist_sig, dplan0 = \
                plan, sig, dsig, dplan

    def cvalues(k):
        return rng.standard_normal(k) + 1j * rng.standard_normal(k)

    pod = PodFrontend(lanes, policy="p2c", seed=seed)
    try:
        # -- mixed traffic: bit-exact vs direct plan calls -------------
        singles = []
        for _ in range(24):
            v = cvalues(len(trip))
            singles.append((v, pod.submit_backward(local_sig, v)))
        # the distributed request in the stacked layout of the door
        dvalues = dplan0.shard_values(
            [cvalues(p.num_values) for p in dplan0.dist_plan.shard_plans])
        dfut = pod.submit(dist_sig, dvalues)
        for v, fut in singles:
            check(torch.equal(fut.result(timeout=120),
                              local_plan.backward(v)),
                  "single-device result not bit-exact vs direct plan")
        check(torch.equal(dfut.result(timeout=120),
                          dplan0.backward(dvalues)),
              "distributed result not bit-exact vs direct plan")

        # -- balanced routing ------------------------------------------
        comp = [lane.executor.metrics.snapshot()["completed"]
                for lane in pod._lanes]
        check(all(c >= 1 for c in comp),
              f"routing not balanced: per-host completed {comp}")

        # -- one trace id end-to-end, valid nesting --------------------
        check(tracer.open_count() == 0,
              f"{tracer.open_count()} unclosed spans: "
              f"{tracer.open_names()[:8]}")
        spans = [e for e in tracer.events()
                 if isinstance(e, _obs.Span)]
        roots = [s for s in spans if s.name == "cluster.request"]
        check(len(roots) == 25,
              f"expected 25 cluster.request roots, got {len(roots)}")
        by_id = {s.span_id: s for s in spans}
        crossed = 0
        for s in spans:
            if s.name in ("serve.request", "cluster.spmd_execute"):
                parent = by_id.get(s.parent_id)
                check(parent is not None and
                      parent.name == "cluster.request",
                      f"{s.name} span has no cluster.request parent")
                check(parent is None or
                      s.trace_id == parent.trace_id,
                      f"{s.name} trace id differs from its root")
                crossed += 1
        check(crossed >= 25,
              f"only {crossed} spans crossed the host boundary")

        # -- merged /metrics parses, host-labelled ---------------------
        parsed = _obs.parse_prometheus_text(pod.metrics_text())
        hosts_seen = {dict(labels).get("host")
                      for (name, labels) in parsed
                      if name == "spfft_serve_completed_total"}
        check({"h0", "h1"} <= hosts_seen,
              f"merged exposition missing hosts: {hosts_seen}")
        check(any(name == "spfft_cluster_routed_total"
                  for (name, _) in parsed),
              "merged exposition lacks pod-level cluster series")
        health = pod.health()
        check(health["state"] == "healthy",
              f"pod not healthy: {health['state']}")

        # -- lane death: degraded pod, survivors serve -----------------
        pod.kill_host("h1")
        check(pod.health()["state"] == "degraded",
              "pod not degraded after lane death")
        v = cvalues(len(trip))
        got = pod.submit_backward(local_sig, v).result(timeout=120)
        check(torch.equal(got, local_plan.backward(v)),
              "survivor host result not bit-exact after lane death")
        check(tracer.open_count() == 0,
              "unclosed spans after lane-death phase")
    finally:
        pod.close()
        for _, executor in lanes:
            executor.close()
        _obs.disable()

    sim = _run_simulate(seed)
    check(sim["rr_ratio"] >= 4.0,
          f"rr skew scenario too mild: ratio {sim['rr_ratio']:.2f}")
    check(sim["p2c_ratio"] <= 2.0,
          f"p2c did not balance: ratio {sim['p2c_ratio']:.2f}")

    for msg in failures:
        print(f"cluster-smoke FAIL: {msg}")
    if failures:
        return 1
    print(f"cluster-smoke: 25 requests bit-exact across a 2-host pod on "
          f"{local_plan.device} (routing completed={comp}), rr ratio "
          f"{sim['rr_ratio']:.2f} vs p2c {sim['p2c_ratio']:.2f}")
    print("CLUSTER SMOKE GREEN")
    return 0


def main(argv=None) -> int:
    import argparse
    import json as _json

    ap = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.serve.cluster",
        description="Pod frontend smoke + routing-policy simulation.")
    ap.add_argument("--smoke", action="store_true",
                    help="run the 2-host loopback pod smoke")
    ap.add_argument("--simulate", action="store_true",
                    help="print rr-vs-p2c routing ratios as JSON")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the smoke's plans' device (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.simulate:
        print(_json.dumps(_run_simulate(args.seed), indent=2))
        return 0
    if args.smoke:
        from ..errors import DeviceError
        from ..plan import resolve_device
        try:
            device = resolve_device(args.device)
        except DeviceError as exc:
            print(f"cluster-smoke: {exc}")
            return 1
        return _run_smoke(args.seed, device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
