"""Concurrent batching executor: futures in, batched buckets out (the
port of ``spfft_tpu/serve/executor.py``).

The reference's throughput lever for many independent transforms is its
multi-transform scheduler (reference:
src/spfft/multi_transform_internal.hpp:47-145), reproduced as
``spfft_tpu_torch.multi``. This module turns it into a request-driven
serving layer: callers ``submit(signature, values)`` from any number of
threads and get ``concurrent.futures.Future``s back; a single dispatcher
thread buckets same-signature requests and executes full buckets through
the plan's batched route (``backward_batched`` / ``forward_batched``:
one launch of each kernel for the whole bucket — the fused z kernels'
batched grids of ``csrc/fused_fft.cu``, one xy launch over every plane
of the bucket, or on a ``fused=False`` plan the batched gathers of
``csrc/gather.cu`` and one ``pdft_last``), stragglers through the
ordinary serial path.

The dispatch path:

* **Per-signature pending shards** — requests land in a shard keyed by
  ``(signature, kind, scaling)``; bucket formation pops one shard's
  lanes instead of re-scanning one global queue per take.
* **Priority lanes + EDF** — ``submit(..., priority="high")`` enters a
  shard's high lane, served before ANY normal-lane work; within each
  lane requests order earliest-deadline-first (deadline-less requests
  keep FIFO order behind every deadlined one). A forming normal bucket
  closes its batching window early when a high-priority request arrives
  for another signature or a queued deadline is about to expire.
* **Adaptive batch-shape pinning** — a per-shard observer watches
  batched bucket sizes; once the same size repeats ``pin_after``
  consecutive times, that EXACT shape is pinned (per-signature LRU,
  ``max_pinned_shapes`` entries) and buckets of that size dispatch with
  ZERO pad rows. One bucket before the pin lands, the exact shape runs
  once on a background thread (prewarm-on-pin). Shape churn never pins
  and falls back to the pow2 ladder (``multi.planned_batch_size``).
* **Pinned staging buffers + pipelining** — the rows of a batched bucket
  of host payloads are coerced on the host and stacked into a reusable
  PINNED host buffer per (shard, shape), which goes to the card in one
  ``non_blocking`` copy; the buffer returns to its free list only after
  a CUDA event recorded behind that copy has completed, so it is never
  rewritten while the copy may still read it. The in-flight window is
  one deeper than the device pool on the card, so the host stacks
  bucket N+1 while the card runs bucket N.

Synchronisation: a bucket's completion is a ``torch.cuda.Event``
recorded on the plan's stream right after the bucket's launches
(:func:`~spfft_tpu_torch.timing.ready_events`), waited on with
``Event.synchronize`` — never a device-wide synchronize, which would
also wait for the bucket the pipeline launched after it.

Failure is a first-class surface:

* **Bucket-failure isolation** — a batched bucket that raises (staging,
  dispatch or materialisation) falls back to per-request serial
  re-execution (counted, ``record_bucket_fallback``), so one poisoned
  request fails alone and its healthy co-batched neighbours still
  return bit-exact results. Each request draws on a bounded
  PER-PRIORITY retry budget (``retry_budget``; default high=2,
  normal=1): transient failures (``faults.is_transient``) that persist
  through the budget surface as ``RetryExhaustedError`` carrying the
  cause; permanent failures surface immediately as themselves.
* **Device quarantine** — per-device consecutive-failure accounting on
  the round-robin pool; a device crossing ``quarantine_after`` failures
  is quarantined with exponential-backoff probation (one canary request
  re-admits it on success, doubles the backoff on failure). An empty
  pool fails requests with ``NoHealthyDeviceError``. A real CUDA fault
  (an illegal address) leaves the context unusable: every later request
  on that card fails too, the quarantine empties the pool, and requests
  fail with ``NoHealthyDeviceError`` — the end state, as in the JAX
  package; no recovery is attempted.
* **Crash-proof dispatch** — the dispatcher thread runs under a
  supervisor: an exception escaping the per-bucket handling fails that
  bucket's futures, flushes in-flight work, and restarts the loop up to
  ``max_dispatch_restarts`` times; past the budget every queued future
  fails with ``ExecutorCrashedError``. Health (healthy / degraded /
  draining / failed) is exposed via ``ServeMetrics.health()`` /
  :meth:`ServeExecutor.health`.
* **Deterministic fault injection** — every path above is driven
  through ``faults.FaultPlan`` checkpoints (stage / dispatch /
  materialise / loop, per pool device).

Correctness contract: any interleaving of concurrent requests produces
results BIT-IDENTICAL to running each request alone on its plan
(``plan.backward`` / ``plan.forward``): (1) requests only share a
bucket when their signatures are equal, and equal signatures resolve to
the same plan object; (2) every kernel's batched grid computes each row
exactly as its single launch does (the plans' batched tests hold each
band to the single call bit for bit), so pad rows (repeats of row 0)
and the choice of batch shape cannot perturb the live rows; (3) staged
rows carry exactly the per-row coerced layout
(``plan.batch_row_template``) at the plan's own dtype. Recovery
re-executions run the same serial call the oracle does.

Observability (``spfft_tpu_torch.obs``): when tracing is enabled, every
sampled request carries a ``RequestTrace`` — spans for all eight
pipeline stages (``serve.submit`` / ``serve.queue_wait`` /
``serve.bucket_formation`` / ``serve.stage`` / ``serve.dispatch`` /
``serve.device_execute`` / ``serve.materialise`` / ``serve.resolve``)
on per-lane and per-device tracks, with retry / fallback / quarantine
annotations; every resolution path settles the request's whole trace.

Flow control: a fixed-capacity queue whose overflow REJECTS with
``QueueFullError`` (after reaping already-expired deadlined requests),
per-request deadlines that expire queued work with
``DeadlineExpiredError`` before it reaches the card, and
``batching=False`` (or a fusion-ineligible bucket) degrading to serial
per-request dispatch.

Knobs: every tunable above lives in ONE typed, bounds-clamped
:class:`~spfft_tpu_torch.control.config.ServeConfig` the executor reads
on every use (a controller can retune a live executor; the change
applies from the next bucket, bit-exact by the contract above).
"""

from __future__ import annotations

import collections
import heapq
import itertools
import math
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..control.config import KNOB_SPECS, ServeConfig
from ..errors import (DeadlineExpiredError, DeviceError,
                      DistributedPlanUnsupportedError, ExecuteTimeoutError,
                      ExecutorCrashedError, InvalidParameterError,
                      NoHealthyDeviceError, QueueFullError,
                      RetryExhaustedError, ServeError)
from ..multi import fusion_eligible, planned_batch_size
from ..plan import TransformPlan
from ..timing import ready_events, wait_events, wait_ready
from ..types import Scaling
from .faults import FaultPlan, attributes_device, is_transient
from .metrics import ServeMetrics
from .registry import PLAN_MANIFEST_ENV, PlanRegistry, PlanSignature


# Knob defaults live in ONE place: the control config's KNOB_SPECS
# (spfft_tpu_torch/control/config.py), which also declares each knob's
# hard bounds and driving telemetry signal. The aliases below keep the
# JAX package's import surface.
DEFAULT_BATCH_WINDOW = KNOB_SPECS["batch_window"].default
DEFAULT_MAX_BATCH = KNOB_SPECS["max_batch"].default
DEFAULT_MAX_QUEUE = KNOB_SPECS["max_queue"].default
DEFAULT_PIN_AFTER = KNOB_SPECS["pin_after"].default
DEFAULT_MAX_PINNED = KNOB_SPECS["max_pinned_shapes"].default
DEFAULT_QUARANTINE_AFTER = KNOB_SPECS["quarantine_after"].default
DEFAULT_QUARANTINE_BACKOFF = KNOB_SPECS["quarantine_backoff"].default

#: Ceiling on the exponential probation backoff.
QUARANTINE_BACKOFF_CAP = 60.0

#: Dispatch-loop restarts the supervisor attempts before declaring the
#: executor failed and rejecting everything queued.
DEFAULT_MAX_RESTARTS = 3

_PRIORITIES = ("normal", "high")

#: Per-priority bounded-retry budget for transient failures. High-lane
#: requests are the ones callers marked latency/SLO-critical, so they
#: get one more shot at riding out a transient than normal work; a
#: normal request gets a single bounded retry.
#: Override per executor with ``retry_budget={"normal": n, "high": m}``
#: (missing classes fall back to these defaults; 0 disables retries for
#: a class — first failure surfaces immediately).
DEFAULT_RETRY_BUDGET = {"normal": 1, "high": 2}


class _Request:
    __slots__ = ("key", "plan", "kind", "values", "scaling", "deadline",
                 "priority", "seq", "future", "enqueued_at", "trace")

    def __init__(self, key, plan, kind, values, scaling, deadline,
                 priority, seq):
        self.key = key
        self.plan = plan
        self.kind = kind
        self.values = values
        self.scaling = scaling
        self.deadline = deadline
        self.priority = priority
        self.seq = seq
        self.future: Future = Future()
        self.enqueued_at = time.monotonic()
        #: obs.RequestTrace when tracing is on AND this request was
        #: sampled; None otherwise (the disabled-path cost is this
        #: attribute staying None).
        self.trace = None


def _dev_track(slot) -> str:
    """Trace track name for a pool slot (one track per pool device)."""
    return f"device:{slot.index}" if slot is not None else "device:0"


class _BucketTrace:
    """Span bookkeeping for one dispatched bucket. Bucket-level stages
    (formation/stage/dispatch/device-execute/materialise) are recorded
    ONCE per bucket — parented under the first traced member's request
    root, carrying every member's trace id in ``member_trace_ids`` — so
    an 8-row fused bucket costs 5 spans, not 40. ``end_all`` closes
    whatever is still open with an error status; every failure path in
    the executor calls it BEFORE resolving member futures, so bucket
    spans always nest inside their parent request span."""

    __slots__ = ("tracer", "trace_id", "parent", "ids", "open")

    def __init__(self, tracer, traced):
        first = traced[0].trace
        self.tracer = tracer
        self.trace_id = first.trace_id
        self.parent = first.root
        self.ids = [r.trace.trace_id for r in traced]
        self.open = {}

    def begin(self, name, track=None, args=None):
        a = {"member_trace_ids": list(self.ids)}
        if args:
            a.update(args)
        # span: closed-by(_BucketTrace.end_all)
        self.open[name] = self.tracer.begin(
            name, trace_id=self.trace_id, parent=self.parent,
            track=track, args=a)

    def end(self, name, status="ok", error=None):
        sp = self.open.pop(name, None)
        if sp is not None:
            self.tracer.finish(sp, status=status, error=error)

    def end_all(self, status="ok", error=None):
        for name in list(self.open):
            self.end(name, status, error)


class _Shard:
    """Pending work + batch-shape observer for one (signature, kind,
    scaling) key. Lanes are heaps of ``(deadline-or-inf, seq, request)``
    — EDF within the lane, FIFO among deadline-less requests. The shard
    survives idle periods so its observer state (and the signature's
    pinned shapes) persist across traffic gaps."""

    __slots__ = ("key", "plan", "high", "normal", "last_size", "streak",
                 "row_template", "template_ready")

    def __init__(self, key, plan):
        self.key = key
        self.plan = plan
        self.high: List[Tuple[float, int, _Request]] = []
        self.normal: List[Tuple[float, int, _Request]] = []
        self.last_size = 0
        self.streak = 0
        self.row_template = None
        self.template_ready = False

    def pending(self) -> bool:
        return bool(self.high or self.normal)

    def head_rank(self):
        """Scheduling rank of this shard's most urgent request:
        ``(lane, deadline-or-inf, seq)`` — high lane beats normal,
        then EDF, then arrival order. None when empty."""
        if self.high:
            return (0, self.high[0][0], self.high[0][1])
        if self.normal:
            return (1, self.normal[0][0], self.normal[0][1])
        return None


class _DeviceSlot:
    """Health accounting for one pool device: consecutive-failure count,
    quarantine state and the exponential probation backoff. Mutated only
    under the executor's pool lock."""

    __slots__ = ("device", "index", "failures", "state", "until",
                 "backoff")

    def __init__(self, device, index, backoff):
        self.device = device
        self.index = index
        self.failures = 0
        self.state = "healthy"   # healthy | quarantined | probation
        self.until = 0.0         # when a quarantined slot is probe-able
        self.backoff = backoff


class ServeExecutor:
    """One dispatcher thread over bounded per-signature request shards.

    ``registry`` resolves signatures to plans (requests for unknown
    signatures are rejected at submit time — a server warms its shapes
    up front; see ``PlanRegistry.warmup``). Use as a context manager or
    call :meth:`close` to drain and stop.

    ``autostart=False`` defers the dispatcher thread until
    :meth:`start` — used by tests (and pre-warm scripts) to stage a
    queue deterministically before any dispatch happens.

    Failure knobs: ``quarantine_after`` / ``quarantine_backoff`` control
    the device-pool quarantine, ``max_dispatch_restarts`` bounds the
    crash supervisor, ``retry_budget`` sets the per-priority transient
    retry budget (``{"normal": 1, "high": 2}`` by default — the high
    lane gets one more attempt), ``fault_plan`` arms deterministic
    fault injection (see :mod:`~spfft_tpu_torch.serve.faults`),
    ``prewarm_on_pin`` toggles the background exact-shape run one
    bucket before a pin lands.

    ``devices``: ``None`` runs every request on its plan's own device;
    ``"all"`` spreads requests round-robin over every CUDA device
    (:class:`~spfft_tpu_torch.errors.DeviceError` where there is none);
    a list of devices (torch devices or their names) makes that list the
    pool. A plan runs on a pool device through its ``device=`` (its
    tables copied there once).
    """

    def __init__(self, registry: PlanRegistry,
                 batch_window: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 batching: bool = True,
                 devices=None,
                 metrics: Optional[ServeMetrics] = None,
                 pin_after: Optional[int] = None,
                 max_pinned_shapes: Optional[int] = None,
                 pipeline_depth: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 quarantine_after: Optional[int] = None,
                 quarantine_backoff: Optional[float] = None,
                 max_dispatch_restarts: int = DEFAULT_MAX_RESTARTS,
                 retry_budget: Optional[Dict[str, int]] = None,
                 prewarm_on_pin: bool = True,
                 autostart: bool = True,
                 config: Optional[ServeConfig] = None,
                 prewarm_manifest: Optional[str] = None):
        # Knob resolution: every tunable lives in ONE typed
        # ServeConfig the control config owns. Explicit constructor
        # arguments are validated (the historical error contract) and
        # override the config; None defers to the config's value —
        # which is the declared default, the SPFFT_TPU_SERVE_CONFIG
        # boot artifact, or whatever a live controller has retuned it
        # to. The dispatcher reads the knobs through the config on
        # every use, so a controller's set() applies from the next
        # bucket (hot-swap under the config's lock).
        if max_batch is not None and max_batch < 1 \
                or max_queue is not None and max_queue < 1:
            raise InvalidParameterError(
                "max_batch and max_queue must be >= 1")
        if pipeline_depth is not None and pipeline_depth < 1:
            raise InvalidParameterError("pipeline_depth must be >= 1")
        if pin_after is not None and pin_after < 0 \
                or max_pinned_shapes is not None \
                and max_pinned_shapes < 1:
            raise InvalidParameterError(
                "pin_after must be >= 0 and max_pinned_shapes >= 1")
        if quarantine_after is not None and quarantine_after < 0 \
                or quarantine_backoff is not None \
                and quarantine_backoff <= 0.0 \
                or max_dispatch_restarts < 0:
            raise InvalidParameterError(
                "quarantine_after and max_dispatch_restarts must be "
                ">= 0, quarantine_backoff > 0")
        self.config = config if config is not None else ServeConfig.boot()
        overrides = {
            "batch_window": batch_window, "max_batch": max_batch,
            "max_queue": max_queue, "pin_after": pin_after,
            "max_pinned_shapes": max_pinned_shapes,
            "pipeline_depth": pipeline_depth,
            "quarantine_after": quarantine_after,
            "quarantine_backoff": quarantine_backoff,
        }
        for name, value in overrides.items():
            if value is not None:
                self.config.set(name, value, source="init",
                                reason="constructor override")
        budget = dict(DEFAULT_RETRY_BUDGET)
        if retry_budget:
            unknown = set(retry_budget) - set(_PRIORITIES)
            if unknown:
                raise InvalidParameterError(
                    f"retry_budget classes must be in {_PRIORITIES}, "
                    f"got {sorted(unknown)}")
            if any(int(v) < 0 for v in retry_budget.values()):
                raise InvalidParameterError(
                    "retry_budget values must be >= 0")
            budget.update({k: int(v) for k, v in retry_budget.items()})
        self._retry_budget = budget
        self.registry = registry
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # The device pool: ``None`` keeps every execution on the plan's
        # own device; ``"all"`` spreads requests round-robin over every
        # CUDA device — batched buckets land whole on one device, serial
        # buckets fan their requests across the pool.
        if devices == "all":
            if not torch.cuda.is_available():
                raise DeviceError(
                    "devices='all' pools every CUDA device, and there is "
                    "none")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self._devices = [torch.device(d) for d in devices] \
            if devices else [None]
        self._rotor = 0          #: guarded by _pool_lock
        self._auto_extra: Optional[int] = None
        self._batching = bool(batching)
        self._faults = fault_plan
        self._max_restarts = int(max_dispatch_restarts)
        self._prewarm_on_pin = bool(prewarm_on_pin)
        self._pool_lock = threading.Lock()
        #: guarded by _pool_lock
        self._slots = [_DeviceSlot(d, i, self._q_backoff)
                       for i, d in enumerate(self._devices)]
        self._shards: Dict[tuple, _Shard] = {}  #: guarded by _cv
        self._pending = 0        #: guarded by _cv
        self._high_pending = 0   #: guarded by _cv
        # GIL-atomic arrival counter: requests are stamped BEFORE the
        # queue lock so Future/request construction never extends the
        # lock hold; heap ties only need uniqueness + rough arrival
        # order, not lock-exact monotonicity
        self._seq = itertools.count(1)
        # per-signature pinned exact batch shapes (LRU); dispatcher
        # thread only, no lock needed
        self._pins: Dict[PlanSignature,
                         "collections.OrderedDict[int, None]"] = {}
        # staging buffer free-lists, keyed by shard key (signature,
        # kind, scaling): [host buffer of max_batch rows, the events
        # behind its last copy to the card]; a bucket of b rows stages
        # into buf[:b]. Dropped with the signature's plan (registry
        # eviction) and on close
        self._staging: Dict[tuple, List[list]] = {}
        self._staging_lock = threading.Lock()
        registry.add_evict_listener(self._drop_staging)
        # prewarm-on-pin background runs, keyed (shard key, shape)
        self._prewarm_threads: Dict[tuple, threading.Thread] = {}
        # supervisor state: buckets the dispatcher holds outside the
        # shards (forming + in-flight) so a crash can fail their
        # futures instead of stranding them in dead local variables
        self._inflight: "collections.deque" = collections.deque()
        self._forming: Optional[List[_Request]] = None
        self._restarts = 0       #: guarded by _cv
        self._failed = False     #: guarded by _cv
        self._cv = threading.Condition()
        self._closed = False     #: guarded by _cv
        self._thread: Optional[threading.Thread] = None  #: guarded by _cv
        # zero-cold-start boot: prewarm every manifest-listed plan
        # artifact (load + one run) BEFORE the dispatcher accepts work
        import os as _os
        manifest = prewarm_manifest \
            if prewarm_manifest is not None \
            else _os.environ.get(PLAN_MANIFEST_ENV)
        if manifest:
            self.registry.warmup_manifest(manifest, compile=True)
        if autostart:
            self.start()

    # -- knobs (hot-swappable: every read goes through the config) ---------
    @property
    def _batch_window(self) -> float:
        return self.config.batch_window

    @property
    def _max_batch(self) -> int:
        return self.config.max_batch

    @property
    def _max_queue(self) -> int:
        return self.config.max_queue

    @property
    def _pin_after(self) -> int:
        return self.config.pin_after

    @property
    def _max_pinned(self) -> int:
        return self.config.max_pinned_shapes

    @property
    def _pipeline_depth(self) -> Optional[int]:
        depth = self.config.pipeline_depth
        return None if depth == 0 else depth

    @property
    def _q_after(self) -> int:
        return self.config.quarantine_after

    @property
    def _q_backoff(self) -> float:
        return self.config.quarantine_backoff

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Start the supervised dispatcher thread (idempotent)."""
        with self._cv:
            if self._closed:
                raise ServeError("executor is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run_dispatcher,
                    name="spfft-serve-dispatcher", daemon=True)
                self._thread.start()
        self._push_health()

    def close(self, drain: bool = True) -> None:
        """Stop accepting work and shut the dispatcher down. With
        ``drain`` (default) queued requests execute first; otherwise
        they fail with ``ServeError``. Either way, EVERY still-pending
        future is resolved before close returns — no caller is ever
        left blocked on a future that cannot complete."""
        dropped: List[_Request] = []
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain or self._failed:
                for shard in self._shards.values():
                    for lane in (shard.high, shard.normal):
                        dropped.extend(req for _, _, req in lane)
                        lane.clear()
                self._pending = 0
                self._high_pending = 0
            self._cv.notify_all()
            thread = self._thread
        self._push_health()
        self._fail_requests(dropped,
                            ServeError("executor closed before dispatch"))
        if thread is None:
            # never started: drain synchronously so no future is left
            # forever-pending
            self._drain_once()
        else:
            thread.join()
        # a closed executor launches nothing more: wait for the
        # prewarm-on-pin runs still going
        for th in list(self._prewarm_threads.values()):
            th.join()
        # defensive final sweep — anything a crashed/raced dispatcher
        # left behind resolves with a typed error rather than hanging
        self._fail_all_pending(ServeError("executor closed"))
        # nothing is in flight any more: let the pinned staging go
        with self._staging_lock:
            self._staging.clear()

    def __enter__(self) -> "ServeExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- fault/health plumbing ---------------------------------------------
    def inject_faults(self, fault_plan: Optional[FaultPlan]) -> None:
        """Arm (replace, or clear with None) the fault-injection plan.
        The deterministic test/bench seam — production servers leave it
        unset and every check is a no-op attribute read."""
        self._faults = fault_plan

    def _check_fault(self, site: str, device: Optional[int] = None):
        plan = self._faults
        if plan is not None:
            plan.check(site, device)

    def _push_health(self) -> None:
        """Recompute the lifecycle state and push it into the metrics
        sink: failed > draining > degraded (restarted dispatcher or any
        non-healthy pool device) > healthy."""
        with self._cv:
            failed, closed = self._failed, self._closed
            restarts = self._restarts
        if failed:
            state = "failed"
        elif closed:
            state = "draining"
        else:
            with self._pool_lock:
                sick = any(s.state != "healthy" for s in self._slots)
            state = "degraded" if (restarts or sick) else "healthy"
        self.metrics.record_health(state)

    def health(self) -> Dict:
        """The :meth:`ServeMetrics.health` snapshot plus live per-device
        pool state (index, health state, consecutive failures, current
        probation backoff) and the current knob values (the config a
        controller may be retuning live)."""
        snap = self.metrics.health()
        with self._pool_lock:
            snap["devices"] = [
                {"index": s.index, "state": s.state,
                 "consecutive_failures": s.failures,
                 "backoff_s": s.backoff} for s in self._slots]
        snap["config"] = self.config.snapshot()
        return snap

    def _fail_requests(self, reqs, exc: BaseException) -> None:
        """Resolve ``reqs``' futures with ``exc`` (skipping any already
        resolved) and record the failures. Never called under the queue
        lock."""
        done = time.monotonic()
        for req in reqs:
            if req.future.done():
                continue
            self.metrics.record_request_done(done - req.enqueued_at,
                                             failed=True,
                                             priority=req.priority)
            req.future.set_exception(exc)
            if req.trace is not None:
                # failure paths settle the WHOLE trace: any open stage
                # span and the request root close with error status
                req.trace.close("error", type(exc).__name__)

    def _fail_all_pending(self, exc: BaseException) -> None:
        """Pop EVERYTHING still queued and fail it with ``exc`` — the
        supervisor's give-up path and close()'s final sweep."""
        with self._cv:
            dropped: List[_Request] = []
            for shard in self._shards.values():
                for lane in (shard.high, shard.normal):
                    dropped.extend(req for _, _, req in lane)
                    lane.clear()
            self._pending = 0
            self._high_pending = 0
            self._cv.notify_all()
        self._fail_requests(dropped, exc)

    # -- submission --------------------------------------------------------
    def submit(self, signature: PlanSignature, values,
               kind: str = "backward",
               scaling: Scaling = Scaling.NONE,
               timeout: Optional[float] = None,
               priority: str = "normal",
               trace_ctx=None) -> Future:
        """Queue one transform request; returns its Future.

        ``trace_ctx`` is an optional propagated ``obs.TraceContext``
        (a pod frontend's submit span): when given and tracing is on,
        this request is traced unconditionally — sampling already
        happened on the frontend — with the remote span as the root's
        parent, so one trace id spans the host boundary.

        ``kind`` is ``"backward"`` (values -> space) or ``"forward"``
        (space -> values, with ``scaling``). ``timeout`` (seconds) sets
        a deadline: requests still queued when it elapses fail with
        ``DeadlineExpiredError`` instead of executing, and queued
        requests are served earliest-deadline-first within their lane.
        ``priority`` is ``"normal"`` or ``"high"`` — high-lane requests
        are served before any normal-lane work and preempt a forming
        normal bucket's batching window. Raises ``QueueFullError``
        when the bounded queue is at capacity with LIVE requests
        (already-expired deadlined requests are reaped first and fail
        with ``DeadlineExpiredError``, so dead work never causes
        backpressure) and ``InvalidParameterError`` for signatures the
        registry does not hold."""
        if kind not in ("backward", "forward"):
            raise InvalidParameterError(
                f"kind must be 'backward' or 'forward', got {kind!r}")
        if priority not in _PRIORITIES:
            raise InvalidParameterError(
                f"priority must be 'normal' or 'high', got {priority!r}")
        scaling = Scaling(scaling)
        plan = self.registry.get(signature)
        if plan is None:
            raise InvalidParameterError(
                f"signature not in registry (warm up first): {signature}")
        if not isinstance(plan, TransformPlan):
            # Reject at the door, typed — the pool/batching/staging
            # machinery is built around LOCAL plans (one device per
            # request); a distributed plan spans its own mesh and pins
            # its own placement.
            raise DistributedPlanUnsupportedError(
                f"ServeExecutor serves local TransformPlans only; "
                f"signature {signature} resolves to a "
                f"{type(plan).__name__}. Submit distributed plans "
                f"through spfft_tpu_torch.serve.PodFrontend or run them "
                f"directly (plan.backward/forward).")
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        key = (signature, kind, scaling)
        req = _Request(key, plan, kind, values, scaling, deadline,
                       priority, next(self._seq))
        # request tracing: off -> one boolean read; on -> the sampled
        # fraction of requests get a RequestTrace whose queue_wait span
        # MUST begin before the request becomes visible to the
        # dispatcher (which finishes it when the request is popped)
        rt = None
        if _obs.active() and (trace_ctx is not None
                              or _obs.GLOBAL_TRACER.sample()):
            rt = _obs.RequestTrace(
                _obs.GLOBAL_TRACER, priority, ctx=trace_ctx,
                args={"kind": kind, "scaling": scaling.value})
            rt.begin("serve.submit")
            req.trace = rt
        entry = (deadline if deadline is not None else math.inf,
                 req.seq, req)
        purged: List[_Request] = []
        if rt is not None:
            rt.finish("serve.submit")
            rt.begin("serve.queue_wait")
        try:
            with self._cv:
                if self._closed:
                    raise ServeError("executor is closed")
                if self._failed:
                    raise ServeError(
                        "executor dispatch loop has failed (crashed past "
                        "its restart budget)")
                if self._pending >= self._max_queue:
                    purged = self._purge_expired_locked(time.monotonic())
                if self._pending >= self._max_queue:
                    full = True
                else:
                    full = False
                    shard = self._shards.get(key)
                    if shard is None:
                        shard = self._shards[key] = _Shard(key, plan)
                    lane = shard.high if priority == "high" \
                        else shard.normal
                    heapq.heappush(lane, entry)
                    self._pending += 1
                    if priority == "high":
                        self._high_pending += 1
                    depth = self._pending
                    self._cv.notify_all()
        except ServeError as exc:
            if rt is not None:
                rt.close("error", type(exc).__name__)
            raise
        # future resolution + metric recording outside the queue lock
        for dead in purged:
            self.metrics.record_deadline_expired(purged=True)
            if not dead.future.done():
                dead.future.set_exception(DeadlineExpiredError(
                    "deadline expired in queue (reaped by the "
                    "backpressure sweep before dispatch)"))
            if dead.trace is not None:
                dead.trace.close("error", "DeadlineExpiredError")
        if full:
            self.metrics.record_reject_queue_full()
            if rt is not None:
                rt.close("error", "QueueFullError")
            raise QueueFullError(
                f"serving queue full ({self._max_queue} requests) — "
                f"backpressure: retry later or raise max_queue")
        self.metrics.record_enqueue(depth)
        return req.future

    def submit_backward(self, signature, values,
                        timeout: Optional[float] = None,
                        priority: str = "normal") -> Future:
        return self.submit(signature, values, "backward", timeout=timeout,
                           priority=priority)

    def submit_forward(self, signature, space,
                       scaling: Scaling = Scaling.NONE,
                       timeout: Optional[float] = None,
                       priority: str = "normal") -> Future:
        return self.submit(signature, space, "forward", scaling=scaling,
                           timeout=timeout, priority=priority)

    # -- scheduling (caller holds the lock) --------------------------------
    # lock: holds(_cv)
    def _purge_expired_locked(self, now: float) -> List[_Request]:
        """Reap queued requests whose deadline has already passed
        (caller holds the lock; futures resolve OUTSIDE it). Runs only
        on the backpressure path, so ``QueueFullError`` is never raised
        while the queue is stuffed with dead requests that dispatch
        would discard anyway. O(queue), but the full-queue path is
        already the slow path."""
        reaped: List[_Request] = []
        for shard in self._shards.values():
            for lane in (shard.high, shard.normal):
                expired = [e for e in lane if e[0] <= now]
                if not expired:
                    continue
                reaped.extend(e[2] for e in expired)
                lane[:] = [e for e in lane if e[0] > now]
                heapq.heapify(lane)
        if reaped:
            self._pending -= len(reaped)
            self._high_pending -= sum(1 for r in reaped
                                      if r.priority == "high")
        return reaped

    # lock: holds(_cv)
    def _select_shard(self) -> Optional[_Shard]:
        """The shard whose head request is most urgent: high lane before
        normal, then earliest deadline, then arrival order. O(#active
        signatures), not O(queued requests)."""
        best = best_rank = None
        for shard in self._shards.values():
            rank = shard.head_rank()
            if rank is not None and (best_rank is None
                                     or rank < best_rank):
                best, best_rank = shard, rank
        return best

    # lock: holds(_cv)
    def _pop_into(self, shard: _Shard, bucket: List[_Request],
                  limit: int) -> None:
        """Move up to ``limit - len(bucket)`` requests from the shard's
        lanes into ``bucket`` — high lane drained first, EDF order
        within each lane."""
        for lane in (shard.high, shard.normal):
            while lane and len(bucket) < limit:
                _, _, req = heapq.heappop(lane)
                bucket.append(req)
                self._pending -= 1
                if req.priority == "high":
                    self._high_pending -= 1
                if req.trace is not None:
                    req.trace.finish("serve.queue_wait")

    # lock: holds(_cv)
    def _earliest_deadline(self) -> float:
        """The soonest deadline among ALL queued requests (inf when
        none) — lane heads are heap minima, so this is O(#shards)."""
        d = math.inf
        for shard in self._shards.values():
            for lane in (shard.high, shard.normal):
                if lane and lane[0][0] < d:
                    d = lane[0][0]
        return d

    # -- dispatch ----------------------------------------------------------
    def _fill_bucket(self, shard: _Shard, bucket: List[_Request]) -> None:
        """Wait out the batching window, absorbing same-key arrivals
        into ``bucket`` until it is full or the window closes. The
        window closes EARLY when a high-priority request lands for
        another signature or a queued deadline is about to expire —
        bucket formation never holds urgent work hostage."""
        until = time.monotonic() + self._batch_window
        while len(bucket) < self._max_batch:
            with self._cv:
                self._pop_into(shard, bucket, self._max_batch)
                if len(bucket) >= self._max_batch or self._closed:
                    return
                if self._high_pending:
                    return  # high work for another key: close early
                now = time.monotonic()
                wait = until - now
                d = self._earliest_deadline()
                if d - now < wait:
                    wait = d - now  # EDF: serve it before it expires
                if wait <= 0:
                    return
                self._cv.wait(wait)

    def _pipeline_slots(self, plan=None) -> int:
        """In-flight bucket window for the dispatch loop. For a plan on
        the card it is one slot deeper than the device pool: pool-size
        buckets overlap across devices, and the extra slot double-buffers
        the host side — the dispatcher stages and launches bucket N+1
        while the card still executes bucket N. On the CPU a call
        computes before it returns, so there is nothing to overlap and
        the window stays the pool size. The device decides, once: the
        pool's (an explicit pool), else ``plan``'s (the bucket's), else
        that of a plan the registry holds — so the controller, which
        asks with no plan, sees the auto depth the dispatcher will use
        before the first bucket. The ``pipeline_depth`` knob (nonzero)
        overrides the choice — read per dispatch iteration, so a
        controller retune applies live."""
        depth = self._pipeline_depth
        if depth is not None:
            return depth
        if self._auto_extra is None:
            device = self._auto_device(plan)
            if device is not None:
                self._auto_extra = 0 if device.type == "cpu" else 1
        return len(self._devices) + (self._auto_extra or 0)

    def _auto_device(self, plan=None) -> Optional[torch.device]:
        """The device the auto pipeline depth is decided by: the pool's
        first, ``plan``'s, or the first registered plan's; None while
        none of them is known."""
        if self._devices[0] is not None:
            return self._devices[0]
        if plan is not None:
            return plan.device
        for sig in self.registry.signatures():
            device = getattr(self.registry.peek(sig), "device", None)
            if isinstance(device, torch.device):
                return device
        return None

    def _run_dispatcher(self) -> None:
        """Crash-proof supervisor around :meth:`_dispatch_loop`. An
        exception escaping the loop's per-bucket error handling fails
        the crashing bucket's futures with ``ExecutorCrashedError``,
        flushes in-flight buckets (resolving them normally when their
        results are intact), and restarts the loop — up to
        ``max_dispatch_restarts`` times. Past the budget it fails
        everything queued and marks the executor failed: a dispatch
        crash may degrade the service, it can NEVER silently strand a
        caller on an unresolved future."""
        while True:
            try:
                self._dispatch_loop()
                return  # clean shutdown via close()
            except Exception as exc:
                self.metrics.record_dispatcher_crash()
                if _obs.active():
                    _obs.GLOBAL_TRACER.instant(
                        "serve.dispatcher_crash",
                        args={"error": repr(exc)[:200]})
                crash = ExecutorCrashedError(
                    f"dispatch loop crashed: {exc!r}")
                forming, self._forming = self._forming, None
                self._fail_requests(forming or [], crash)
                while self._inflight:
                    work = self._inflight.popleft()
                    try:
                        self._finish(*work)
                    except Exception:
                        self._fail_requests(work[0], crash)
                with self._cv:
                    self._restarts += 1
                    give_up = self._restarts > self._max_restarts
                    if give_up:
                        self._failed = True
                if not give_up:
                    self.metrics.record_dispatcher_restart()
                    if _obs.active():
                        _obs.GLOBAL_TRACER.instant(
                            "serve.dispatcher_restart")
                    self._push_health()
                    continue
                self._fail_all_pending(crash)
                self._push_health()
                return

    def _dispatch_loop(self) -> None:
        # Bounded in-flight pipelining (see _pipeline_slots): futures
        # resolve in _finish, after materialisation. In-flight work and
        # the forming bucket live on the executor (not loop locals) so
        # the supervisor can resolve their futures after a crash.
        inflight = self._inflight
        while True:
            self._check_fault("loop")
            shard = bucket = None
            with self._cv:
                if self._pending:
                    shard = self._select_shard()
                    bucket = []
                    self._pop_into(shard, bucket, self._max_batch)
                    depth_now = self._pending
                elif inflight:
                    pass  # fall through: flush one in-flight bucket
                elif self._closed:
                    return
                else:
                    self._cv.wait()
                    continue
            if bucket is None:
                # peek-then-pop: a crash inside _finish leaves the
                # bucket reachable for the supervisor's flush
                self._finish(*inflight[0])
                inflight.popleft()
                continue
            # read the (hot-swappable) depth each iteration so a
            # controller retune of pipeline_depth applies immediately
            depth = self._pipeline_slots(shard.plan)
            self._forming = bucket
            self.metrics.record_dequeue(depth_now)
            bt = self._bucket_trace(bucket)
            if bt is not None:
                bt.begin("serve.bucket_formation")
            # Wait out the batching window only on a TRICKLE (nothing
            # else queued after the take): under backlog the queued
            # requests are already late and a window wait just adds
            # latency without improving fill — the take itself drains
            # every same-key request the shard holds. The window wait
            # runs INSIDE the bucket trace's protective try: a crash
            # anywhere between formation-begin and execute must close
            # the bucket spans (the supervisor settles request traces,
            # not bucket traces — the static span-closure pass found
            # this window).
            try:
                # lock: waived(benign racy pre-check - _fill_bucket re-reads _closed under the cv before waiting)
                if len(bucket) < self._max_batch and depth_now == 0 \
                        and self._batching and self._batch_window > 0 \
                        and not self._closed:
                    self._fill_bucket(shard, bucket)
                work = self._execute(shard, bucket, bt)
            except BaseException:
                if bt is not None:
                    bt.end_all("error", "ExecutorCrashedError")
                raise
            if work is not None:
                inflight.append(work)
            self._forming = None
            while len(inflight) >= depth:
                self._finish(*inflight[0])
                inflight.popleft()

    def _drain_once(self) -> None:
        """Synchronous drain (close() on a never-started executor, and
        the bench CLI's deterministic ``--smoke`` waves): buckets form
        from whatever is queued, no windows, no pipelining."""
        while True:
            with self._cv:
                if not self._pending:
                    return
                shard = self._select_shard()
                bucket: List[_Request] = []
                self._pop_into(shard, bucket, self._max_batch)
                depth_now = self._pending
            self.metrics.record_dequeue(depth_now)
            bt = self._bucket_trace(bucket)
            if bt is not None:
                # span: closed-by(ServeExecutor._execute)
                bt.begin("serve.bucket_formation")
            work = self._execute(shard, bucket, bt)
            if work is not None:
                self._finish(*work)

    # -- device pool health ------------------------------------------------
    def _acquire_slot(self) -> _DeviceSlot:
        """Next servable pool slot, round-robin, skipping quarantined
        devices. A quarantined device whose backoff has elapsed is
        flipped to probation and RETURNED — the caller's request is the
        canary that decides readmission. Raises
        ``NoHealthyDeviceError`` when every slot is quarantined and
        none is due."""
        probed = None
        with self._pool_lock:
            now = time.monotonic()
            n = len(self._slots)
            for _ in range(n):
                slot = self._slots[self._rotor % n]
                self._rotor += 1
                if slot.state == "healthy":
                    return slot
                if slot.state == "quarantined" and now >= slot.until:
                    slot.state = "probation"
                    probed = slot
                    break
                # quarantined-and-not-due, or probation with a canary
                # already outstanding: skip
        if probed is not None:
            self.metrics.record_probation()
            _obs.record_event("device.probation", device=probed.index,
                              backoff_s=probed.backoff)
            if _obs.active():
                _obs.GLOBAL_TRACER.instant(
                    "serve.probation", track=_dev_track(probed),
                    args={"backoff_s": probed.backoff})
            return probed
        # lock: waived(pool list is append-never after __init__ - diagnostic count only)
        raise NoHealthyDeviceError(
            f"all {len(self._slots)} pool devices are quarantined and "
            f"none is due for probation")

    def _device_ok(self, slot: Optional[_DeviceSlot]) -> None:
        """A request completed on ``slot``: reset its failure streak; a
        probation canary's success re-admits the device."""
        if slot is None:
            return
        readmitted = False
        with self._pool_lock:
            slot.failures = 0
            if slot.state == "probation":
                slot.state = "healthy"
                slot.backoff = self._q_backoff
                readmitted = True
        if readmitted:
            self.metrics.record_readmission()
            _obs.record_event("device.readmit", device=slot.index)
            if _obs.active():
                _obs.GLOBAL_TRACER.instant("serve.readmission",
                                           track=_dev_track(slot))
            self._push_health()

    def _device_fail(self, slot: Optional[_DeviceSlot],
                     exc: Optional[BaseException] = None) -> None:
        """A request failed on ``slot``: bump its consecutive-failure
        count; crossing ``quarantine_after`` (or failing its probation
        canary) quarantines it with exponential backoff.

        ``exc`` drives the ATTRIBUTION gate: a
        REQUEST-attributed failure (``faults.attributes_device`` False
        — a poisoned payload fails the same way on every healthy
        device) never charges the device's streak, so a pure
        poisoned-request flood can no longer spuriously quarantine a
        healthy device. A probation canary that failed for request
        reasons returns the slot to quarantine with its verdict
        undecided — immediately probe-able, backoff NOT doubled."""
        if slot is None or self._q_after <= 0:
            return
        if exc is not None and not attributes_device(exc):
            self.metrics.record_request_attributed_failure()
            with self._pool_lock:
                if slot.state == "probation":
                    slot.state = "quarantined"
                    slot.until = time.monotonic()
            return
        quarantined = False
        with self._pool_lock:
            slot.failures += 1
            if slot.state == "probation":
                slot.backoff = min(slot.backoff * 2.0,
                                   QUARANTINE_BACKOFF_CAP)
                quarantined = True
            elif slot.failures >= self._q_after:
                quarantined = True
            if quarantined:
                slot.state = "quarantined"
                slot.until = time.monotonic() + slot.backoff
                slot.failures = 0
        if quarantined:
            self.metrics.record_quarantine()
            _obs.record_event("device.quarantine", device=slot.index,
                              backoff_s=slot.backoff)
            if _obs.active():
                _obs.GLOBAL_TRACER.instant(
                    "serve.quarantine", track=_dev_track(slot),
                    args={"backoff_s": slot.backoff})
            self._push_health()

    # -- execution ---------------------------------------------------------
    def prewarm(self, signature: PlanSignature,
                scaling: Scaling = Scaling.NONE,
                batch_sizes=()) -> None:
        """Run once, and wait for, every call this executor can dispatch
        for ``signature``: the serial backward/forward pair plus each
        batch shape of the planned-batch ladder — plus any
        ``batch_sizes`` a caller expects to PIN — on EVERY pool device.
        Call once per signature before traffic: the first call of a
        kernel source in a process builds it (``nvcc``, a minute or more
        for the whole set), which must happen here and never inside a
        request or under ``execute_timeout_ms``; the first call at each
        batch shape also sizes the caching allocator's blocks, and a
        pool device gets its copy of the plan's tables. On the card it
        also allocates the pinned staging buffers of the backward
        requests' ladder shapes (:meth:`_prestage`), whose first
        allocation would otherwise fall inside a request."""
        plan = self.registry.get(signature)
        if plan is None:
            raise InvalidParameterError(
                f"signature not in registry: {signature}")
        # prewarm is a blocking pre-traffic step: a failed table build
        # surfaces here, typed, instead of poisoning the first request
        plan.check_build(wait=True)
        t_warm = time.perf_counter()
        nv = plan.index_plan.num_values
        zeros = (np.zeros((nv, 2), np.float32)
                 if plan.precision == "single"
                 else np.zeros(nv, np.complex128))
        ladder = sorted({self._padded_size(b)
                         for b in range(2, self._max_batch + 1)}
                        | {int(b) for b in batch_sizes if int(b) >= 2})
        for device in self._devices:
            space = plan.backward(zeros, device=device)
            out = [plan.forward(space, scaling, device=device)]
            if self._batching:
                for size in ladder:
                    if not fusion_eligible(plan, size):
                        continue
                    out.append(plan.backward_batched(
                        [zeros] * size, device=device))
                    out.append(plan.forward_batched(
                        [space] * size, scaling, device=device))
            wait_ready(out)
        if self._batching:
            self._prestage(signature, plan,
                           [s for s in ladder if fusion_eligible(plan, s)])
        # compile observability: the kernel builds and ladder runs
        # happen here on a warm server
        _obs.record_compile("prewarm", time.perf_counter() - t_warm,
                            t_warm, ladder=len(ladder),
                            devices=len(self._devices),
                            num_values=nv)

    def _prestage(self, signature: PlanSignature, plan, sizes) -> None:
        """Allocate the pinned staging buffers of ``signature``'s backward
        requests (host values, the usual host input): one of the largest
        of ``sizes`` (at least ``max_batch`` rows) for each bucket that
        can be in flight at once, every smaller shape staging into its
        leading rows, so that no bucket pays a pinned allocation
        (hundreds of milliseconds for a 256^3 bucket). Nothing on the
        CPU, where buffers are plain host tensors."""
        if plan.device.type != "cuda" or not sizes:
            return
        row_shape, _ = plan.batch_row_template("values")
        key = (signature, "backward", Scaling.NONE)
        rows = max(self._max_batch, max(sizes))
        with self._staging_lock:
            free = self._staging.setdefault(key, [])
            free[:] = [e for e in free if e[0].shape[0] >= rows]
            while len(free) < self._pipeline_slots(plan):
                free.append([torch.empty((rows,) + row_shape,
                                         dtype=plan.real_dtype,
                                         pin_memory=True), []])

    def _drop_staging(self, signature: PlanSignature) -> None:
        """The registry evicted ``signature``'s plan: drop its staging
        buffers (a bucket still in flight keeps its own until it
        completes; :meth:`_release` does not return it)."""
        with self._staging_lock:
            for key in [k for k in self._staging if k[0] == signature]:
                del self._staging[key]

    def _padded_size(self, b: int) -> int:
        """The fallback batch ladder (``multi.planned_batch_size``):
        smallest power of two >= ``b``, capped at ``max_batch``."""
        return planned_batch_size(b, self._max_batch)

    def _prewarm_pin_async(self, shard: _Shard, b: int) -> None:
        """Prewarm-on-pin: the observer's streak is ONE bucket short of
        pinning exact shape ``b`` — run that batch shape once on a
        background thread now (zero rows, waited for), so the first
        pinned dispatch finds the allocator's blocks of that shape (the
        JAX package compiles the shape's executable here). The launches
        count as any launch does. Best-effort: a failed run changes
        nothing at dispatch."""
        key = (shard.key, b)
        if key in self._prewarm_threads \
                or not fusion_eligible(shard.plan, b):
            return
        template = self._row_template(shard)
        if template is None:
            return  # device-staged plans: no host zero-batch to trace
        plan, kind, scaling = shard.plan, shard.key[1], shard.key[2]
        row_shape, dtype = template
        devices = list(self._devices)
        metrics = self.metrics

        def compile_shape():
            try:
                t_pin = time.perf_counter()
                zeros = np.zeros((b,) + row_shape, dtype)
                for device in devices:
                    if kind == "backward":
                        out = plan.backward_batched(zeros, device=device)
                    else:
                        out = plan.forward_batched(zeros, scaling,
                                                   device=device)
                    wait_ready(out)
                metrics.record_pin_prewarm()
                _obs.record_compile("pin_prewarm",
                                    time.perf_counter() - t_pin, t_pin,
                                    batch=b, kind=kind)
            except Exception:
                pass

        thread = threading.Thread(target=compile_shape, daemon=True,
                                  name="spfft-serve-pin-prewarm")
        self._prewarm_threads[key] = thread
        thread.start()

    def _dispatch_shape(self, shard: _Shard, b: int) -> Tuple[int, bool]:
        """The batch shape a fused bucket of ``b`` live rows dispatches
        at, and whether that shape is exact (pinned or ladder-exact).

        The observer pins ``b`` once it repeats ``pin_after`` times
        consecutively; pinned shapes live in a per-signature LRU capped
        at ``max_pinned_shapes``. One repeat BEFORE the pin lands the
        exact-shape run starts on a background thread
        (prewarm-on-pin). Churny traffic (no streak) falls back to the
        pow2 ladder, so the count of batch shapes stays bounded either
        way. Dispatcher thread only — no lock."""
        ladder = self._padded_size(b)
        if ladder == b:
            # ladder already exact: zero pad rows for free, no pin
            # needed (and none counted — pinned_batches reads the
            # adaptive path only)
            return b, False
        if self._pin_after <= 0:
            return ladder, False
        if b == shard.last_size:
            shard.streak += 1
        else:
            shard.last_size = b
            shard.streak = 1
        pins = self._pins.get(shard.key[0])
        if pins is not None and b in pins:
            pins.move_to_end(b)
            return b, True
        if self._prewarm_on_pin and self._pin_after >= 2 \
                and shard.streak == self._pin_after - 1:
            self._prewarm_pin_async(shard, b)
        if shard.streak >= self._pin_after:
            if pins is None:
                pins = self._pins[shard.key[0]] = collections.OrderedDict()
            pins[b] = None
            while len(pins) > self._max_pinned:
                pins.popitem(last=False)
            return b, True
        return ladder, False

    # -- staging -----------------------------------------------------------
    def _row_template(self, shard: _Shard):
        if not shard.template_ready:
            shard.row_template = shard.plan.batch_row_template(
                "values" if shard.key[1] == "backward" else "space")
            shard.template_ready = True
        return shard.row_template

    @staticmethod
    def _host_row(plan, kind: str, values, template, swapped=None):
        """One payload as a host row of the plan's template: the numpy
        array itself where it already is one — or where it is one in
        the ``swapped`` row shape (interleaved values of a pair-layout
        plan, which :meth:`_stage` stages as they are and the card
        transposes) — else the plan's coercion on the host (a CPU
        tensor); None for a payload on a device, which stays there (the
        list path of :meth:`_stage`). A payload the plan refuses raises
        here, inside the bucket's protection."""
        if isinstance(values, torch.Tensor) and values.device.type != "cpu":
            return None
        row_shape, dtype = template
        if isinstance(values, np.ndarray) and values.dtype == dtype \
                and values.shape in (row_shape, swapped):
            return values
        coerce = (plan._coerce_values if kind == "backward"
                  else plan._coerce_space)
        row = coerce(values, torch.device("cpu"))
        return row if tuple(row.shape) == row_shape else None

    @staticmethod
    def _swapped_row(plan, kind: str, template):
        """The interleaved ``(num_values, 2)`` row shape of a pair-layout
        plan on the card (template ``(2, num_values)``), whose host
        values a bucket stages as they are and transposes on the card
        (:meth:`_to_device`) — a copy the card makes in a fraction of a
        millisecond where the host's strided transpose takes a few
        hundred milliseconds a 16M-value row; None otherwise."""
        row_shape, _ = template
        if kind != "backward" or plan.device.type != "cuda" \
                or len(row_shape) != 2 or row_shape[0] != 2 \
                or row_shape[1] == 2:
            return None
        return row_shape[::-1]

    def _stage(self, shard: _Shard, live: List[_Request], shape: int):
        """Stack ``live`` payloads (plus pad rows up to ``shape``) into a
        reusable host buffer when every payload is a host row of the
        plan's template: pinned where the plan is on the card, so that
        :meth:`_to_device` moves the bucket in ONE ``non_blocking``
        copy. A bucket of ``shape`` rows takes the leading rows of a
        buffer of ``max_batch`` rows, so a shard holds one buffer per
        bucket in flight, whatever its shapes.
        Returns ``(batch_arg, staged)``: ``staged`` is ``[buffer,
        events]`` (the events :meth:`_to_device` records behind the
        copy), or None on the list path (payloads already on a device),
        where the plan stacks the rows on the device itself.

        Buffers come from a free list; :meth:`_release` returns them,
        and a buffer taken from the list is rewritten only after the
        events behind its last copy have completed — never while that
        copy may still read it."""
        template = self._row_template(shard)
        plan, kind = shard.plan, shard.key[1]
        swapped = self._swapped_row(plan, kind, template)
        rows = [self._host_row(plan, kind, req.values, template, swapped)
                for req in live]
        if all(r is not None for r in rows):
            row_shape, _ = template
            # interleaved rows of a pair-layout plan stay interleaved in
            # the buffer (the card transposes the bucket) when every row
            # is; a mixed bucket coerces them on the host
            inter = swapped is not None \
                and all(tuple(r.shape) == swapped for r in rows)
            if swapped is not None and not inter:
                rows = [plan._coerce_values(r, torch.device("cpu"))
                        if tuple(r.shape) == swapped else r for r in rows]
            with self._staging_lock:
                free = self._staging.get(shard.key)
                entry = free.pop() if free else None
            if entry is not None and entry[0].shape[0] >= shape:
                whole, events = entry
                wait_events(events)
            else:
                # none free, or one from before max_batch grew
                whole = torch.empty((max(self._max_batch, shape),)
                                    + row_shape, dtype=plan.real_dtype,
                                    pin_memory=plan.device.type == "cuda")
            # leading rows: still contiguous; interleaved rows view the
            # same bytes as (num_values, 2), the buffer itself keeps the
            # plan's row shape for the next bucket
            buf = (whole.view((whole.shape[0],) + swapped) if inter
                   else whole)[:shape]
            # torch's copy runs on its intra-op threads (a numpy copy on
            # one); a read-only array, which torch would not wrap without
            # a warning, goes through numpy
            for i, r in enumerate(rows):
                if isinstance(r, np.ndarray) and not r.flags.writeable:
                    buf.numpy()[i] = r
                else:
                    buf[i].copy_(torch.from_numpy(r)
                                 if isinstance(r, np.ndarray) else r)
            for j in range(len(rows), shape):
                buf[j].copy_(buf[0])  # pad rows repeat row 0
            return buf, [whole, []]
        values = [req.values for req in live]
        values += [values[0]] * (shape - len(values))
        return values, None

    @staticmethod
    def _to_device(plan, batch_arg, staged, device):
        """A staged host buffer -> the bucket's device (the pool slot's,
        else the plan's) in one copy: ``non_blocking`` on the card, on
        the current stream ahead of the bucket's launches, with the
        events recorded behind it kept in ``staged``. Interleaved rows
        of a pair-layout plan (a buffer of ``(B, num_values, 2)``) are
        transposed there into the plan's ``(B, 2, num_values)`` — the
        transpose :meth:`~spfft_tpu_torch.plan.TransformPlan.backward`
        makes of such a row on the card, so the bits are the serial
        call's. A list batch, or a buffer for the CPU, goes as it is."""
        target = plan.device if device is None else device
        if staged is None or target.type != "cuda":
            return batch_arg
        batch = ServeExecutor._plan_layout(
            plan, batch_arg.to(target, non_blocking=True))
        staged[1] = ready_events(batch)
        return batch

    @staticmethod
    def _plan_layout(plan, batch):
        """A staged backward batch in the plan's value layout: a batch of
        interleaved ``(B, num_values, 2)`` rows for a pair-layout plan
        transposed to ``(B, 2, num_values)`` (on the batch's device);
        any other batch as it is."""
        if batch.dim() == 3 and batch.shape[-1] == 2 \
                and tuple(batch.shape[1:]) != tuple(
                    plan.batch_row_template("values")[0]):
            return batch.transpose(1, 2).contiguous()
        return batch

    def _release(self, shard_key, staged) -> None:
        """Return a bucket's staging buffer to its shard's free list —
        unless the registry no longer holds the signature, when it is
        let go."""
        if staged is None or shard_key[0] not in self.registry:
            return
        with self._staging_lock:
            self._staging.setdefault(shard_key, []).append(staged)

    def _run_one(self, req: _Request, pooled: bool):
        """One SYNCHRONOUS serial execution of a single request —
        dispatch plus materialisation — used by recovery and retry.
        Updates the device health accounting; raises on failure
        (``NoHealthyDeviceError`` propagates before any device is
        charged)."""
        slot = self._acquire_slot() if pooled else None
        device = slot.device if slot is not None else None
        try:
            self._check_fault("dispatch",
                              slot.index if slot is not None else None)
            if req.kind == "backward":
                res = req.plan.backward(req.values, device=device)
            else:
                res = req.plan.forward(req.values, req.scaling,
                                       device=device)
            wait_ready(res)
        except Exception as exc:
            self._device_fail(slot, exc)
            raise
        self._device_ok(slot)
        return res

    def _resolve_one(self, req: _Request, res) -> None:
        if req.future.done():
            return
        done = time.monotonic()
        self.metrics.record_request_done(done - req.enqueued_at,
                                         priority=req.priority)
        rt = req.trace
        if rt is not None:
            rt.begin("serve.resolve")
        req.future.set_result(res)
        if rt is not None:
            rt.finish("serve.resolve")
            rt.close()

    def _annotate_fallback(self, live, cause: BaseException) -> None:
        """Bucket-fallback annotation on every traced member
        (retry / fallback / quarantine events attach to spans)."""
        if not _obs.active():
            return
        for req in live:
            if req.trace is not None:
                req.trace.annotate("serve.bucket_fallback",
                                   error=repr(cause)[:200])

    def _recover_serial(self, live: List[_Request], cause: BaseException,
                        pooled: bool) -> None:
        """Bucket-failure isolation: the fused bucket raised ``cause``,
        so re-execute every live request SERIALLY — only genuinely
        poisoned requests fail; healthy co-batched requests still return
        their (bit-exact) results. The serial re-executions draw on each
        request's PER-PRIORITY retry budget (``retry_budget``; high-lane
        requests get more attempts than normal ones): a transient
        failure that persists through the budget becomes
        ``RetryExhaustedError`` (carrying the cause), a permanent one
        surfaces as itself."""
        for req in live:
            budget = max(1, self._retry_budget[req.priority])
            for attempt in range(budget):
                self.metrics.record_retry(req.priority)
                if req.trace is not None:
                    req.trace.annotate("serve.retry",
                                       attempt=attempt + 1,
                                       budget=budget)
                try:
                    res = self._run_one(req, pooled)
                except NoHealthyDeviceError as exc:
                    self.metrics.record_no_healthy_device()
                    self._fail_requests([req], exc)
                    break
                except Exception as exc:
                    if attempt + 1 < budget and is_transient(exc):
                        continue
                    if is_transient(exc):
                        self.metrics.record_retry_exhausted(req.priority)
                        self._fail_requests([req], RetryExhaustedError(
                            f"request failed its fused-bucket fallback "
                            f"({attempt + 1}/{budget} "
                            f"{req.priority}-class attempts; bucket "
                            f"error: {cause!r})", cause=exc))
                    else:
                        self._fail_requests([req], exc)
                    break
                else:
                    self._resolve_one(req, res)
                    break

    def _retry_request(self, req: _Request, first_exc: BaseException,
                       pooled: bool) -> None:
        """A serial execution of ``req`` failed with ``first_exc``:
        permanent failures surface immediately; transient ones get the
        request's PER-PRIORITY bounded retry budget, failing with
        ``RetryExhaustedError`` once it is spent."""
        budget = self._retry_budget[req.priority]
        if not is_transient(first_exc) or budget < 1:
            self._fail_requests([req], first_exc)
            return
        for attempt in range(budget):
            self.metrics.record_retry(req.priority)
            if req.trace is not None:
                req.trace.annotate("serve.retry", attempt=attempt + 1,
                                   budget=budget)
            try:
                res = self._run_one(req, pooled)
            except NoHealthyDeviceError as exc:
                self.metrics.record_no_healthy_device()
                self._fail_requests([req], exc)
                return
            except Exception as exc:
                if attempt + 1 < budget and is_transient(exc):
                    continue
                self.metrics.record_retry_exhausted(req.priority)
                self._fail_requests([req], RetryExhaustedError(
                    f"transient failure persisted through "
                    f"{attempt + 1}/{budget} {req.priority}-class "
                    f"retries (first error: {first_exc!r})", cause=exc))
                return
            self._resolve_one(req, res)
            return

    def _bucket_trace(self, bucket) -> Optional[_BucketTrace]:
        """A :class:`_BucketTrace` when tracing is on and any member
        request was sampled; None otherwise (one boolean read on the
        disabled path)."""
        if not _obs.active():
            return None
        traced = [r for r in bucket if r.trace is not None]
        if not traced:
            return None
        return _BucketTrace(_obs.GLOBAL_TRACER, traced)

    def _execute(self, shard: _Shard, bucket: List[_Request],
                 bt: Optional[_BucketTrace] = None):
        """Deadline-check and DISPATCH one bucket. Returns ``(live,
        results, shard_key, shape, staged, slots, fused, bt, t_disp,
        events)`` with results possibly still executing (the dispatch
        loop pipelines them; ``events`` mark their completion), or
        ``None`` when nothing survived the deadline check or every
        request resolved on a failure path. ``bt`` carries the
        bucket-level trace spans; its ``serve.device_execute`` span
        stays open across the return and closes in :meth:`_finish`."""
        now = time.monotonic()
        # control-plane signal: enqueue->dispatch wait per request
        # (includes any batching window sat out) — what the feedback
        # controller weighs against device-execute time
        self.metrics.record_queue_waits(
            [now - req.enqueued_at for req in bucket])
        live: List[_Request] = []
        expired: List[_Request] = []
        for req in bucket:
            (expired if req.deadline is not None and now > req.deadline
             else live).append(req)
        for req in expired:
            self.metrics.record_deadline_expired()
            req.future.set_exception(DeadlineExpiredError(
                f"deadline expired after "
                f"{now - req.enqueued_at:.3f}s in queue"))
            if req.trace is not None:
                req.trace.close("error", "DeadlineExpiredError")
        if not live:
            if bt is not None:
                bt.end_all()
            return None
        if bt is not None:
            bt.end("serve.bucket_formation")
        plan = live[0].plan
        kind = live[0].kind
        scaling = live[0].scaling
        # device pools apply to LOCAL plans only — a distributed plan
        # already spans its mesh and pins its own placement
        pooled = (self._devices != [None]
                  and isinstance(plan, TransformPlan))
        b = len(live)
        shape, exact = b, False
        fused = False
        if self._batching and b >= 2:
            shape, exact = self._dispatch_shape(shard, b)
            fused = fusion_eligible(plan, shape)
        buf = None
        slot: Optional[_DeviceSlot] = None
        t0 = time.perf_counter()
        if fused:
            if bt is not None:
                bt.begin("serve.stage", args={"batch": b, "shape": shape})
            try:
                # Planned-batch execution (the cuFFT idiom): dispatch at
                # the exact pinned shape when the observer has locked
                # on, else pad up to the next pow2 ladder size, so a
                # plan meets O(log max_batch) batch shapes. Batched rows
                # are independent, so pad rows (repeats of row 0) cannot
                # perturb the live rows and results stay bit-identical
                # to serial execution. The whole bucket lands on ONE
                # pool device; successive buckets rotate.
                self._check_fault("stage")
                batch_arg, buf = self._stage(shard, live, shape)
                slot = self._acquire_slot() if pooled else None
                device = slot.device if slot is not None else None
                batch_arg = self._to_device(shard.plan, batch_arg, buf,
                                            device)
                if bt is not None:
                    bt.end("serve.stage")
                    bt.begin("serve.dispatch", track=_dev_track(slot))
                self._check_fault(
                    "dispatch", slot.index if slot is not None else None)
                t1 = time.perf_counter()
                if kind == "backward":
                    stacked = plan.backward_batched(batch_arg,
                                                    device=device)
                else:
                    stacked = plan.forward_batched(batch_arg, scaling,
                                                   device=device)
                results = [stacked[i] for i in range(b)]
                events = [ready_events(stacked)]
            except NoHealthyDeviceError as exc:
                if bt is not None:
                    bt.end_all("error", type(exc).__name__)
                self._release(shard.key, buf)
                self.metrics.record_no_healthy_device()
                self._fail_requests(live, exc)
                return None
            except Exception as exc:
                # bucket-failure isolation: never fail the whole bucket
                # for one poisoned request — fall back to per-request
                # serial re-execution
                if bt is not None:
                    bt.end_all("error", type(exc).__name__)
                self._release(shard.key, buf)
                self._device_fail(slot, exc)
                self.metrics.record_bucket_fallback()
                self._annotate_fallback(live, exc)
                self._recover_serial(live, exc, pooled)
                return None
            t2 = time.perf_counter()
            self.metrics.record_batch(b, True, padded_rows=shape - b,
                                      pinned=exact,
                                      stage_s=t1 - t0, dispatch_s=t2 - t1)
            if bt is not None:
                bt.end("serve.dispatch")
                bt.begin("serve.device_execute", track=_dev_track(slot))
            return (live, results, shard.key, shape, buf, [slot], True,
                    bt, t1, events)
        # serial path: dispatch every request before blocking on any
        # result (the multi.py async-overlap idiom), fanned round-robin
        # across the device pool; failures are isolated per request
        shape, exact = b, False
        keep: List[_Request] = []
        results = []
        events = []
        slots: List[Optional[_DeviceSlot]] = []
        if bt is not None:
            bt.begin("serve.dispatch", args={"batch": b, "serial": True})
        for req in live:
            slot = None
            try:
                slot = self._acquire_slot() if pooled else None
                device = slot.device if slot is not None else None
                self._check_fault(
                    "dispatch", slot.index if slot is not None else None)
                if kind == "backward":
                    res = plan.backward(req.values, device=device)
                else:
                    res = plan.forward(req.values, scaling, device=device)
            except NoHealthyDeviceError as exc:
                self.metrics.record_no_healthy_device()
                self._fail_requests([req], exc)
                continue
            except Exception as exc:
                self._device_fail(slot, exc)
                self._retry_request(req, exc, pooled)
                continue
            keep.append(req)
            results.append(res)
            events.append(ready_events(res))
            slots.append(slot)
        t2 = time.perf_counter()
        self.metrics.record_batch(b, False, dispatch_s=t2 - t0)
        if bt is not None:
            bt.end("serve.dispatch")
        if not keep:
            if bt is not None:
                bt.end_all()
            return None
        if bt is not None:
            bt.begin("serve.device_execute",
                     track=_dev_track(slots[0] if slots else None))
        return (keep, results, shard.key, shape, buf, slots, False, bt,
                t0, events)

    def _materialise(self, events) -> None:
        """Wait for a bucket: ``Event.synchronize`` on the events
        recorded behind its launches (one list per launch group), under
        the ``execute_timeout_ms`` watchdog when that knob is non-zero.
        The wait runs on a short-lived daemon worker; if it outlives the
        deadline the worker is abandoned (a wedged kernel cannot be
        cancelled from the host) and the bucket fails with the TYPED
        transient :class:`ExecuteTimeoutError`, which feeds the retry +
        quarantine ladder exactly like a device fault. With the knob at
        0 (default) the wait is inline."""
        timeout_ms = self.config.execute_timeout_ms
        if timeout_ms <= 0:
            self._check_fault("materialise")
            for evs in events or ():
                wait_events(evs)
            return
        box: Dict[str, BaseException] = {}
        done = threading.Event()

        def _work():
            try:
                self._check_fault("materialise")
                for evs in events or ():
                    wait_events(evs)
            except BaseException as exc:
                box["exc"] = exc
            finally:
                done.set()

        worker = threading.Thread(target=_work, daemon=True,
                                  name="spfft-materialise")
        worker.start()
        if not done.wait(timeout_ms / 1000.0):
            _obs.GLOBAL_COUNTERS.inc("spfft_execute_timeouts_total")
            raise ExecuteTimeoutError(
                f"bucket materialisation exceeded execute_timeout_ms="
                f"{timeout_ms:g} ms; abandoning the wedged execute")
        exc = box.get("exc")
        if exc is not None:
            raise exc

    def _finish(self, live, results, shard_key=None, shape=0,
                buf=None, slots=None, fused=False, bt=None,
                t_disp=None, events=None) -> None:
        """Materialise a dispatched bucket and resolve its futures:
        latency samples measure completion (not dispatch), and
        asynchronous CUDA failures surface here as exceptions from the
        event waits instead of poisoned tensors.
        A fused bucket that fails to materialise takes the same
        per-request serial recovery as a failed dispatch; a serial
        bucket isolates the failure by materialising per request. The
        staging buffer returns to its free-list only now — after
        materialisation — so reuse can never race the device
        transfer. ``bt``'s spans (the open ``serve.device_execute``
        plus the ``serve.materialise`` opened here) close before any
        member future resolves, so bucket spans always nest inside
        their request root."""
        if bt is not None:
            bt.begin("serve.materialise",
                     track=_dev_track(slots[0] if slots else None))
        try:
            self._materialise(events)
        except Exception as exc:
            if bt is not None:
                bt.end_all("error", type(exc).__name__)
            self._release(shard_key, buf)
            pooled = bool(slots) and slots[0] is not None
            if fused:
                self._device_fail(slots[0] if slots else None, exc)
                self.metrics.record_bucket_fallback()
                self._annotate_fallback(live, exc)
                self._recover_serial(live, exc, pooled)
                return
            for i, req in enumerate(live):
                slot = slots[i] if slots else None
                try:
                    wait_events(events[i] if events else ())
                except Exception as exc_i:
                    self._device_fail(slot, exc_i)
                    self._retry_request(req, exc_i, slot is not None)
                    continue
                self._device_ok(slot)
                self._resolve_one(req, results[i])
            return
        if bt is not None:
            bt.end("serve.materialise")
            bt.end("serve.device_execute")
        if t_disp is not None:
            # control-plane signal: dispatch -> materialised per bucket
            self.metrics.record_device_execute(
                time.perf_counter() - t_disp)
        self._release(shard_key, buf)
        for slot in (slots or ()):
            self._device_ok(slot)
        done = time.monotonic()
        for req, res in zip(live, results):
            if req.future.done():
                continue
            self.metrics.record_request_done(done - req.enqueued_at,
                                             priority=req.priority)
            rt = req.trace
            if rt is not None:
                rt.begin("serve.resolve")
            req.future.set_result(res)
            if rt is not None:
                rt.finish("serve.resolve")
                rt.close()

    # -- introspection -----------------------------------------------------
    def pinned_shapes(self, signature: PlanSignature) -> Tuple[int, ...]:
        """The exact batch shapes currently pinned for ``signature``
        (LRU order, oldest first). Diagnostic only — reads dispatcher-
        owned state, so values are advisory under live traffic."""
        pins = self._pins.get(signature)
        return tuple(pins) if pins else ()
