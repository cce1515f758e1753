"""Serving metrics: request latency, queue depth, batch sizes, registry
counters — one thread-safe sink shared by the executor and the benchmark
CLI (the port of ``spfft_tpu/serve/metrics.py``; :meth:`ServeMetrics.
snapshot` and :meth:`ServeMetrics.signals` return the JAX package's keys,
which the control loop and the Prometheus exporter read).

Distributions are BOUNDED: latency samples live in per-priority-class
ring reservoirs (``latency_window`` most-recent samples per class), so a
long-lived server's percentiles stay a fixed-size, recent-window
statistic. The total-count counters (``completed``, ``failed``,
per-class completion counts) are exact over the lifetime.

Batch-size histograms are split per execution path: fused (one batched
execution of the plan for the bucket) and serial buckets are counted
apart, so ``max_fused_batch_size`` reads fused buckets only.
``padded_rows`` accumulates the pad rows the planned-batch ladder added
(~0 once adaptive pinning locks onto a stable size) and
``pinned_batches`` counts buckets dispatched at an exact pinned shape.

Integration with :mod:`spfft_tpu_torch.timing`: every completed
request's latency is also recorded into the global scope timer under
``serve.request`` when timing is enabled, and ``to_json`` embeds the
timing tree next to the serving counters.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Dict, List, Optional

from .. import timing

#: Priority classes the executor serves (submission order of lanes).
PRIORITY_CLASSES = ("high", "normal")

#: Default per-class latency reservoir size: large enough that p99 over
#: the window rests on ~40 real tail samples, small enough that a
#: million-request day holds ~64 KB of floats per class.
DEFAULT_LATENCY_WINDOW = 4096

#: Reservoir size for the control-plane signal distributions
#: (queue-wait per request, device-execute per bucket): the feedback
#: controller reads a RECENT-window percentile, so a smaller ring keeps
#: it responsive to regime changes.
DEFAULT_SIGNAL_WINDOW = 1024


def percentile(samples: List[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on no samples. The
    serving latency distribution is heavy-tailed (batching windows +
    kernel builds), so nearest-rank — always a real sample — beats
    interpolation for honesty at the p99 tail."""
    if not samples:
        return 0.0
    s = sorted(samples)
    k = max(0, min(len(s) - 1, int(round(p / 100.0 * len(s) + 0.5)) - 1))
    return s[k]


class ServeMetrics:
    """Counters + distributions for one executor's lifetime.

    All mutation goes through the internal lock: the executor's
    dispatcher thread records completions while N submitter threads
    record enqueues/rejects concurrently. The executor calls every
    ``record_*`` OUTSIDE its own queue lock, so metric contention never
    extends queue-lock hold times.
    """

    def __init__(self, latency_window: int = DEFAULT_LATENCY_WINDOW):
        self._lock = threading.Lock()
        self._window = max(1, int(latency_window))
        self.reset()

    def reset(self) -> None:
        """Zero every counter/distribution (the bench CLI separates its
        warm phase from the measured replay this way). Quiesce the
        executor first — concurrent recording during a reset is not an
        error, but its samples land on whichever side of the reset the
        lock decides."""
        with self._lock:
            #: guarded by _lock
            self._latencies: Dict[str, collections.deque] = {
                cls: collections.deque(maxlen=self._window)
                for cls in PRIORITY_CLASSES}
            #: guarded by _lock
            self._completed_by: Dict[str, int] = {
                cls: 0 for cls in PRIORITY_CLASSES}
            self._fused_hist: Dict[int, int] = {}   #: guarded by _lock
            self._serial_hist: Dict[int, int] = {}  #: guarded by _lock
            self._fused_batches = 0     #: guarded by _lock
            self._serial_batches = 0    #: guarded by _lock
            self._fused_rows = 0        #: guarded by _lock
            self._padded_rows = 0       #: guarded by _lock
            self._pinned_batches = 0    #: guarded by _lock
            # control-plane signal reservoirs (recent window):
            # queue-wait is enqueue -> dispatch per request (includes
            # the batching window a request sat out), device-execute is
            # dispatch -> materialised per bucket
            #: guarded by _lock
            self._queue_waits: collections.deque = collections.deque(
                maxlen=DEFAULT_SIGNAL_WINDOW)
            #: guarded by _lock
            self._device_exec: collections.deque = collections.deque(
                maxlen=DEFAULT_SIGNAL_WINDOW)
            self._stage_s = 0.0             #: guarded by _lock
            self._dispatch_s = 0.0          #: guarded by _lock
            # distributed-exchange overlap accounting (cumulative
            # seconds; the overlap_chunks controller rule diffs them)
            self._exchange_s = 0.0          #: guarded by _lock
            self._exchange_compute_s = 0.0  #: guarded by _lock
            self._completed = 0             #: guarded by _lock
            self._failed = 0                #: guarded by _lock
            self._rejected_queue_full = 0   #: guarded by _lock
            self._expired_deadline = 0      #: guarded by _lock
            self._purged_expired = 0        #: guarded by _lock
            self._queue_depth = 0           #: guarded by _lock
            self._max_queue_depth = 0       #: guarded by _lock
            # failure-handling counters (fault tolerance layer)
            self._retries = 0               #: guarded by _lock
            self._retries_exhausted = 0     #: guarded by _lock
            #: guarded by _lock
            self._retries_by: Dict[str, int] = {
                cls: 0 for cls in PRIORITY_CLASSES}
            #: guarded by _lock
            self._retries_exhausted_by: Dict[str, int] = {
                cls: 0 for cls in PRIORITY_CLASSES}
            self._bucket_fallbacks = 0      #: guarded by _lock
            self._quarantines = 0           #: guarded by _lock
            self._probations = 0            #: guarded by _lock
            self._readmissions = 0          #: guarded by _lock
            self._no_healthy_device = 0     #: guarded by _lock
            self._dispatcher_crashes = 0    #: guarded by _lock
            self._dispatcher_restarts = 0   #: guarded by _lock
            self._pin_prewarms = 0          #: guarded by _lock
            self._request_attributed_failures = 0  #: guarded by _lock
            self._slo_violations: tuple = ()       #: guarded by _lock
            self._health_state = "healthy"         #: guarded by _lock

    # -- recording (executor-facing) ---------------------------------------
    def record_enqueue(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth
            if depth > self._max_queue_depth:
                self._max_queue_depth = depth

    def record_dequeue(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth

    def record_reject_queue_full(self) -> None:
        with self._lock:
            self._rejected_queue_full += 1

    def record_deadline_expired(self, purged: bool = False) -> None:
        """One request whose deadline elapsed before dispatch;
        ``purged=True`` when ``submit``'s backpressure sweep reclaimed
        it from a full queue (counted in both tallies)."""
        with self._lock:
            self._expired_deadline += 1
            if purged:
                self._purged_expired += 1

    # -- failure handling (executor-facing) --------------------------------
    def record_retry(self, priority: str = "normal") -> None:
        """One recovery/retry execution of a single request, charged to
        its priority class (the executor's retry budget is
        per-priority)."""
        with self._lock:
            self._retries += 1
            self._retries_by[priority] += 1

    def record_retry_exhausted(self, priority: str = "normal") -> None:
        """A request's transient failure persisted through its whole
        per-priority retry budget."""
        with self._lock:
            self._retries_exhausted += 1
            self._retries_exhausted_by[priority] += 1

    def record_bucket_fallback(self) -> None:
        """A fused bucket raised and fell back to per-request serial
        re-execution (bucket-failure isolation)."""
        with self._lock:
            self._bucket_fallbacks += 1

    def record_quarantine(self) -> None:
        with self._lock:
            self._quarantines += 1

    def record_probation(self) -> None:
        """A quarantined device's backoff elapsed; a canary request is
        being routed to it."""
        with self._lock:
            self._probations += 1

    def record_readmission(self) -> None:
        """A probation canary succeeded; the device rejoined the pool."""
        with self._lock:
            self._readmissions += 1

    def record_no_healthy_device(self) -> None:
        with self._lock:
            self._no_healthy_device += 1

    def record_dispatcher_crash(self) -> None:
        with self._lock:
            self._dispatcher_crashes += 1

    def record_dispatcher_restart(self) -> None:
        with self._lock:
            self._dispatcher_restarts += 1

    def record_pin_prewarm(self) -> None:
        """A background exact-shape warm-up run at streak
        pin_after - 1 (prewarm-on-pin)."""
        with self._lock:
            self._pin_prewarms += 1

    def record_request_attributed_failure(self) -> None:
        """A pooled execution failed with a REQUEST-attributed error
        (``faults.attributes_device`` said the payload, not the device,
        is the culprit) — the device's quarantine streak was NOT
        charged."""
        with self._lock:
            self._request_attributed_failures += 1

    def record_queue_waits(self, waits) -> None:
        """Enqueue->dispatch wait of each request in one dispatched
        bucket (seconds) — the controller's queue-pressure signal. One
        lock acquisition per bucket."""
        with self._lock:
            self._queue_waits.extend(waits)

    def record_device_execute(self, seconds: float) -> None:
        """Dispatch->materialised wall time of one bucket — the
        controller's device-cost signal (on the card this spans the
        asynchronous in-flight window; on the CPU dispatch itself
        computes, so it is close to the dispatch overhead)."""
        with self._lock:
            self._device_exec.append(seconds)

    def record_slo(self, violations) -> None:
        """The SLO watchdog's verdict: the currently-burning objective
        names (empty = within budget). A non-empty set degrades the
        reported health of an otherwise-healthy executor; it never
        masks a worse lifecycle state."""
        with self._lock:
            self._slo_violations = tuple(violations)

    def record_health(self, state: str) -> None:
        """The executor pushes its lifecycle state here on transitions:
        ``healthy`` / ``degraded`` / ``draining`` / ``failed``."""
        with self._lock:
            prev = self._health_state
            self._health_state = state
        if state != prev:
            from .. import obs
            obs.record_event("health.transition", state=state, prev=prev)
            if state in ("degraded", "failed"):
                # a downward lifecycle transition is a flight-recorder
                # auto trigger: capture the black box at the moment the
                # executor's own health report worsens
                obs.maybe_auto_capture("health_" + state, state)

    def record_batch(self, size: int, fused: bool,
                     padded_rows: int = 0, pinned: bool = False,
                     stage_s: float = 0.0,
                     dispatch_s: float = 0.0) -> None:
        """One dispatched bucket: ``size`` live rows through the fused or
        serial path, ``padded_rows`` ladder pad rows it carried (fused
        path only), ``pinned`` when it ran at an exact pinned shape,
        plus its host-side orchestration cost — ``stage_s`` coercing/
        stacking payloads into the staging buffer and its copy to the
        card, ``dispatch_s`` in the plan's call (its launches, which the
        card runs asynchronously; on the CPU the call includes the
        compute itself). One lock
        acquisition per bucket — this is hot-path accounting."""
        with self._lock:
            hist = self._fused_hist if fused else self._serial_hist
            hist[size] = hist.get(size, 0) + 1
            if fused:
                self._fused_batches += 1
                self._fused_rows += int(size)
                self._padded_rows += int(padded_rows)
                if pinned:
                    self._pinned_batches += 1
            else:
                self._serial_batches += 1
            self._stage_s += stage_s
            self._dispatch_s += dispatch_s

    def record_exchange_overlap(self, exchange_s: float,
                                compute_s: float) -> None:
        """Cumulative exchange-vs-compute seconds for one distributed
        dispatch (from the overlap pipeline's recorded spans) — the
        signal pair the ``overlap_chunks`` controller rule diffs."""
        with self._lock:
            self._exchange_s += exchange_s
            self._exchange_compute_s += compute_s

    def record_request_done(self, latency_s: float, failed: bool = False,
                            priority: str = "normal") -> None:
        with self._lock:
            if failed:
                self._failed += 1
            else:
                self._completed += 1
                self._completed_by[priority] += 1
                self._latencies[priority].append(latency_s)
        if not failed and timing.enabled():
            timing.GlobalTimer.record("serve.request", latency_s)

    # -- reading -----------------------------------------------------------
    @property
    def fused_batches(self) -> int:
        with self._lock:
            return self._fused_batches

    @property
    def padded_rows(self) -> int:
        """Total ladder pad rows dispatched so far — ~0 once adaptive
        pinning has locked onto a stable batch size."""
        with self._lock:
            return self._padded_rows

    @property
    def pinned_batches(self) -> int:
        """Buckets dispatched at an exact pinned batch shape."""
        with self._lock:
            return self._pinned_batches

    @property
    def max_fused_batch_size(self) -> int:
        """Largest batch executed through the FUSED path so far (0 when
        none) — reads the fused histogram only, so serial buckets cannot
        inflate it."""
        with self._lock:
            return max(self._fused_hist, default=0)

    # lock: holds(_lock)
    def _health_locked(self) -> Dict:
        """Caller holds the lock — shared by :meth:`health` and the
        single-lock :meth:`snapshot`. The reported state is the
        executor's lifecycle state, degraded by an active SLO burn when
        (and only when) the lifecycle itself is healthy."""
        state = self._health_state
        if state == "healthy" and self._slo_violations:
            state = "degraded"
        return {
            "state": state,
            "lifecycle_state": self._health_state,
            "slo_violations": list(self._slo_violations),
            "request_attributed_failures":
                self._request_attributed_failures,
            "retries": self._retries,
            "retries_exhausted": self._retries_exhausted,
            "retries_by_class": dict(self._retries_by),
            "retries_exhausted_by_class": dict(
                self._retries_exhausted_by),
            "bucket_fallbacks": self._bucket_fallbacks,
            "quarantines": self._quarantines,
            "probations": self._probations,
            "readmissions": self._readmissions,
            "no_healthy_device": self._no_healthy_device,
            "dispatcher_crashes": self._dispatcher_crashes,
            "dispatcher_restarts": self._dispatcher_restarts,
            "pin_prewarms": self._pin_prewarms,
            "purged_expired": self._purged_expired,
        }

    def health(self) -> Dict:
        """One JSON-ready snapshot of the executor's failure-handling
        state: lifecycle state plus every fault-tolerance counter —
        retries, bucket fallbacks, quarantine lifecycle, dispatcher
        crash/restart tallies. This is the operator's first look when a
        service degrades: a climbing ``retries`` with zero
        ``retries_exhausted`` is riding out transients; climbing
        ``quarantines`` names a sick device; ``state == "failed"`` means
        the supervisor gave up and every pending future was failed."""
        with self._lock:
            return self._health_locked()

    def latency_percentiles(
            self, priority: Optional[str] = None) -> Dict[str, float]:
        """p50/p95/p99 over the bounded reservoir — one class when
        ``priority`` is given, all classes merged otherwise."""
        with self._lock:
            if priority is None:
                samples = [s for d in self._latencies.values() for s in d]
            else:
                samples = list(self._latencies[priority])
        return {"p50": percentile(samples, 50.0),
                "p95": percentile(samples, 95.0),
                "p99": percentile(samples, 99.0)}

    def signals(self) -> Dict:
        """The control plane's view: one consistent, JSON-ready dict of
        every signal the feedback controller and SLO watchdog consume —
        recent-window queue-wait / device-execute percentiles,
        cumulative batch/pad/overhead counters and the fused histogram
        (cumulative: the controller diffs successive snapshots itself,
        which keeps this read side stateless). One lock acquisition."""
        with self._lock:
            qw = list(self._queue_waits)
            dx = list(self._device_exec)
            lat = [s for d in self._latencies.values() for s in d]
            out = {
                "completed": self._completed,
                "failed": self._failed,
                "queue_depth": self._queue_depth,
                "max_queue_depth": self._max_queue_depth,
                "rejected_queue_full": self._rejected_queue_full,
                "padded_rows": self._padded_rows,
                "pinned_batches": self._pinned_batches,
                "fused_batches": self._fused_batches,
                "serial_batches": self._serial_batches,
                "fused_rows": self._fused_rows,
                "fused_hist": dict(self._fused_hist),
                "stage_s": self._stage_s,
                "dispatch_s": self._dispatch_s,
                "exchange_s": self._exchange_s,
                "exchange_compute_s": self._exchange_compute_s,
                "quarantines": self._quarantines,
            }
        out["queue_wait_p50"] = percentile(qw, 50.0)
        out["queue_wait_p95"] = percentile(qw, 95.0)
        out["device_execute_p50"] = percentile(dx, 50.0)
        out["device_execute_p95"] = percentile(dx, 95.0)
        out["latency_p99"] = percentile(lat, 99.0)
        return out

    def snapshot(self, registry=None) -> Dict:
        """One JSON-ready dict of everything: counters, latency
        percentiles (merged and per priority class), both batch-size
        histograms, pad-row/pinning counters, orchestration overhead,
        health, platform provenance and (when given) the registry's
        counter snapshot.

        Consistency: every counter,
        the health block and the latency reservoirs are read under ONE
        lock acquisition, so an exporter scraping mid-traffic sees a
        mutually consistent point-in-time view (e.g. ``completed``
        equals the sum of ``completed_by_class``; a retry counted in
        ``health`` has its failure counted too). Platform and registry
        sections read other locks and may trail by a beat."""
        from ..utils.platform import platform_summary
        with self._lock:
            merged: Dict[int, int] = {}
            for hist in (self._fused_hist, self._serial_hist):
                for k, v in hist.items():
                    merged[k] = merged.get(k, 0) + v
            buckets = self._fused_batches + self._serial_batches
            lat = {cls: list(d) for cls, d in self._latencies.items()}
            qw = list(self._queue_waits)
            dx = list(self._device_exec)
            snap = {
                "completed": self._completed,
                "completed_by_class": dict(self._completed_by),
                "failed": self._failed,
                "rejected_queue_full": self._rejected_queue_full,
                "expired_deadline": self._expired_deadline,
                "queue_depth": self._queue_depth,
                "max_queue_depth": self._max_queue_depth,
                "fused_batches": self._fused_batches,
                "serial_batches": self._serial_batches,
                "fused_rows": self._fused_rows,
                "padded_rows": self._padded_rows,
                "pinned_batches": self._pinned_batches,
                "batch_size_histogram": {str(k): v for k, v in
                                         sorted(merged.items())},
                "fused_batch_histogram": {
                    str(k): v for k, v in sorted(self._fused_hist.items())},
                "serial_batch_histogram": {
                    str(k): v for k, v in sorted(self._serial_hist.items())},
                "latency_count": sum(len(d) for d in lat.values()),
                "latency_window": self._window,
                "overhead_seconds": {
                    "stage_total": self._stage_s,
                    "dispatch_total": self._dispatch_s,
                    "per_bucket": ((self._stage_s + self._dispatch_s)
                                   / buckets if buckets else 0.0),
                    "per_request": ((self._stage_s + self._dispatch_s)
                                    / self._completed
                                    if self._completed else 0.0),
                },
                "health": self._health_locked(),
            }
        snap["queue_wait_seconds"] = {
            "p50": percentile(qw, 50.0), "p95": percentile(qw, 95.0),
            "p99": percentile(qw, 99.0)}
        snap["device_execute_seconds"] = {
            "p50": percentile(dx, 50.0), "p95": percentile(dx, 95.0),
            "p99": percentile(dx, 99.0)}
        merged_lat = [s for d in lat.values() for s in d]
        snap["latency_seconds"] = {
            "p50": percentile(merged_lat, 50.0),
            "p95": percentile(merged_lat, 95.0),
            "p99": percentile(merged_lat, 99.0)}
        snap["latency_seconds_by_class"] = {
            cls: {"p50": percentile(lat[cls], 50.0),
                  "p95": percentile(lat[cls], 95.0),
                  "p99": percentile(lat[cls], 99.0)}
            for cls in PRIORITY_CLASSES}
        snap["platform"] = platform_summary()
        if registry is not None:
            snap["registry"] = registry.stats()
        return snap

    def to_json(self, registry=None, indent=None) -> str:
        """THE machine-readable serving summary — the one consistent
        snapshot plus the global timing tree (when any scopes were
        recorded) as one JSON document; ``obs.prometheus_text`` renders
        the same snapshot — one source of truth for exporters."""
        payload = self.snapshot(registry)
        timings = json.loads(timing.GlobalTimer.process().json())
        if timings.get("timings"):
            payload["timings"] = timings["timings"]
        return json.dumps(payload, indent=indent)
