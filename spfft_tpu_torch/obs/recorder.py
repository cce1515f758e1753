"""Flight recorder: event journal, tail-retained traces, incident bundles
(the port of ``spfft_tpu/obs/recorder.py``).

* **Event journal** — one process-global, bounded ring of typed events.
  Each decision seam that counts also records one :func:`record_event`:
  wire-rung resolutions and declines, fused-kernel demotions and
  re-probes, knob moves, fault firings, incident captures. Kinds and
  their attribute keys are declared in :data:`EVENT_SPECS` (the JAX
  package's, kind for kind); undeclared kinds and attributes are counted
  and dropped, never raised.
* **Tail-based trace retention** — completed request traces land in a
  holding ring and are promoted to a retained ring when they errored,
  ran over a latency threshold or were flagged (:func:`flag_trace`).
  Enabling the recorder turns span recording on and bypasses the head
  sampler, so there is a tail to retain.
* **Incident bundles** — :func:`capture_incident` atomically writes a
  versioned JSON bundle (journal, retained traces as Chrome trace
  events, a Prometheus snapshot, knob values and their history, health,
  platform) under a bounded incident directory. The format is the JAX
  package's: a bundle of either package passes the other's
  :func:`validate_bundle`.

Cost: the journal is always on (a lock and a deque append per event);
trace retention costs one module-global read per request while the
recorder is off. :func:`overhead_probe` measures both paths. A failing
bundle write is typed and non-fatal (the ``obs.capture`` fault site).
"""

from __future__ import annotations

import json
import os
import platform as _platform
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from .counters import GLOBAL_COUNTERS
from . import trace as _trace
from .trace import GLOBAL_TRACER, Span, Tracer

#: Environment knobs (read at enable time; arguments override).
RECORDER_ENV = "SPFFT_TPU_RECORDER"
EVENT_BUFFER_ENV = "SPFFT_TPU_EVENT_BUFFER"
INCIDENT_DIR_ENV = "SPFFT_TPU_INCIDENT_DIR"
INCIDENT_KEEP_ENV = "SPFFT_TPU_INCIDENT_KEEP"
INCIDENT_MIN_INTERVAL_ENV = "SPFFT_TPU_INCIDENT_MIN_INTERVAL_S"
HOLD_RING_ENV = "SPFFT_TPU_RECORDER_HOLD"
RETAIN_RING_ENV = "SPFFT_TPU_RECORDER_RETAIN"
SLOW_FACTOR_ENV = "SPFFT_TPU_RECORDER_SLOW_FACTOR"
SLOW_ABS_ENV = "SPFFT_TPU_RECORDER_SLOW_S"

DEFAULT_EVENT_BUFFER = 4096
DEFAULT_HOLD = 256
DEFAULT_RETAIN = 32
DEFAULT_INCIDENT_KEEP = 16
DEFAULT_MIN_INTERVAL_S = 30.0
#: Default p99-relative promotion threshold: a trace slower than
#: ``factor * latency_p99`` of the live reservoir is retained.
DEFAULT_SLOW_FACTOR = 3.0

#: Bundle format version (validators refuse unknown majors).
BUNDLE_VERSION = 1

#: The event-kind registry: every journal event any part of the process
#: emits — through :func:`record_event` — declared exactly once, as
#: ``kind: (category, help, declared attr keys)``, the JAX package's
#: table. :func:`record_event` drops undeclared kinds/attrs (counted,
#: never raising).
EVENT_SPECS: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    # control plane
    "control.knob":
        ("control", "Accepted control-plane knob move (controller or "
                    "operator; config.set is the single funnel).",
         ("knob", "old", "new", "reason", "source")),
    "slo.alert":
        ("control", "SLO multi-window page condition entered (rising "
                    "edge of spfft_slo_window_alerts_total).",
         ("slo",)),
    # distributed wire precision ladder
    "wire.resolve":
        ("exchange", "Wire-compression rung resolved at plan build.",
         ("requested", "resolved", "probe_error")),
    "wire.decline":
        ("exchange", "One wire rung declined during resolution, with "
                     "the typed reason.",
         ("rung", "reason")),
    # fused-kernel runtime demotion ladder
    "fused.demote":
        ("plan", "Fused kernel direction demoted to the unfused "
                 "composition after a device-attributed failure.",
         ("which", "reason", "permanent")),
    "fused.readmit":
        ("plan", "Fused kernel direction readmitted after a "
                 "successful re-probe.",
         ("which", "probes")),
    # serving executor device pool + lifecycle
    "device.quarantine":
        ("serve", "Pool device quarantined after consecutive "
                  "device-attributed failures.",
         ("device", "backoff_s")),
    "device.probation":
        ("serve", "Quarantined device entered probation (one canary "
                  "request).",
         ("device", "backoff_s")),
    "device.readmit":
        ("serve", "Probation canary succeeded; device readmitted.",
         ("device",)),
    "health.transition":
        ("serve", "Executor lifecycle state change (healthy/degraded/"
                  "draining/failed).",
         ("state", "prev")),
    # plan-artifact store degradation ladder
    "store.degrade":
        ("store", "Plan-artifact store degraded to the memory-only "
                  "tier after a persistent disk fault.",
         ("reason", "interval_s")),
    "store.reprobe":
        ("store", "Degraded-store disk re-probe outcome.",
         ("outcome",)),
    # plan registry
    "registry.build_failure":
        ("compile", "A registry plan build raised (the failure is "
                    "broadcast to every coalesced waiter).",
         ("error",)),
    # pod cluster lane lifecycle
    "lane.death":
        ("cluster", "Host lane marked dead by the pod frontend.",
         ("host",)),
    "lane.probe":
        ("cluster", "Resurrection-ladder health probe of a dead lane.",
         ("host", "outcome")),
    "lane.readmit":
        ("cluster", "Dead lane readmitted after a successful probe "
                    "and strict prewarm.",
         ("host",)),
    # lease-based membership
    "membership.transition":
        ("membership", "Lease-ladder state transition at the view "
                       "coordinator (epoch bump).",
         ("host", "to", "epoch")),
    "membership.elect":
        ("membership", "A node promoted itself coordinator (election "
                       "over the adopted view).",
         ("host", "epoch")),
    # package-wide fault seam
    "fault.fired":
        ("faults", "A FaultPlan checkpoint fired an injected fault.",
         ("site", "kind")),
    # the recorder itself
    "incident.capture":
        ("obs", "An incident bundle capture was attempted.",
         ("reason", "outcome")),
}


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _scalar(v):
    """JSON-safe attribute value (numpy scalars and exceptions become
    strings; containers are repr-trimmed)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return v.item()
    except Exception:  # pragma: no cover - numpy always present here
        pass
    return str(v)[:200]


class EventJournal:
    """Bounded, thread-safe ring of typed events (the black box's
    decision log). Always on: appends are a lock + deque push."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = _env_int(EVENT_BUFFER_ENV, DEFAULT_EVENT_BUFFER)
        self._lock = threading.Lock()
        self._capacity = max(16, int(capacity))
        self._ring: deque = deque(maxlen=self._capacity)  #: guarded by _lock
        self._seq = 0        #: guarded by _lock
        self._dropped = 0    #: guarded by _lock

    def record(self, kind: str, attrs: Dict) -> None:
        spec = EVENT_SPECS.get(kind)
        if spec is None:
            GLOBAL_COUNTERS.inc("spfft_recorder_events_dropped_total",
                                reason="undeclared_kind")
            return
        declared = spec[2]
        clean = {k: _scalar(v) for k, v in attrs.items()
                 if k in declared}
        entry = {"kind": kind, "cat": spec[0], "ts": time.time(),
                 "attrs": clean}
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            if len(self._ring) >= self._capacity:
                self._dropped += 1
            self._ring.append(entry)
        GLOBAL_COUNTERS.inc("spfft_recorder_events_total", kind=kind)

    def snapshot(self, limit: Optional[int] = None) -> List[Dict]:
        """Oldest-first copy of the buffered events (the bundle's
        journal slice); ``limit`` keeps the most recent N."""
        with self._lock:
            events = list(self._ring)
        if limit is not None and len(events) > limit:
            events = events[-int(limit):]
        return events

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"buffered": len(self._ring), "seq": self._seq,
                    "dropped": self._dropped,
                    "capacity": self._capacity}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._dropped = 0


#: Process-global journal (the single sink record_event feeds).
GLOBAL_JOURNAL = EventJournal()


def record_event(kind: str, /, **attrs) -> None:
    """Append one typed event to the process journal. ``kind`` must be
    declared in :data:`EVENT_SPECS` (undeclared kinds are counted and
    dropped, never raised — the decision seams this is called from
    must not gain a new failure mode). This is the ONE line a
    subsystem adds per decision seam, next to its existing counter."""
    GLOBAL_JOURNAL.record(kind, attrs)


# ---------------------------------------------------------------------------
# tail-based trace retention
# ---------------------------------------------------------------------------

class _Retention:
    """Holding + retained rings for completed request traces."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hold_cap = _env_int(HOLD_RING_ENV, DEFAULT_HOLD)
        self._retain_cap = _env_int(RETAIN_RING_ENV, DEFAULT_RETAIN)
        #: holding ring: trace_id -> completion meta  (guarded by _lock)
        self._holding: "deque[dict]" = deque(maxlen=self._hold_cap)
        #: retained ring: promoted trace dicts  (guarded by _lock)
        self._retained: "deque[dict]" = deque(maxlen=self._retain_cap)
        self._slow_factor = _env_float(SLOW_FACTOR_ENV,
                                       DEFAULT_SLOW_FACTOR)
        self._slow_abs = _env_float(SLOW_ABS_ENV, 0.0)
        #: cached p99 threshold + closes since refresh (guarded by _lock)
        self._p99_cache = 0.0
        self._p99_age = 0
        self._latency_fn: Optional[Callable[[], float]] = None

    def set_latency_source(self, fn: Optional[Callable[[], float]]):
        """Register a zero-arg callable returning the live latency p99
        in seconds (``ServeMetrics`` wires its reservoir here); the
        slow-promotion threshold is ``slow_factor * p99``, refreshed
        every 64 completions so the hot path never recomputes
        percentiles per request."""
        with self._lock:
            self._latency_fn = fn
            self._p99_age = 64  # force refresh on next completion

    def _slow_threshold_locked(self) -> float:
        self._p99_age += 1
        if self._p99_age >= 64 and self._latency_fn is not None:
            self._p99_age = 0
            try:
                self._p99_cache = float(self._latency_fn() or 0.0)
            except Exception:
                self._p99_cache = 0.0
        if self._p99_cache > 0.0:
            return self._slow_factor * self._p99_cache
        return self._slow_abs  # 0.0 disables slow promotion

    def note_complete(self, tracer: Tracer, root: Span, status: str,
                      error: Optional[str]) -> None:
        meta = {"trace_id": root.trace_id, "name": root.name,
                "status": status, "error": error,
                "duration_s": root.duration, "ts": time.time()}
        reason = None
        with self._lock:
            self._holding.append(meta)
            if status != "ok" or error:
                reason = "error"
            else:
                thresh = self._slow_threshold_locked()
                if thresh > 0.0 and root.duration > thresh:
                    reason = "slow"
        if reason is not None:
            self._promote(tracer, meta, reason)

    def flag(self, trace_id: int, tracer: Optional[Tracer] = None,
             reason: str = "flagged") -> bool:
        """Explicitly promote a held (or still-buffered) trace."""
        tracer = tracer or GLOBAL_TRACER
        with self._lock:
            meta = next((m for m in self._holding
                         if m["trace_id"] == trace_id), None)
        if meta is None:
            meta = {"trace_id": trace_id, "name": "serve.request",
                    "status": "ok", "error": None, "duration_s": 0.0,
                    "ts": time.time()}
        return self._promote(tracer, meta, reason)

    def _promote(self, tracer: Tracer, meta: dict, reason: str) -> bool:
        from .exporters import trace_events
        tid = meta["trace_id"]
        raw = [ev for ev in tracer.events()
               if (ev.trace_id if isinstance(ev, Span)
                   else ev.get("trace_id")) == tid]
        entry = dict(meta)
        entry["reason"] = reason
        entry["events"] = trace_events(tracer, events=raw, bare=True)
        with self._lock:
            # idempotent per trace id: a flag after an error-promotion
            # replaces rather than duplicates
            for i, old in enumerate(self._retained):
                if old["trace_id"] == tid:
                    self._retained[i] = entry
                    break
            else:
                self._retained.append(entry)
        GLOBAL_COUNTERS.inc("spfft_recorder_traces_retained_total",
                            reason=reason)
        return bool(raw)

    def retained(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._retained]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"holding": len(self._holding),
                    "retained": len(self._retained)}

    def reset(self) -> None:
        with self._lock:
            self._holding.clear()
            self._retained.clear()
            self._p99_cache = 0.0
            self._p99_age = 0


_RETENTION = _Retention()

# -- recorder lifecycle -----------------------------------------------------

_lifecycle_lock = threading.Lock()
_active = False
_incident_dir: Optional[str] = None
_incident_keep = DEFAULT_INCIDENT_KEEP
_min_interval_s = DEFAULT_MIN_INTERVAL_S
_auto = True
_last_auto = 0.0
_incident_seq = 0
_capture_lock = threading.Lock()
#: optional pod-wide capturer (PodFrontend.capture_incident) the auto
#: triggers route through instead of a local-only bundle
_capturer: Optional[Callable[[str], Optional[str]]] = None
#: optional health-snapshot provider for the bundle (executor/pod)
_health_fn: Optional[Callable[[], dict]] = None


def recorder_active() -> bool:
    """One module-global boolean: is tail retention armed?"""
    return _active


def enable_recorder(incident_dir: Optional[str] = None,
                    keep: Optional[int] = None,
                    min_interval_s: Optional[float] = None,
                    auto: bool = True) -> None:
    """Arm the flight recorder: force span recording on (bypassing the
    head sampler — there must be a tail to retain), configure the
    incident directory (argument > ``SPFFT_TPU_INCIDENT_DIR`` env >
    disabled) and the auto-capture debounce. Idempotent."""
    global _active, _incident_dir, _incident_keep, _min_interval_s, \
        _auto, _last_auto
    with _lifecycle_lock:
        _active = True
        _incident_dir = (incident_dir
                         or os.environ.get(INCIDENT_DIR_ENV) or None)
        _incident_keep = max(1, keep if keep is not None
                             else _env_int(INCIDENT_KEEP_ENV,
                                           DEFAULT_INCIDENT_KEEP))
        _min_interval_s = (min_interval_s if min_interval_s is not None
                           else _env_float(INCIDENT_MIN_INTERVAL_ENV,
                                           DEFAULT_MIN_INTERVAL_S))
        _auto = bool(auto)
        _last_auto = 0.0
    _trace.enable()
    _trace.force_sampling(True)
    _trace.set_trace_complete_hook(_RETENTION.note_complete)


def disable_recorder() -> None:
    """Disarm tail retention and the auto triggers (the journal stays
    on — it is the always-on black box). Does NOT disable tracing:
    callers that enabled it separately keep their spans."""
    global _active, _capturer, _health_fn
    with _lifecycle_lock:
        _active = False
        _capturer = None
        _health_fn = None
    _trace.force_sampling(False)
    _trace.set_trace_complete_hook(None)
    _RETENTION.reset()


def recorder_from_env() -> bool:
    """Arm the recorder when ``SPFFT_TPU_RECORDER=1`` (embedders call
    this once at boot; returns whether it armed)."""
    if os.environ.get(RECORDER_ENV) == "1":
        enable_recorder()
        return True
    return False


def set_incident_capturer(fn: Optional[Callable[[str], Optional[str]]]
                          ) -> None:
    """Route auto captures through ``fn(reason) -> path`` (the pod
    frontend registers its pod-wide capture here); None restores the
    local-bundle default."""
    global _capturer
    with _lifecycle_lock:
        _capturer = fn


def set_health_provider(fn: Optional[Callable[[], dict]]) -> None:
    """Register the health snapshot the bundle embeds (an executor's
    or pod frontend's ``health()``)."""
    global _health_fn
    with _lifecycle_lock:
        _health_fn = fn


def set_latency_source(fn: Optional[Callable[[], float]]) -> None:
    """See :meth:`_Retention.set_latency_source`."""
    _RETENTION.set_latency_source(fn)


def flag_trace(trace_id: int, reason: str = "flagged") -> bool:
    """Explicitly retain a completed trace by id."""
    return _RETENTION.flag(trace_id, reason=reason)


def retained_traces() -> List[dict]:
    """Snapshot of the retained (promoted) traces."""
    return _RETENTION.retained()


def recorder_stats() -> Dict:
    """Journal + retention counters (tests and ops)."""
    out = dict(GLOBAL_JOURNAL.stats())
    out.update(_RETENTION.stats())
    out["active"] = _active
    out["incident_dir"] = _incident_dir
    return out


def reset_recorder() -> None:
    """Drop journal + rings (bench/test isolation; keeps the armed
    state and configuration)."""
    GLOBAL_JOURNAL.reset()
    _RETENTION.reset()


# ---------------------------------------------------------------------------
# incident bundles
# ---------------------------------------------------------------------------

def build_incident_bundle(reason: str, host: Optional[str] = None
                          ) -> dict:
    """One self-contained, JSON-clean snapshot of everything the black
    box knows right now. Never raises — a section that fails to render
    degrades to an ``{"error": ...}`` stub (recording must never take
    down serving)."""
    bundle = {
        "version": BUNDLE_VERSION,
        "kind": "host",
        "reason": str(reason),
        "host": host or f"pid-{os.getpid()}",
        "captured_at": time.time(),
        "events": GLOBAL_JOURNAL.snapshot(),
        "traces": _RETENTION.retained(),
        "recorder": recorder_stats(),
    }
    try:
        from .exporters import prometheus_text
        bundle["prometheus"] = prometheus_text()
    except Exception as exc:
        bundle["prometheus"] = ""
        bundle["prometheus_error"] = repr(exc)[:200]
    try:
        from ..control.config import global_config
        cfg = global_config()
        bundle["config"] = {"knobs": cfg.snapshot(),
                            "history": cfg.decisions()}
    except Exception as exc:
        bundle["config"] = {"error": repr(exc)[:200]}
    fn = _health_fn
    if fn is not None:
        try:
            bundle["health"] = fn()
        except Exception as exc:
            bundle["health"] = {"error": repr(exc)[:200]}
    else:
        bundle["health"] = {}
    bundle["platform"] = {
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
        "pid": os.getpid(),
    }
    return bundle


def _gc_incident_dir(directory: str, keep: int) -> None:
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("incident-") and n.endswith(".json")]
        if len(names) <= keep:
            return
        paths = sorted((os.path.join(directory, n) for n in names),
                       key=lambda p: (os.path.getmtime(p), p))
        for path in paths[:len(paths) - keep]:
            os.unlink(path)
    except OSError:  # pragma: no cover - GC is best-effort
        pass


def write_bundle(bundle: dict, directory: Optional[str] = None,
                 keep: Optional[int] = None) -> str:
    """Atomically persist ``bundle`` under the incident dir (tmp-file +
    rename — a crashed writer leaves a ``.tmp``, never a torn
    ``.json``), then GC the directory down to ``keep`` bundles.
    Raises on failure; :func:`capture_incident` is the non-fatal
    wrapper."""
    global _incident_seq
    directory = (directory or _incident_dir
                 or os.environ.get(INCIDENT_DIR_ENV))
    if not directory:
        raise ValueError("no incident directory configured "
                         f"(enable_recorder(incident_dir=...) or "
                         f"{INCIDENT_DIR_ENV})")
    keep = keep if keep is not None else _incident_keep
    os.makedirs(directory, exist_ok=True)
    with _lifecycle_lock:
        _incident_seq += 1
        seq = _incident_seq
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    name = f"incident-{stamp}-{os.getpid()}-{seq:04d}.json"
    path = os.path.join(directory, name)
    tmp = path + ".tmp"
    from .. import faults as _faults
    try:
        _faults.check_site("obs.capture")
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _gc_incident_dir(directory, keep)
    return path


def capture_incident(reason: str, directory: Optional[str] = None,
                     host: Optional[str] = None) -> Optional[str]:
    """Build + atomically write a local incident bundle; returns the
    path, or None when the write failed (typed, counted, non-fatal —
    the ``obs.capture`` fault site fires here in chaos storms).
    Serialized: concurrent captures queue on one lock."""
    with _capture_lock:
        bundle = build_incident_bundle(reason, host=host)
        try:
            path = write_bundle(bundle, directory=directory)
        except Exception as exc:
            GLOBAL_COUNTERS.inc("spfft_recorder_incident_failures_total")
            record_event("incident.capture", reason=reason,
                         outcome=f"failed: {type(exc).__name__}")
            return None
    GLOBAL_COUNTERS.inc("spfft_recorder_incidents_total",
                        trigger=reason.split(":", 1)[0])
    record_event("incident.capture", reason=reason, outcome="written")
    return path


def maybe_auto_capture(trigger: str, reason: Optional[str] = None
                       ) -> Optional[str]:
    """Debounced auto-capture hook the decision seams call on their
    rising edges (SLO page, health degrade/fail, lane death). No-op
    unless the recorder is armed, auto capture is on, an incident dir
    (or pod capturer) is configured, and the debounce interval has
    passed. Never raises."""
    global _last_auto
    if not _active or not _auto:
        return None
    capturer = _capturer
    if capturer is None and not (_incident_dir
                                 or os.environ.get(INCIDENT_DIR_ENV)):
        return None
    now = time.monotonic()
    with _lifecycle_lock:
        if _last_auto and now - _last_auto < _min_interval_s:
            return None
        _last_auto = now
    full = f"{trigger}:{reason}" if reason else trigger
    try:
        if capturer is not None:
            return capturer(full)
        return capture_incident(full)
    except Exception:  # pragma: no cover - capturers are non-fatal
        GLOBAL_COUNTERS.inc("spfft_recorder_incident_failures_total")
        return None


# ---------------------------------------------------------------------------
# pod bundles + validation
# ---------------------------------------------------------------------------

def merge_pod_bundle(reason: str, host_bundles: Dict[str, dict]) -> dict:
    """Merge per-host bundles into one pod bundle with a single
    host-labelled timeline (events sorted by wall timestamp, then
    per-host sequence — one ordered story across the pod)."""
    timeline: List[dict] = []
    for host, sub in host_bundles.items():
        for ev in (sub or {}).get("events", ()):
            ev = dict(ev)
            ev["host"] = host
            timeline.append(ev)
    timeline.sort(key=lambda e: (e.get("ts", 0.0), e.get("host", ""),
                                 e.get("seq", 0)))
    return {
        "version": BUNDLE_VERSION,
        "kind": "pod",
        "reason": str(reason),
        "captured_at": time.time(),
        "hosts": dict(host_bundles),
        "timeline": timeline,
    }


def validate_bundle(bundle: dict) -> List[str]:
    """Structural schema validation of a host or pod bundle; returns a
    list of failure messages (empty = valid). The round-trip check the
    chaos harness and tier-1 incident test run over every captured
    file."""
    failures: List[str] = []
    if not isinstance(bundle, dict):
        return ["bundle is not a JSON object"]
    if bundle.get("version") != BUNDLE_VERSION:
        failures.append(f"unknown bundle version "
                        f"{bundle.get('version')!r}")
    kind = bundle.get("kind")
    if kind not in ("host", "pod"):
        failures.append(f"unknown bundle kind {kind!r}")
    if not isinstance(bundle.get("reason"), str):
        failures.append("reason missing or not a string")
    if not isinstance(bundle.get("captured_at"), (int, float)):
        failures.append("captured_at missing or not a number")
    if kind == "pod":
        hosts = bundle.get("hosts")
        if not isinstance(hosts, dict) or not hosts:
            failures.append("pod bundle has no hosts")
            hosts = {}
        for host, sub in hosts.items():
            if isinstance(sub, dict) and "error" in sub \
                    and "version" not in sub:
                continue  # unreachable host's typed error stub
            for msg in validate_bundle(sub):
                failures.append(f"host {host}: {msg}")
        timeline = bundle.get("timeline")
        if not isinstance(timeline, list):
            failures.append("pod bundle timeline missing")
        else:
            last = None
            for i, ev in enumerate(timeline):
                key = (ev.get("ts", 0.0), ev.get("host", ""),
                       ev.get("seq", 0))
                if last is not None and key < last:
                    failures.append(f"timeline event {i} out of order")
                    break
                last = key
        return failures
    events = bundle.get("events")
    if not isinstance(events, list):
        failures.append("events missing or not a list")
        events = []
    prev = None
    for i, ev in enumerate(events):
        kind_ = ev.get("kind")
        spec = EVENT_SPECS.get(kind_)
        if spec is None:
            failures.append(f"event {i}: undeclared kind {kind_!r}")
            continue
        attrs = ev.get("attrs")
        if not isinstance(attrs, dict):
            failures.append(f"event {i} ({kind_}): attrs missing")
            continue
        extra = set(attrs) - set(spec[2])
        if extra:
            failures.append(f"event {i} ({kind_}): undeclared attrs "
                            f"{sorted(extra)}")
        if not isinstance(ev.get("ts"), (int, float)):
            failures.append(f"event {i} ({kind_}): bad ts")
        seq = ev.get("seq")
        if not isinstance(seq, int):
            failures.append(f"event {i} ({kind_}): bad seq")
        elif prev is not None and seq <= prev:
            failures.append(f"event {i} ({kind_}): seq not "
                            f"monotonic")
        else:
            prev = seq
    traces = bundle.get("traces")
    if not isinstance(traces, list):
        failures.append("traces missing or not a list")
        traces = []
    for i, tr in enumerate(traces):
        if not isinstance(tr.get("trace_id"), int):
            failures.append(f"trace {i}: bad trace_id")
        if tr.get("reason") not in ("error", "slow", "flagged"):
            failures.append(f"trace {i}: unknown retention reason "
                            f"{tr.get('reason')!r}")
        evs = tr.get("events")
        if not isinstance(evs, list):
            failures.append(f"trace {i}: events missing")
            continue
        for j, ev in enumerate(evs):
            if ev.get("ph") not in ("X", "i", "C"):
                failures.append(f"trace {i} event {j}: bad ph "
                                f"{ev.get('ph')!r}")
                break
    prom = bundle.get("prometheus")
    if isinstance(prom, str) and prom:
        from .exporters import parse_prometheus_text
        try:
            parse_prometheus_text(prom)
        except ValueError as exc:
            failures.append(f"prometheus snapshot invalid: {exc}")
    elif not bundle.get("prometheus_error"):
        failures.append("prometheus snapshot missing")
    cfg = bundle.get("config")
    if not isinstance(cfg, dict):
        failures.append("config section missing")
    elif "error" not in cfg:
        if not isinstance(cfg.get("knobs"), dict):
            failures.append("config knobs missing")
        if not isinstance(cfg.get("history"), list):
            failures.append("config history missing")
    if not isinstance(bundle.get("platform"), dict):
        failures.append("platform section missing")
    return failures


# ---------------------------------------------------------------------------
# overhead probe (the recorder_overhead bench row)
# ---------------------------------------------------------------------------

def overhead_probe(requests: int = 2000, repeats: int = 7,
                   stages: int = 4) -> Dict[str, float]:
    """Deterministic micro A/B of the serve hot path's recorder cost:
    each simulated request walks the executor's instrumentation
    checkpoints (``active()`` gate per stage, a ``RequestTrace`` with
    ``stages`` stage spans and the tail-retention close hook when
    armed) against a private tracer. Returns best-of-``repeats``
    per-request times in microseconds — min, not median: the probe
    measures the recorder's algorithmic cost, and on a loaded
    container every slow repeat is scheduler noise ADDED to that cost,
    so the minimum is the noise-immune statistic (medians swung 17-28
    us run-to-run under load). ``off_us`` is the recorder-disarmed
    path (the round-10 <= 1% budget: one module-global read per
    checkpoint), ``on_us`` the armed path (spans + holding-ring
    append), ``delta_us`` the gated difference."""
    from .trace import RequestTrace, active

    def run(on: bool) -> float:
        times = []
        tracer = Tracer(max_events=requests * (stages + 2))
        hook = _RETENTION.note_complete if on else None
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(requests):
                if on:
                    tr = RequestTrace(tracer, "probe")
                    for s in range(stages):
                        tr.begin(f"stage{s}")
                        tr.finish(f"stage{s}")
                    # the close hook is what ships the tail
                    root = tr.root
                    tr.close()
                    if hook is not None and root is not None:
                        hook(tracer, root, "ok", None)
                else:
                    for _ in range(stages + 2):
                        if active():  # pragma: no cover - off by design
                            raise RuntimeError("probe expects tracing "
                                               "disabled")
            times.append(time.perf_counter() - t0)
            tracer.reset()
        return min(times) / requests * 1e6

    was_enabled = _trace.active()
    _trace.disable()
    try:
        off_us = run(False)
        on_us = run(True)
    finally:
        if was_enabled:
            _trace.enable()
        _RETENTION.reset()
    return {"off_us": off_us, "on_us": on_us,
            "delta_us": max(0.0, on_us - off_us),
            "requests": requests, "repeats": repeats}
