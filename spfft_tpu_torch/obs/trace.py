"""Span tracer: the telemetry core of ``spfft_tpu_torch.obs`` (the port of
``spfft_tpu/obs/trace.py``).

One process-global :class:`Tracer` records spans — named, timestamped
intervals carrying a trace id, a parent link, a track (the row they draw
on in a trace viewer) and a status — plus instant and counter events.
Exporters (:mod:`~spfft_tpu_torch.obs.exporters`) turn the buffer into
Chrome trace-event JSON and Prometheus text.

Lifecycle contract: every span begun is finished exactly once, with
``status="error"`` and the error's type name on failure paths;
:meth:`Tracer.open_count` is the observable.

Cost: tracing is off by default and the disabled path is one
module-global boolean read per checkpoint. Enable with :func:`enable`
or ``SPFFT_TPU_TRACE=1``; ``SPFFT_TPU_TRACE_SAMPLE`` is the fraction of
requests traced (default 1.0; a deterministic accumulator, no RNG). The
buffer is a bounded ring (``SPFFT_TPU_TRACE_BUFFER`` events, default
65536) that counts drops. Spans read the host's clock: around a CUDA
call they time its launch, not its run on the card.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

#: Environment knobs (read at import; enable()/set_sample_rate() override).
TRACE_ENV = "SPFFT_TPU_TRACE"
SAMPLE_ENV = "SPFFT_TPU_TRACE_SAMPLE"
BUFFER_ENV = "SPFFT_TPU_TRACE_BUFFER"

DEFAULT_BUFFER_EVENTS = 65536

_enabled = os.environ.get(TRACE_ENV) == "1"

#: Flight-recorder overrides (set by obs.recorder, never directly):
#: ``_force_sample`` bypasses the head sampler so tail retention sees
#: every request; ``_trace_complete_hook`` is called with
#: ``(tracer, root_span, status, error)`` as each RequestTrace closes.
_force_sample = False
_trace_complete_hook = None


def active() -> bool:
    """The one-boolean disabled-path check every instrumentation point
    starts with. Module-global so the executor's hot path pays a read,
    not an attribute chain."""
    return _enabled


def force_sampling(on: bool) -> None:
    """Recorder seam: make :meth:`Tracer.sample` return True for every
    request while tail retention is armed (head sampling can stay
    off/low — the recorder needs a tail to retain)."""
    global _force_sample
    _force_sample = bool(on)


def set_trace_complete_hook(hook) -> None:
    """Recorder seam: register (or clear, with None) the callable every
    :meth:`RequestTrace.close` notifies after settling its root span.
    Exceptions from the hook are swallowed — trace completion is on
    request-resolution paths and must never fail them."""
    global _trace_complete_hook
    _trace_complete_hook = hook


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


class Span:
    """One named interval. ``track`` names the row it renders on
    (``lane:high``, ``device:0``, ``compile``, ``exchange``);
    ``trace_id`` groups the spans of one request; ``parent_id`` links
    the stage spans under their request root. ``t1 is None`` while
    open."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "track", "t0", "t1", "status", "error", "args")

    def __init__(self, name, cat, trace_id, span_id, parent_id, track,
                 t0, args=None):
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.track = track
        self.t0 = t0
        self.t1: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.args = args

    @property
    def duration(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class TraceContext(NamedTuple):
    """The wire-serializable slice of a span a cross-host RPC carries:
    the trace id (stable end-to-end) and the span id of the remote
    parent. Exposes ``span_id`` so it can stand in for a ``parent=``
    argument on the receiving host — :meth:`Tracer.begin` only reads
    ``parent.span_id``, never the rest of the Span. Build one with
    :meth:`Span.context`, restore with ``RequestTrace(..., ctx=...)``."""

    trace_id: int
    span_id: int

    def to_wire(self) -> dict:
        """Plain-dict form for an RPC payload (loopback or real)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, payload: Optional[dict]) -> Optional["TraceContext"]:
        if not payload:
            return None
        return cls(int(payload["trace_id"]), int(payload["span_id"]))


def span_context(span: Optional[Span]) -> Optional[TraceContext]:
    """The propagatable context of ``span`` (None-safe; None when the
    span carries no trace id — an unsampled request propagates
    nothing)."""
    if span is None or span.trace_id is None:
        return None
    return TraceContext(span.trace_id, span.span_id)


class Tracer:
    """Thread-safe bounded span/event recorder.

    Spans: :meth:`begin` / :meth:`finish` (cross-thread: begin on a
    submitter thread, finish on the dispatcher), :meth:`span` (context
    manager, error status captured), :meth:`complete` (an interval
    measured elsewhere, recorded after the fact — plan builds use it).
    Point events: :meth:`instant` (annotations: retries, quarantines),
    :meth:`counter` (numeric series: per-chunk wire bytes).
    """

    def __init__(self, max_events: Optional[int] = None):
        if max_events is None:
            max_events = int(os.environ.get(BUFFER_ENV,
                                            DEFAULT_BUFFER_EVENTS))
        self._lock = threading.Lock()
        self._max_events = max(1, int(max_events))
        self.epoch = time.perf_counter()
        self._events: deque = deque(maxlen=self._max_events)  #: guarded by _lock
        self._open: Dict[int, Span] = {}  #: guarded by _lock
        # GIL-atomic id sources: begin() stamps ids OUTSIDE the lock
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._spans_started = 0   #: guarded by _lock
        self._spans_closed = 0    #: guarded by _lock
        self._dropped = 0         #: guarded by _lock
        self._sample_rate = self._env_sample_rate()  #: guarded by _lock
        self._sample_acc = 0.0    #: guarded by _lock

    @staticmethod
    def _env_sample_rate() -> float:
        try:
            rate = float(os.environ.get(SAMPLE_ENV, "1.0"))
        except ValueError:
            rate = 1.0
        return min(1.0, max(0.0, rate))

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        """Drop every buffered event and open span and restart the
        clock (the bench CLI separates warmup from the measured replay
        this way). Quiesce instrumented executors first — a span begun
        before a reset is silently forgotten, not closed."""
        with self._lock:
            self.epoch = time.perf_counter()
            self._events.clear()
            self._open.clear()
            self._spans_started = 0
            self._spans_closed = 0
            self._dropped = 0
            self._sample_acc = 0.0

    def set_sample_rate(self, rate: float) -> None:
        with self._lock:
            self._sample_rate = min(1.0, max(0.0, float(rate)))
            self._sample_acc = 0.0

    def sample(self) -> bool:
        """Deterministic rate sampler: returns True for exactly
        ``sample_rate`` of calls (accumulator, no RNG — a replayed
        trace samples the same requests)."""
        if _force_sample:
            return True
        with self._lock:
            self._sample_acc += self._sample_rate
            if self._sample_acc >= 1.0 - 1e-12:
                self._sample_acc -= 1.0
                return True
            return False

    def new_trace_id(self) -> int:
        return next(self._trace_ids)

    # -- spans --------------------------------------------------------------
    def begin(self, name: str, cat: str = "serve",
              trace_id: Optional[int] = None,
              parent: Optional[Span] = None,
              track: Optional[str] = None,
              args: Optional[dict] = None) -> Span:
        span = Span(name, cat, trace_id, next(self._span_ids),
                    parent.span_id if parent is not None else None,
                    track, time.perf_counter(), args)
        with self._lock:
            self._spans_started += 1
            self._open[span.span_id] = span
        return span

    def finish(self, span: Optional[Span], status: str = "ok",
               error: Optional[str] = None,
               args: Optional[dict] = None) -> None:
        """Close ``span`` (idempotent — a second finish is a no-op, so
        failure paths can close defensively)."""
        if span is None:
            return
        with self._lock:
            if self._open.pop(span.span_id, None) is None:
                return  # already closed
            span.t1 = time.perf_counter()
            span.status = status
            if error is not None:
                span.error = error
            if args:
                span.args = dict(span.args or {}, **args)
            self._spans_closed += 1
            self._append_locked(span)

    def complete(self, name: str, t0: float, t1: float,
                 cat: str = "serve", trace_id: Optional[int] = None,
                 parent: Optional[Span] = None,
                 track: Optional[str] = None, status: str = "ok",
                 error: Optional[str] = None,
                 args: Optional[dict] = None) -> Span:
        """Record an interval measured by the caller (never counted
        open)."""
        span = Span(name, cat, trace_id, next(self._span_ids),
                    parent.span_id if parent is not None else None,
                    track, t0, args)
        span.t1 = t1
        span.status = status
        span.error = error
        with self._lock:
            self._spans_started += 1
            self._spans_closed += 1
            self._append_locked(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, **kwargs):
        sp = self.begin(name, **kwargs)
        try:
            yield sp
        except BaseException as exc:
            self.finish(sp, status="error", error=type(exc).__name__)
            raise
        else:
            self.finish(sp)

    # -- point events -------------------------------------------------------
    def instant(self, name: str, cat: str = "serve",
                track: Optional[str] = None,
                trace_id: Optional[int] = None,
                args: Optional[dict] = None) -> None:
        with self._lock:
            self._append_locked({"type": "instant", "name": name,
                                 "cat": cat, "track": track,
                                 "trace_id": trace_id,
                                 "ts": time.perf_counter(),
                                 "args": args})

    def counter(self, name: str, values: Dict[str, float],
                cat: str = "serve", track: Optional[str] = None) -> None:
        """One sample of a numeric series (renders as a stacked counter
        track in Perfetto)."""
        with self._lock:
            self._append_locked({"type": "counter", "name": name,
                                 "cat": cat, "track": track,
                                 "ts": time.perf_counter(),
                                 "args": dict(values)})

    # lock: holds(_lock)
    def _append_locked(self, event) -> None:
        if len(self._events) >= self._max_events:
            self._dropped += 1
        self._events.append(event)

    # -- reading ------------------------------------------------------------
    def events(self) -> List:
        """Snapshot of the buffered CLOSED events (spans + instants +
        counters), oldest first."""
        with self._lock:
            return list(self._events)

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def open_names(self) -> List[str]:
        """Names of still-open spans — the zero-leak test's diagnostic."""
        with self._lock:
            return sorted(s.name for s in self._open.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"started": self._spans_started,
                    "closed": self._spans_closed,
                    "open": len(self._open),
                    "buffered": len(self._events),
                    "dropped": self._dropped,
                    "sample_rate": self._sample_rate}


class RequestTrace:
    """Per-request trace handle the serving executor threads through
    its pipeline. Owns the ``serve.request`` root span plus whichever
    per-request stage spans are currently open; :meth:`close` settles
    EVERYTHING still open — the single call every resolution path
    (success, typed failure, crash sweep) funnels through, which is how
    the zero-unclosed-spans guarantee holds."""

    __slots__ = ("tracer", "trace_id", "lane", "root", "open")

    def __init__(self, tracer: Tracer, lane: str,
                 args: Optional[dict] = None,
                 ctx: Optional[TraceContext] = None):
        self.tracer = tracer
        # A propagated context (cross-host RPC) pins the trace id and
        # parents this request's root under the remote frontend span —
        # one trace id end-to-end, frontend parent / host-lane child.
        self.trace_id = ctx.trace_id if ctx is not None \
            else tracer.new_trace_id()
        self.lane = f"lane:{lane}"
        # span: closed-by(RequestTrace.close)
        self.root = tracer.begin("serve.request", trace_id=self.trace_id,
                                 parent=ctx, track=self.lane, args=args)
        self.open: Dict[str, Span] = {}

    def context(self) -> Optional[TraceContext]:
        """Propagatable context of this request's root span (None once
        closed)."""
        return span_context(self.root)

    def begin(self, name: str, track: Optional[str] = None,
              args: Optional[dict] = None) -> Span:
        # span: closed-by(RequestTrace.finish)
        sp = self.tracer.begin(name, trace_id=self.trace_id,
                               parent=self.root,
                               track=track or self.lane, args=args)
        self.open[name] = sp
        return sp

    def finish(self, name: str, status: str = "ok",
               error: Optional[str] = None) -> None:
        sp = self.open.pop(name, None)
        if sp is not None:
            self.tracer.finish(sp, status=status, error=error)

    def annotate(self, name: str, **args) -> None:
        """Attach a point annotation (retry, bucket fallback, ...) to
        this request's trace."""
        self.tracer.instant(name, track=self.lane,
                            trace_id=self.trace_id, args=args or None)

    def close(self, status: str = "ok",
              error: Optional[str] = None) -> None:
        for name in list(self.open):
            self.finish(name, status=status, error=error)
        root = self.root
        if root is not None:
            self.tracer.finish(root, status=status, error=error)
            self.root = None
            hook = _trace_complete_hook
            if hook is not None:
                try:
                    hook(self.tracer, root, status, error)
                except Exception:  # never fail a resolution path
                    pass


#: Process-global tracer (the exporters' and executor's default).
GLOBAL_TRACER = Tracer()
