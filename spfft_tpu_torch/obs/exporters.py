"""Exporters: Chrome trace-event JSON and Prometheus text exposition (the
port of ``spfft_tpu/obs/exporters.py``).

* :func:`export_trace` writes the Chrome trace-event format (the
  ``{"traceEvents": [...]}`` JSON that Perfetto and chrome://tracing
  open): one named track per row (``compile``, ``exchange``, lanes),
  spans as complete ("X") events with trace id / status / error in their
  args, annotations as instant ("i") events, per-chunk wire bytes as
  counter ("C") tracks.
* :func:`prometheus_text` renders the text exposition format over the
  obs counter registry, a serving metrics snapshot and a plan registry's
  stats where given, the ``timing.GlobalTimer`` call tree
  (:mod:`spfft_tpu_torch.timing`) and the tracer's lifecycle counters:
  for the same records, byte for byte the JAX package's text.
* :func:`parse_prometheus_text` is the validating parser the tests and
  ``chip_smoke.py`` round-trip the text through.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

from .counters import GLOBAL_COUNTERS
from .trace import GLOBAL_TRACER, Span, Tracer


# -- Chrome trace-event JSON ------------------------------------------------

def trace_events(tracer: Optional[Tracer] = None,
                 events: Optional[List] = None,
                 bare: bool = False) -> List[dict]:
    """The tracer's buffer as a Chrome trace-event list. Tracks map to
    (pid=1, tid) rows with thread_name metadata; timestamps are
    microseconds since the tracer's epoch. ``events`` substitutes a
    pre-filtered raw slice of the buffer (the flight recorder converts
    one retained trace's events this way); ``bare`` omits the process/
    thread metadata events (sub-lists embedded in a bundle don't
    re-declare them)."""
    tracer = tracer or GLOBAL_TRACER
    raw = events if events is not None else tracer.events()
    tracks: Dict[str, int] = {}

    def tid(track: Optional[str]) -> int:
        name = track or "main"
        if name not in tracks:
            tracks[name] = len(tracks) + 1
        return tracks[name]

    def us(t: float) -> float:
        return round((t - tracer.epoch) * 1e6, 3)

    events: List[dict] = []
    for ev in raw:
        if isinstance(ev, Span):
            args = {"trace_id": ev.trace_id, "status": ev.status}
            if ev.parent_id is not None:
                args["parent_span_id"] = ev.parent_id
            args["span_id"] = ev.span_id
            if ev.error:
                args["error"] = ev.error
            if ev.args:
                args.update(ev.args)
            events.append({"ph": "X", "name": ev.name, "cat": ev.cat,
                           "ts": us(ev.t0),
                           "dur": round(ev.duration * 1e6, 3),
                           "pid": 1, "tid": tid(ev.track),
                           "args": args})
        elif ev.get("type") == "instant":
            args = dict(ev.get("args") or {})
            if ev.get("trace_id") is not None:
                args["trace_id"] = ev["trace_id"]
            events.append({"ph": "i", "s": "t", "name": ev["name"],
                           "cat": ev["cat"], "ts": us(ev["ts"]),
                           "pid": 1, "tid": tid(ev.get("track")),
                           "args": args})
        else:  # counter
            events.append({"ph": "C", "name": ev["name"],
                           "cat": ev["cat"], "ts": us(ev["ts"]),
                           "pid": 1, "tid": tid(ev.get("track")),
                           "args": ev.get("args") or {}})
    if bare:
        return events
    meta = [{"ph": "M", "pid": 1, "name": "process_name",
             "args": {"name": "spfft_tpu_torch"}}]
    for name, t in sorted(tracks.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "pid": 1, "tid": t,
                     "name": "thread_name", "args": {"name": name}})
    return meta + events


def export_trace(path: str, tracer: Optional[Tracer] = None) -> dict:
    """Write the Chrome trace-event JSON to ``path`` (open it in
    Perfetto / chrome://tracing). Returns the payload dict."""
    tracer = tracer or GLOBAL_TRACER
    payload = {
        "traceEvents": trace_events(tracer),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "spfft_tpu_torch.obs",
                      "tracer": tracer.stats()},
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


# -- Prometheus text exposition ---------------------------------------------

def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


class _PromBuilder:
    """Accumulates families in insertion order, one HELP/TYPE header per
    family, samples below it (the exposition-format grouping rule)."""

    def __init__(self):
        self._families: "Dict[str, Tuple[str, str, List[str]]]" = {}

    def add(self, name: str, mtype: str, help_: str,
            value: float, labels: Optional[dict] = None) -> None:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = (mtype, help_, [])
        if labels:
            body = ",".join(f'{k}="{_escape(v)}"'
                            for k, v in sorted(labels.items()))
            series = f"{name}{{{body}}}"
        else:
            series = name
        fam[2].append(f"{series} {_format_value(value)}")

    def text(self) -> str:
        lines: List[str] = []
        for name, (mtype, help_, samples) in self._families.items():
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"


def _format_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _serve_families(b: _PromBuilder, snap: dict) -> None:
    counters = [
        ("completed", "Requests completed successfully."),
        ("failed", "Requests resolved with an error."),
        ("rejected_queue_full", "Submits rejected by backpressure."),
        ("expired_deadline", "Requests expired before dispatch."),
        ("fused_batches", "Buckets dispatched through the fused path."),
        ("serial_batches", "Buckets dispatched serially."),
        ("padded_rows", "Ladder pad rows dispatched."),
        ("pinned_batches", "Buckets dispatched at a pinned shape."),
        ("fused_rows", "Live rows dispatched through fused buckets."),
    ]
    for key, help_ in counters:
        b.add(f"spfft_serve_{key}_total", "counter", help_,
              snap.get(key, 0))
    for cls, n in (snap.get("completed_by_class") or {}).items():
        b.add("spfft_serve_completed_by_class_total", "counter",
              "Completions per priority class.", n, {"class": cls})
    b.add("spfft_serve_queue_depth", "gauge",
          "Request queue depth at last enqueue/dequeue.",
          snap.get("queue_depth", 0))
    b.add("spfft_serve_max_queue_depth", "gauge",
          "High-water queue depth.", snap.get("max_queue_depth", 0))
    lat = snap.get("latency_seconds") or {}
    for q, v in lat.items():
        b.add("spfft_serve_latency_seconds", "gauge",
              "Request latency percentiles over the bounded reservoir.",
              v, {"quantile": q})
    for key, metric, help_ in (
            ("queue_wait_seconds", "spfft_serve_queue_wait_seconds",
             "Enqueue->dispatch wait percentiles (recent window) — "
             "the controller's queue-pressure signal."),
            ("device_execute_seconds",
             "spfft_serve_device_execute_seconds",
             "Dispatch->materialised bucket time percentiles (recent "
             "window) — the controller's device-cost signal.")):
        for q, v in (snap.get(key) or {}).items():
            b.add(metric, "gauge", help_, v, {"quantile": q})
    for cls, per in (snap.get("latency_seconds_by_class") or {}).items():
        for q, v in per.items():
            b.add("spfft_serve_latency_by_class_seconds", "gauge",
                  "Per-priority-class latency percentiles.", v,
                  {"class": cls, "quantile": q})
    for path, hkey in (("fused", "fused_batch_histogram"),
                       ("serial", "serial_batch_histogram")):
        for size, count in (snap.get(hkey) or {}).items():
            b.add("spfft_serve_batch_size_total", "counter",
                  "Dispatched buckets by live-row count and path.",
                  count, {"path": path, "size": size})
    overhead = snap.get("overhead_seconds") or {}
    for key in ("stage_total", "dispatch_total"):
        b.add("spfft_serve_overhead_seconds_total", "counter",
              "Host-side orchestration seconds.", overhead.get(key, 0.0),
              {"phase": key.replace("_total", "")})
    health = snap.get("health") or {}
    state = health.get("state")
    if state is not None:
        for s in ("healthy", "degraded", "draining", "failed"):
            b.add("spfft_serve_health", "gauge",
                  "Executor lifecycle state (one-hot).",
                  1 if s == state else 0, {"state": s})
    for key, value in health.items():
        if isinstance(value, (int, float)) and key != "state":
            b.add(f"spfft_serve_{key}_total", "counter",
                  f"Failure-handling counter: {key}.", value)
        elif isinstance(value, dict):
            for cls, n in value.items():
                if isinstance(n, (int, float)):
                    b.add(f"spfft_serve_{key}_total", "counter",
                          f"Failure-handling counter: {key}.", n,
                          {"class": cls})


def _registry_families(b: _PromBuilder, stats: dict) -> None:
    gauges = {"plans", "bytes_in_use", "max_bytes", "max_plans",
              "sig_memo_entries", "sig_memo_bytes", "hit_rate",
              "store_attached"}
    for key, value in stats.items():
        if not isinstance(value, (int, float)):
            continue
        if key in gauges:
            b.add(f"spfft_registry_{key}", "gauge",
                  f"Plan registry {key.replace('_', ' ')}.", value)
        else:
            b.add(f"spfft_registry_{key}_total", "counter",
                  f"Plan registry {key.replace('_', ' ')}.", value)


def _timing_families(b: _PromBuilder, timer) -> None:
    try:
        tree = json.loads(timer.process().json())
    except Exception:
        return

    def visit(node, prefix):
        scope = f"{prefix}/{node['label']}" if prefix else node["label"]
        b.add("spfft_timing_seconds_total", "counter",
              "Accumulated scope-timer seconds (timing.GlobalTimer).",
              node["total"], {"scope": scope})
        b.add("spfft_timing_calls_total", "counter",
              "Scope-timer call counts (timing.GlobalTimer).",
              node["count"], {"scope": scope})
        for sub in node.get("sub", ()):
            visit(sub, scope)

    for root in tree.get("timings", ()):
        visit(root, "")


def prometheus_text(metrics=None, registry=None, timer=None,
                    counters=None, tracer: Optional[Tracer] = None) -> str:
    """Render everything the process knows as Prometheus text
    exposition. All arguments optional: ``metrics`` is a
    ``ServeMetrics`` (or a pre-taken ``snapshot()`` dict), ``registry``
    a ``PlanRegistry``; ``timer`` defaults to ``timing.GlobalTimer``,
    ``counters``/``tracer`` to the obs globals."""
    b = _PromBuilder()
    counters = counters if counters is not None else GLOBAL_COUNTERS
    for name, fam in sorted(counters.snapshot().items()):
        for key, value in sorted(fam["samples"].items()):
            b.add(name, fam["type"], fam["help"], value, dict(key))
    if metrics is not None:
        snap = metrics if isinstance(metrics, dict) \
            else metrics.snapshot()
        _serve_families(b, snap)
        if registry is None and isinstance(snap.get("registry"), dict):
            _registry_families(b, snap["registry"])
    if registry is not None:
        stats = registry if isinstance(registry, dict) \
            else registry.stats()
        _registry_families(b, stats)
    if timer is None:
        from .. import timing
        timer = timing.GlobalTimer
    _timing_families(b, timer)
    tracer = tracer or GLOBAL_TRACER
    tstats = tracer.stats()
    b.add("spfft_trace_spans_started_total", "counter",
          "Spans begun since the tracer's last reset.",
          tstats["started"])
    b.add("spfft_trace_spans_closed_total", "counter",
          "Spans finished since the tracer's last reset.",
          tstats["closed"])
    b.add("spfft_trace_spans_open", "gauge",
          "Spans currently open (must be 0 at quiescence).",
          tstats["open"])
    b.add("spfft_trace_events_dropped_total", "counter",
          "Events dropped by the bounded ring buffer.",
          tstats["dropped"])
    return b.text()


# -- minimal exposition-format parser (the round-trip test) -----------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r'\s+(?P<value>[0-9eE+.\-]+|NaN|\+Inf|-Inf)\s*$')
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"\s*(?:,|$)')
_HELP_RE = re.compile(r"^# HELP (?P<name>\S+) (?P<help>.*)$")
_TYPE_RE = re.compile(
    r"^# TYPE (?P<name>\S+) "
    r"(?P<type>counter|gauge|histogram|summary|untyped)$")


def parse_prometheus_text(text: str) -> Dict[Tuple, float]:
    """Parse exposition-format text into ``{(name, ((label, value),
    ...)): float}``, VALIDATING as it goes: every sample line must
    match the format, every sampled metric must carry a prior ``# TYPE``
    declaration, and label pairs must be well-formed. Raises
    ``ValueError`` on any violation — this is the CI round-trip check,
    not a lenient scraper."""
    types: Dict[str, str] = {}
    out: Dict[Tuple, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m:
                if m.group("name") in types:
                    raise ValueError(
                        f"line {lineno}: duplicate TYPE for "
                        f"{m.group('name')}")
                types[m.group("name")] = m.group("type")
                continue
            if _HELP_RE.match(line) or line.startswith("# "):
                continue
            raise ValueError(f"line {lineno}: bad comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample {line!r}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        if base not in types:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no TYPE "
                f"declaration")
        labels: List[Tuple[str, str]] = []
        body = m.group("labels")
        if body:
            pos = 0
            while pos < len(body):
                lm = _LABEL_PAIR_RE.match(body, pos)
                if not lm:
                    raise ValueError(
                        f"line {lineno}: bad labels {body!r}")
                labels.append((lm.group("k"), lm.group("v")))
                pos = lm.end()
        key = (name, tuple(labels))
        if key in out:
            raise ValueError(f"line {lineno}: duplicate series {key}")
        out[key] = float(m.group("value"))
    return out
