"""The reduction of a ``torch.profiler`` trace to what the per-layer
metrics read.

The harness wraps each part of a call in a span of its own
(``torch.profiler.record_function``): ``portbench.backward`` and
``portbench.forward`` around the calls into the program,
``portbench.operator`` around the benchmark's own V(r) multiply and
``portbench.sync`` around the caller's synchronize. Each device
operation (a kernel, a copy, a memset) is attributed to the span the
host was in when it launched it, through the trace's launch correlation;
an operation with no launch event in the trace is attributed by its
name: one of the program's kernels (``kernels/stages.json``) to the
program's calls, anything else to no span. Each operation also gets the
stage its name matches in ``stages.json`` (``z``, ``xy``, another of
the program's kernels ``port``, or ``torch``).
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

SPAN_PREFIX = "portbench."
#: the spans around the calls into the program under test
PORT_SPANS = ("backward", "forward")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STAGES = Path(__file__).resolve().parent / "kernels" / "stages.json"


@dataclass
class Op:
    name: str
    start_us: float
    dur_us: float
    stage: str
    span: str  # a span's short name, "" for none


@dataclass
class Summary:
    ops: list = field(default_factory=list)
    #: (start_us, end_us, short name) of every benchmark span
    spans: list = field(default_factory=list)
    window_us: float = 0.0
    busy_us: float = 0.0
    #: idle time by the span the host was in, {label: us}
    idle_by_span: dict = field(default_factory=dict)

    def seconds(self, stage=None, spans=None) -> float:
        """Summed device seconds of the operations of ``stage`` (any
        stage for None) attributed to one of ``spans`` (any for None)."""
        return sum(o.dur_us for o in self.ops
                   if (stage is None or o.stage == stage)
                   and (spans is None or o.span in spans)) * 1e-6

    def count(self, spans) -> int:
        return sum(1 for o in self.ops if o.span in spans)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations with the most summed time, by
        name: ``[[name, seconds], ...]``."""
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.dur_us * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])][:k]

    def top_gaps(self, k: int = 10) -> list:
        return [[n, us * 1e-6] for n, us in sorted(
            self.idle_by_span.items(), key=lambda x: -x[1])][:k]


def load_stages(path: Path = STAGES) -> dict:
    raw = json.loads(Path(path).read_text())
    return {k: [re.compile(p) for p in v] for k, v in raw.items()
            if isinstance(v, list)}


def short_name(name: str) -> str:
    """A kernel's name without its trailing parameter list, at most 160
    characters."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    return name[:160]


def stage_of(name: str, stages: dict) -> str:
    for stage in ("z", "xy", "port"):
        if any(p.search(name) for p in stages[stage]):
            return stage
    return "torch"


def _union(intervals):
    """Merged ``(start, end)`` intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, stages: dict) -> Summary:
    """Reduce chrome-trace ``events`` (``export_chrome_trace``'s
    ``traceEvents``) to a :class:`Summary`."""
    spans, launches, dev = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, name[len(SPAN_PREFIX):]))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ts
        elif cat in DEVICE_CATS:
            dev.append((ts, dur, name, args.get("correlation")))
    spans.sort()
    starts = [s[0] for s in spans]

    def span_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            return spans[i][2]
        return ""

    s = Summary(spans=spans)
    for ts, dur, name, corr in dev:
        stage = stage_of(name, stages)
        if corr in launches:
            span = span_at(launches[corr])
        else:
            span = "program" if stage != "torch" else ""
        s.ops.append(Op(short_name(name), ts, dur, stage, span))
    if spans:
        lo, hi = spans[0][0], max(e for _, e, _ in spans)
        s.window_us = hi - lo
        busy = _union((max(o.start_us, lo), min(o.start_us + o.dur_us, hi))
                      for o in s.ops if o.start_us + o.dur_us > lo
                      and o.start_us < hi)
        s.busy_us = sum(e - b for b, e in busy)
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        for b, e in zip(edges[0::2], edges[1::2]):
            if e > b:
                label = span_at((b + e) / 2) or "between spans"
                s.idle_by_span[label] = s.idle_by_span.get(label, 0.0) + e - b
    return s


def port_spans() -> tuple:
    """The span labels that count as the program's calls (an operation
    attributed by name is labelled ``program``)."""
    return PORT_SPANS + ("program",)
