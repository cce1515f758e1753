"""Hierarchical scope timing — the rt_graph equivalent (counterpart of
``spfft_tpu.timing``).

Reimplements the semantics of the reference's self-contained scope timer
(reference: src/timing/rt_graph.hpp:106-177 ``Timer``, :83-102
``TimingResult``; hooked in via HOST_TIMING_* macros,
src/timing/timing.hpp:44-62): nested named scopes accumulate durations,
``process()`` reconstructs the call tree, and the result prints a
Count/Total/%/Parent%/Median/Min/Max table or exports JSON — the same
stats the reference benchmark dumps (tests/programs/benchmark.cpp:276-308).

CUDA kernels run asynchronously, so a host-side scope around a launch
measures the enqueue unless the scope waits. ``timed_transform(label)``
yields a box; assigning the produced tensors to ``box.value`` inside the
scope makes an ENABLED measurement ``torch.cuda.synchronize`` each CUDA
device they live on before the scope closes, so it measures wall-clock
time of the work. With timing disabled (the default) nothing is
synchronised: the hot path gains no wait.

Timing is off by default (the reference compiles the macros out unless
SPFFT_TIMING, CMakeLists.txt:181-184); enable with ``enable()`` or the
SPFFT_TPU_TIMING=1 environment variable.
"""

from __future__ import annotations

import contextlib
import json as _json
import os
import statistics
import threading
import time
from typing import Any, Dict, List, Optional

import torch


def _cuda_devices(value: Any) -> set:
    """The CUDA devices holding a tensor in ``value`` (a tensor, or
    nested lists and tuples of them)."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, (list, tuple)):
            for x in v:
                visit(x)

    visit(value)
    return devices


def synchronize(value: Any) -> None:
    """Wait for the work producing ``value``: ``torch.cuda.synchronize``
    once for each CUDA device holding a tensor in ``value`` (a tensor,
    or nested lists and tuples of them). CPU tensors are ready when
    their op returns."""
    for d in _cuda_devices(value):
        torch.cuda.synchronize(d)


def ready_events(value: Any) -> List["torch.cuda.Event"]:
    """One CUDA event recorded now on the current stream of each CUDA
    device holding a tensor in ``value``: the events complete when the
    work queued so far on those streams has run (the work producing
    ``value``), and not later work. Empty for CPU tensors."""
    events = []
    for d in _cuda_devices(value):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    return events


def wait_events(events) -> None:
    """Block the host until every event of ``events`` has completed
    (``Event.synchronize``): a wait for one piece of work, where
    :func:`synchronize` waits for all the device's work."""
    for ev in events or ():
        ev.synchronize()


def wait_ready(value: Any) -> None:
    """Wait for the work producing ``value`` alone: :func:`ready_events`
    then :func:`wait_events`."""
    wait_events(ready_events(value))


class _Node:
    __slots__ = ("label", "times", "children")

    def __init__(self, label: str):
        self.label = label
        self.times: List[float] = []
        self.children: "Dict[str, _Node]" = {}


class TimingResult:
    """Processed call tree with per-scope statistics
    (reference: rt_graph.hpp:83-102)."""

    def __init__(self, root: _Node):
        self._root = root

    def _rows(self):
        rows = []
        total_all = sum(sum(c.times) for c in self._root.children.values())

        def visit(node: _Node, depth: int, parent_total: float):
            total = sum(node.times)
            rows.append({
                "label": node.label, "depth": depth,
                "count": len(node.times), "total": total,
                "pct": 100.0 * total / total_all if total_all else 0.0,
                "parent_pct": (100.0 * total / parent_total
                               if parent_total else 100.0),
                "median": statistics.median(node.times) if node.times else 0.0,
                "min": min(node.times) if node.times else 0.0,
                "max": max(node.times) if node.times else 0.0,
            })
            for child in node.children.values():
                visit(child, depth + 1, total)

        for child in self._root.children.values():
            visit(child, 0, total_all)
        return rows

    def print(self) -> None:
        """Print the stats table (reference: TimingResult::print)."""
        rows = self._rows()
        if not rows:
            print("(no timings recorded)")
            return
        hdr = (f"{'scope':<40}{'count':>7}{'total[s]':>12}{'%':>8}"
               f"{'parent%':>9}{'median[s]':>12}{'min[s]':>12}{'max[s]':>12}")
        print(hdr)
        print("-" * len(hdr))
        for r in rows:
            label = "  " * r["depth"] + r["label"]
            print(f"{label:<40}{r['count']:>7}{r['total']:>12.6f}"
                  f"{r['pct']:>8.2f}{r['parent_pct']:>9.2f}"
                  f"{r['median']:>12.6f}{r['min']:>12.6f}{r['max']:>12.6f}")

    def json(self) -> str:
        """JSON export (reference: TimingResult::json)."""

        def dump(node: _Node) -> Dict[str, Any]:
            return {
                "label": node.label,
                "count": len(node.times),
                "total": sum(node.times),
                "times": node.times,
                "sub": [dump(c) for c in node.children.values()],
            }

        return _json.dumps(
            {"timings": [dump(c) for c in self._root.children.values()]})


class Timer:
    """Nested scope timer (reference: rt_graph.hpp:106-155).

    The scope stack is thread-local (each thread nests its own scopes
    from the shared root), while the tree itself (child creation, sample
    appends, ``record``) mutates under one lock. A ``reset`` on another
    thread mid-scope orphans that scope: its sample lands in the
    discarded tree, so callers quiesce before resetting."""

    def __init__(self):
        self._record_lock = threading.Lock()
        self._root = _Node("<root>")      #: guarded by _record_lock
        self._tls = threading.local()     #: guarded by _record_lock

    def reset(self) -> None:
        with self._record_lock:
            self._root = _Node("<root>")
            self._tls = threading.local()

    def _stack(self) -> List[_Node]:
        """This thread's scope stack, rooted at the current root (a stale
        stack from before a reset is discarded)."""
        with self._record_lock:
            tls, root = self._tls, self._root
        stack = getattr(tls, "stack", None)
        if stack is None or stack[0] is not root:
            stack = tls.stack = [root]
        return stack

    def record(self, label: str, seconds: float) -> None:
        """Append one pre-measured duration under a root-level scope
        named ``label``; never touches a scope stack."""
        with self._record_lock:
            node = self._root.children.get(label)
            if node is None:
                node = self._root.children[label] = _Node(label)
            node.times.append(seconds)

    @contextlib.contextmanager
    def scoped(self, label: str, block: Any = None):
        """Time a scope; if ``block`` is given, :func:`synchronize` on it
        before closing the measurement (for asynchronous device work)."""
        stack = self._stack()
        parent = stack[-1]
        with self._record_lock:
            node = parent.children.get(label)
            if node is None:
                node = parent.children[label] = _Node(label)
        stack.append(node)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block is not None:
                synchronize(block)
            dt = time.perf_counter() - t0
            with self._record_lock:
                node.times.append(dt)
            stack.pop()

    def process(self) -> TimingResult:
        with self._record_lock:
            return TimingResult(self._root)


#: Global timer, mirroring the reference's GlobalTimer singleton
#: (reference: src/timing/timing.cpp:36).
GlobalTimer = Timer()

_enabled = os.environ.get("SPFFT_TPU_TIMING") == "1"


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def suppressed():
    """Temporarily disable timing inside a scope: the multi-transform
    API times a batch as one scope, and waiting after each transform
    would serialise it."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


class _ResultBox:
    """Mutable late-binding holder so a scope can wait on a result
    produced inside it."""

    def __init__(self):
        self.value: Optional[Any] = None


@contextlib.contextmanager
def timed_transform(label: str):
    """Scope for one transform execution: ``box.value = <result>`` inside
    the scope makes an enabled measurement wait for it. Disabled: no
    timing and no synchronisation."""
    if not _enabled:
        yield _ResultBox()
        return
    box = _ResultBox()
    with GlobalTimer.scoped(label):
        try:
            yield box
        finally:
            if box.value is not None:
                synchronize(box.value)
