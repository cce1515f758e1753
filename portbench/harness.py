"""One run of one cell: set-up, the measured window, the traced segment,
the check against the plain reference, and the result line.

The program under test is ``spfft_tpu_torch``, reached only through its
public API (``Grid``, ``Transform``, ``multi_transform_backward`` /
``multi_transform_forward``), looked up at each call so that a test can
put a broken program in its place.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import random
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import spfft_tpu_torch as sp

from portbench import counts, trace, workload
from portbench.reference import dense
from portbench.spec import Cell, load_benchmark
from portbench.traffic import Traffic

SPAN = trace.SPAN_PREFIX
#: the numbers that decide ``correct``; a configuration's ``limits`` holds
#: the limit of each
CHECKS = ("band_rel_l2", "value_err_rms")
#: the reservoir's stream: which call's output of each band is kept
RESERVOIR_SALT = 0x5EED


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


@dataclass
class Reading:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    summary: object
    pairs_traced: int
    dispatch_s: list
    plan_build_s: float
    pair_counts: dict
    precision: str
    peaks: dict

    def bound(self, stage: str) -> float:
        """The least seconds a pair of ``stage`` could take on the card."""
        nbytes, flops = self.pair_counts[stage]
        return counts.bound_seconds(nbytes, flops, self.precision, self.peaks)


@dataclass
class Caller:
    """The cell's caller: one call is a batch of band pairs, backward ->
    V(r) -> forward with FULL scaling (the traffic's module under
    ``callers/``), then the caller's synchronize."""
    api: object
    transforms: list
    values: torch.Tensor
    potential: torch.Tensor
    device: torch.device
    traced: bool = False
    dispatch_s: list = field(default_factory=list)
    _inside: float = 0.0

    def span(self, name):
        if self.traced:
            return torch.profiler.record_function(SPAN + name)
        return contextlib.nullcontext()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inside(self, name: str, fn):
        """``fn()``, a call into the program, in the span ``name``, its
        host seconds added to the call's."""
        with self.span(name):
            t = time.perf_counter()
            out = fn()
            self._inside += time.perf_counter() - t
        return out

    def apply(self, spaces):
        """Each space slab times V(r), in place, in the span
        ``operator``."""
        with self.span("operator"):
            for s in spaces:
                s.mul_(self.potential)

    def call(self, group: list) -> list:
        """One call over the bands ``group``; returns each band's output
        values and records the host seconds spent inside the program."""
        self._inside = 0.0
        outs = self.api.call(self, group)
        with self.span("sync"):
            self.sync()
        self.dispatch_s.append(self._inside)
        return outs


def _power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def compare(outputs: dict, values: torch.Tensor, potential: torch.Tensor,
            trip: np.ndarray, cfg: dict, pair: bool = False) -> dict:
    """Each kept band's output against the reference of the same inputs:
    ``{band: (rel_l2, err_rms)}``, with the relative l2 of the band's
    error and its largest error over the band's rms value. ``pair``: the
    plan states the planar ``(2, N)`` layout for its outputs
    (``pair_values_io``), else they are ``(N, 2)``; an output of another
    shape fails."""
    dev = values.device
    idx = torch.as_tensor(workload.storage_indices(trip, cfg["dims"]),
                          device=dev)
    r2c = cfg["transform"] == "r2c"
    out = {}
    for b in sorted(outputs):
        ref = dense.reference_pair(values[b], potential, idx, cfg["dims"],
                                   r2c)
        got = outputs[b].to(torch.float64)
        if pair:
            got = got.t() if got.dim() == 2 and got.shape[0] == 2 else None
        if got is None or tuple(got.shape) != tuple(ref.shape):
            out[b] = (math.inf, math.inf)
            continue
        diff = got - ref
        ref_norm = float(torch.linalg.vector_norm(ref))
        err_norm = float(torch.linalg.vector_norm(diff))
        rms = ref_norm / math.sqrt(ref.shape[0])
        worst = float(diff.square().sum(-1).sqrt().max())
        out[b] = (err_norm / ref_norm, worst / rms)
        del ref, got, diff
    return out


def judge(per_band: dict, bands: int, limits: dict,
          demoted: int = 0) -> tuple:
    """``(correct, failed, checks)`` of per-band readings against the
    configuration's limits (a missing band fails), and of the directions
    ``demoted`` off the fused route during the run (none may be)."""
    worst = {c: max((v[i] for v in per_band.values()), default=math.inf)
             for i, c in enumerate(CHECKS)}
    checks = {c: {"value": worst[c], "limit": limits.get(c)}
              for c in CHECKS}
    checks["bands_missing"] = {"value": bands - len(per_band), "limit": 0}
    checks["fused_demotions"] = {"value": demoted, "limit": 0}
    failed = bands - len(per_band) + sum(
        1 for v in per_band.values()
        if any(not (limits.get(c) is not None and v[i] <= limits[c])
               for i, c in enumerate(CHECKS)))
    correct = all(ch["limit"] is not None and ch["value"] <= ch["limit"]
                  for ch in checks.values())
    return correct, failed, checks


def make_transforms(cfg: dict, trip: np.ndarray, sticks: int, count: int,
                    device):
    """The plan, built as a caller builds it (a ``Grid`` of ``sticks`` z
    sticks and its ``create_transform``), and ``count - 1`` clones:
    ``(transforms, seconds of the build, synchronized)``."""
    n = cfg["dims"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    grid = sp.Grid(n[0], n[1], n[2], sticks, sp.ProcessingUnit.DEVICE, precision=cfg["precision"],
                   device=device)
    tr = grid.create_transform(sp.ProcessingUnit.DEVICE,
                               sp.TransformType[cfg["transform"].upper()],
                               n[0], n[1], n[2], indices=trip)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    return [tr] + [tr.clone() for _ in range(count - 1)], seconds


def run(workload_name: str, seed: int, seconds: float, traced: bool,
        t0: float, device=None, bench=None, config=None) -> tuple:
    """Run the cell; returns ``(result line as a dict, stderr check
    lines)``. ``device`` defaults to the first card; ``config`` replaces
    the cell's configuration (a test's small size)."""
    bench = load_benchmark() if bench is None else bench
    cell = Cell(bench, workload_name)
    cfg = cell.config if config is None else config
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    parts = {"import": time.perf_counter() - t0}

    t = time.perf_counter()
    trip = workload.config_triplets(cfg)
    sticks = workload.stick_count(trip, cfg["dims"])
    if config is None and (trip.shape[0] != cfg["values"] or
                           sticks != cfg["sticks"]):
        raise RuntimeError(f"{cfg['name']}: the triplets no longer match "
                           f"the configuration's counts")
    parts["triplets"] = time.perf_counter() - t
    t = time.perf_counter()
    values, potential = workload.draw_inputs(cfg, trip, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    parts["inputs"] = time.perf_counter() - t
    resident = values.numel() * values.element_size() \
        + potential.numel() * potential.element_size()

    traffic = Traffic(cell.traffic_params, values.shape[0])
    api = cell.caller()
    transforms, plan_s = make_transforms(cfg, trip, sticks,
                                         api.handles(traffic.batch), dev)
    parts["plan"] = plan_s
    op = potential if cfg["transform"] == "r2c" else potential.unsqueeze(-1)
    caller = Caller(api, transforms, values, op, dev)

    t = time.perf_counter()
    call = 0
    for _ in range(traffic.warmup_calls):
        outs = caller.call(traffic.group(call))
        call += 1
    # of each band, the output of one of its calls in the window is kept
    # for the check, drawn uniformly from the seed, as a copy into this
    # buffer: the program's outputs are released as a caller releases
    # them, so its allocations follow the same pattern whatever the seed
    keep = torch.empty((values.shape[0],) + tuple(outs[0].shape),
                       dtype=outs[0].dtype, device=dev)
    parts["warmup"] = time.perf_counter() - t
    caller.dispatch_s.clear()

    seen = {}
    pick = random.Random(seed ^ RESERVOIR_SALT)

    def timed(outs, group):
        for b, o in zip(group, outs):
            seen[b] = seen.get(b, 0) + 1
            if pick.random() * seen[b] < 1.0:  # one of seen[b], uniformly
                keep[b].copy_(o)

    lat = []
    start = time.perf_counter()
    setup_s = start - t0
    end = start + seconds
    first = call
    while True:
        t = time.perf_counter()
        group = traffic.group(call)
        outs = caller.call(group)
        now = time.perf_counter()
        lat.append(now - t)
        timed(outs, group)
        call += 1
        # the window closes once its seconds are up and every band has
        # been answered
        if now >= end and len(seen) == values.shape[0]:
            break
    window_s = now - start
    calls = call - first
    pairs = calls * traffic.batch

    summary, traced_calls = None, 0
    if traced:
        summary, traced_calls = _traced(caller, traffic, call, timed, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # clones share the plan: its demotions cover every handle
    demoted = len(transforms[0].plan.fused_demotions())
    pair = transforms[0].plan.pair_values_io
    power = _power_limit() if dev.type == "cuda" else None

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak),
                   "resident_bytes": int(resident), "power": power}
    attempted = pairs + traced_calls * traffic.batch
    line = {"correct": False, "attempted": attempted, "failed": 0,
            "metrics": {}, "device": device_info}
    if traced:
        reading = Reading(
            summary=summary, pairs_traced=traced_calls * traffic.batch,
            dispatch_s=list(caller.dispatch_s[:calls]),
            plan_build_s=plan_s, precision=cfg["precision"],
            pair_counts=counts.pair_counts(
                cfg["transform"], cfg["precision"], cfg["dims"],
                trip.shape[0], sticks,
                workload.column_count(trip, cfg["dims"])),
            peaks=counts.load_peaks())
        readers = cell.readers()
        for m in cell.per_layer:
            v = readers[m["name"]](reading)
            if v is not None:
                line["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary.busy_us * 1e-6
            device_info["window_s"] = summary.window_us * 1e-6
            line["breakdown"] = {"device_ops": summary.top_ops(),
                                 "idle_gaps": summary.top_gaps()}
    else:
        e2e = {"pairs_per_s": pairs / window_s,
               "call_p95_ms": float(np.percentile(lat, 95)) * 1e3,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                          "unit": m["unit"]}
    log(f"{workload_name} seed {seed}: {calls} calls, {pairs} pairs in "
        f"{window_s:.4f} s; traced calls {traced_calls}; set-up "
        + json.dumps({k: round(v, 4) for k, v in parts.items()})
        + f"; peak {peak} B, resident {resident} B; fused directions "
        f"demoted {demoted}; outputs {'(2, N)' if pair else '(N, 2)'}; "
        f"{power}")

    # the program's state goes before the reference runs
    del caller, transforms, outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    per_band = compare({b: keep[b] for b in seen}, values, potential,
                       trip, cfg, pair)
    log(f"reference: {len(per_band)} bands in "
        f"{time.perf_counter() - t:.3f} s")
    correct, failed, checks = judge(per_band, values.shape[0],
                                    cfg.get("limits", {}), demoted)
    line["correct"], line["failed"] = correct, failed
    line["checks"] = checks
    lines = [f"check {k}: {v['value']} limit {v['limit']}"
             for k, v in checks.items()]
    return line, lines


def _traced(caller: Caller, traffic: Traffic, call: int, timed, dev):
    """``traffic.trace_calls`` calls under ``torch.profiler``, each part
    in its span; returns the trace's :class:`~portbench.trace.Summary`
    and the number of calls."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    caller.traced = True
    try:
        with profile(activities=acts) as prof:
            for k in range(traffic.trace_calls):
                group = traffic.group(call + k)
                timed(caller.call(group), group)
    finally:
        caller.traced = False
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return trace.summarize(events, trace.load_stages()), traffic.trace_calls
