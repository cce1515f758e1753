"""Offline auto-tuner: measured knob recommendations as an artifact (the
port of ``spfft_tpu/control/tuner.py``: the same grid, scoring and
artifact).

``python -m spfft_tpu_torch.control tune`` RUNS the existing measurement
protocols — the ``serve.bench`` trace replay over a small grid of
(batch_window, max_batch) settings and, with ``--overlap-ab``,
``scripts/torch_bench_overlap_ab.py``'s interleaved A/B over overlap
chunk counts — scores the results, and emits a recommended-config
artifact (:meth:`ServeConfig.to_artifact` JSON, grid provenance and the
port's ``platform_summary`` embedded) that the serving layer loads at
boot via ``SPFFT_TPU_SERVE_CONFIG`` (or ``serve.bench --config``).

Scoring: throughput first, p99 latency as the tiebreak within
``p99_slack`` (default 5%) of the best throughput — a knob that buys 1%
throughput for a fat tail is not a win for a serving system. The overlap
recommendation only moves off K=1 when the A/B reports
``overlap_meaningful``: the port's shards of one card share one stream,
where K chunks overlap nothing, so on one card the tuner recommends
K=1, as the JAX tuner does on XLA:CPU.
"""


from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from .config import ServeConfig

#: Default serve.bench grid (kept small: each cell is a full replay).
DEFAULT_WINDOWS_MS = (0.0, 0.5, 1.0, 2.0)
DEFAULT_MAX_BATCHES = (4, 8, 16)
QUICK_WINDOWS_MS = (0.0, 1.0)
QUICK_MAX_BATCHES = (8,)


def _run_serve_bench(dim: int, requests: int, signatures: int,
                     threads: int, window_s: float, max_batch: int,
                     seed: int, cpu: bool = False,
                     devices: int = 0) -> Optional[Dict]:
    """One grid cell: the serve.bench replay with these knobs (on the
    card, or the host with ``cpu``; a pool of ``devices`` slots), JSON
    payload returned (None when the run failed — a broken cell is
    skipped, not fatal)."""
    from ..serve.bench import main as bench_main
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spfft_tune_")
    os.close(fd)
    try:
        rc = bench_main(["--dim", str(dim), "--requests", str(requests),
                         "--signatures", str(signatures),
                         "--threads", str(threads),
                         "--window", repr(window_s),
                         "--max-batch", str(max_batch),
                         "--seed", str(seed), "--devices", str(devices),
                         "-o", path] + (["--cpu"] if cpu else []))
        if rc != 0:
            return None
        with open(path) as f:
            return json.load(f)
    except Exception:
        return None
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _score_grid(cells: List[Dict], p99_slack: float) -> Optional[Dict]:
    """Best cell: max throughput, then min p99 among cells within
    ``p99_slack`` of that throughput."""
    ok = [c for c in cells if c.get("result")]
    if not ok:
        return None
    best_tp = max(c["result"]["throughput_rps"] for c in ok)
    close = [c for c in ok
             if c["result"]["throughput_rps"]
             >= best_tp * (1.0 - p99_slack)]
    return min(close, key=lambda c: (
        c["result"]["serve_metrics"]["latency_seconds"]["p99"],
        -c["result"]["throughput_rps"]))


def _tune_overlap(args) -> Dict:
    """The overlap A/B (interleaved, same-session) as a tuner stage:
    ``scripts/torch_bench_overlap_ab.py`` in a subprocess. Recommends
    K=1 unless the A/B reports overlap (``overlap_meaningful``), which
    the S shards of one device never do."""
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "scripts",
        "torch_bench_overlap_ab.py")
    if not os.path.exists(script):
        return {"skipped": "scripts/torch_bench_overlap_ab.py not found"}
    fd, path = tempfile.mkstemp(suffix=".json", prefix="spfft_tune_ab_")
    os.close(fd)
    try:
        cmd = [sys.executable, script, "--dim", str(args.overlap_dim),
               "--reps", "5", "--rounds", "3", "-o", path] \
            + (["--cpu"] if args.cpu else [])
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            return {"skipped": f"torch_bench_overlap_ab failed rc="
                               f"{proc.returncode}",
                    "stderr": proc.stderr[-500:]}
        with open(path) as f:
            payload = json.load(f)
    except Exception as exc:
        return {"skipped": f"torch_bench_overlap_ab unavailable: "
                           f"{exc!r}"}
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass
    rows = payload.get("rows") or []
    best = {"k": 1}
    if payload.get("overlap_meaningful") and rows:
        best = max(rows, key=lambda r: r.get("vs_k1", 0.0))
    return {"recommended_k": int(best.get("k", 1)),
            "overlap_meaningful": bool(payload.get(
                "overlap_meaningful")),
            "backend": payload.get("backend"),
            "rows": rows}


def tune(args) -> Dict:
    """Run the grid, pick the winner, return (and optionally write) the
    recommended-config artifact."""
    windows = (QUICK_WINDOWS_MS if args.quick
               else DEFAULT_WINDOWS_MS) if args.windows_ms is None \
        else tuple(args.windows_ms)
    batches = (QUICK_MAX_BATCHES if args.quick
               else DEFAULT_MAX_BATCHES) if args.max_batches is None \
        else tuple(args.max_batches)
    t0 = time.time()
    cells: List[Dict] = []
    for w_ms in windows:
        for mb in batches:
            result = _run_serve_bench(args.dim, args.requests,
                                      args.signatures, args.threads,
                                      w_ms / 1e3, int(mb), args.seed,
                                      cpu=args.cpu, devices=args.devices)
            cell = {"batch_window_ms": w_ms, "max_batch": int(mb),
                    "result": result and {
                        "throughput_rps": result["throughput_rps"],
                        "speedup_vs_serial":
                            result["speedup_vs_serial"],
                        "serve_metrics": {"latency_seconds":
                                          result["serve_metrics"]
                                          ["latency_seconds"]}}}
            cells.append(cell)
            print(f"tune: window={w_ms}ms max_batch={mb} -> "
                  f"{'FAILED' if result is None else str(result['throughput_rps']) + ' req/s'}",
                  file=sys.stderr)
    best = _score_grid(cells, args.p99_slack)
    values: Dict[str, float] = {}
    if best is not None:
        values["batch_window"] = best["batch_window_ms"] / 1e3
        values["max_batch"] = best["max_batch"]
    overlap = None
    if args.overlap_ab:
        overlap = _tune_overlap(args)
        if "recommended_k" in overlap:
            values["overlap_chunks"] = overlap["recommended_k"]
    cfg = ServeConfig()
    if values:
        cfg.update(values, reason="offline auto-tune", source="tuner")
    provenance = {
        "protocol": "serve.bench grid"
                    + (" + torch_bench_overlap_ab" if args.overlap_ab
                       else ""),
        "grid": cells,
        "best": best and {"batch_window_ms": best["batch_window_ms"],
                          "max_batch": best["max_batch"]},
        "overlap_ab": overlap,
        "args": {"dim": args.dim, "requests": args.requests,
                 "signatures": args.signatures, "threads": args.threads,
                 "seed": args.seed, "p99_slack": args.p99_slack},
        "elapsed_s": round(time.time() - t0, 2),
    }
    try:
        from ..utils.platform import platform_summary
        provenance["platform"] = platform_summary(
            "cpu" if args.cpu else None)
    except Exception:
        pass
    artifact = cfg.to_artifact(provenance)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"wrote {args.output}")
    return artifact
