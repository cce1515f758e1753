#!/usr/bin/env python3
"""Repeat ``chip_smoke.py``'s TCP pod case on one CUDA card.

    python3 scripts/torch_pod_tcp_repeat.py [RUNS]

builds the port's kernels, then runs ``chip_smoke.pod_tcp_case`` (agent
processes on the card, the 256^3 sphere's trace, the concurrent pair,
solo requests, join / kill / heal at ``chip_smoke.POD_HEAL_N``) RUNS
times (default 3) in one process. A run that fails is reported and the
next one starts: the point is how often the case passes, and why it
fails when it does. It prints the card's name and power limit, each
run's line from ``chip_smoke.py`` and one JSON line a run (the pair's
view epochs and fenced submits, the agents' start seconds, the run's
seconds), and exits 1 if any run failed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import spfft_tpu_torch as sp  # noqa: E402
from spfft_tpu_torch.ops import _build  # noqa: E402


class _Failed(Exception):
    pass


def _fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise _Failed(msg)


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this script needs a "
              "CUDA card", file=sys.stderr)
        return 1
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(cs.CARD, flush=True)
    cs.fail = _fail
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    failed = 0
    for k in range(runs):
        t0 = time.perf_counter()
        try:
            row = cs.pod_tcp_case(sp, torch.device("cuda", 0))
        except _Failed:
            failed += 1
            print(json.dumps({"run": k, "failed": True,
                              "s": time.perf_counter() - t0}), flush=True)
            continue
        print(json.dumps({"run": k, "pair": row.get("pair"),
                          "agent_start_s": row["agent_start_s"],
                          "s": time.perf_counter() - t0}), flush=True)
    print(f"{runs - failed} of {runs} runs passed ({cs.CARD})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
