#!/usr/bin/env python3
"""A/B of the PyTorch port's gather between source trees, on one CUDA card.

    python3 scripts/torch_gather_ab.py TREE [TREE ...]

runs one measurement per tree argument, in the order given (for an A/B in
turns: parent, change, change, parent), each in a fresh process that
imports that tree's ``spfft_tpu_torch`` (its kernels build into the
tree's own ``build/``) and drives it with this checkout's ``chip_smoke.py``
(its plans and values, ``timed_ms`` and ``graph_ms``). It prints the
card's name and power limit, one JSON line per run and a table of every
number by run, and writes the runs to ``chiprun_out/torch_gather_ab.json``.

One run measures at 256^3:

* the gathers of the two-kernel route (``fused=False``), decompress and
  compress: C2C and R2C through ``gather_kernel.decompress`` /
  ``compress`` (rows 8, 8r of PERF.md; B = 4: 8b, 8rb), and over the
  distributed plan's 4 shards (8d, 8dr) the gather launches that the
  plan's own z stages make, recorded once and replayed (whatever the
  tree's plan launches: one per shard, or one over every shard). Each is
  timed one call at a time (``timed_ms``: CUDA events around one call,
  the wrapper's host work included) and on the device alone
  (``graph_ms``: calls captured in one CUDA graph and replayed);
* the public backward + forward(FULL) pair of every route: local and
  distributed, C2C and R2C, fused and two-kernel, both ways (3 pairs in
  one CUDA graph for the device time).
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 256
BATCH = 4


def recorded(gk, stage):
    """The gather launches that ``stage()`` makes, as one function that
    replays them on the same operands."""
    calls, real = [], gk.gather

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        real(*args, **kwargs)

    record.launches = 0  # the wrapper counts its launches on its own name
    gk.gather = record
    try:
        stage()
    finally:
        gk.gather = real
    return lambda: [real(*a, **k) for a, k in calls]


def measure(tree: str) -> dict:
    """One run on ``tree``: ``{"rows": {row: {direction: [call ms,
    device ms]}}, "pairs": {route: [call ms, device ms]}}``."""
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    import spfft_tpu_torch as sp
    from spfft_tpu_torch.ops import _build, gather_kernel as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows, pairs = {}, {}

    def both(fn, calls=cs.GRAPH_CALLS):
        return [cs.timed_ms(fn, dev), cs.graph_ms(fn, dev, calls)]

    def pair(name, plan, values):
        pairs[name] = both(
            lambda: plan.forward(plan.backward(values), sp.Scaling.FULL), 3)

    def local(path, plan, values):
        plan2 = sp.TransformPlan(plan.index_plan, device=dev, fused=False)
        p = plan2.index_plan
        dz, s, pair_io = p.dim_z, p.num_sticks, plan2.pair_values_io
        ss, vi = plan2._slot_src, plan2._value_indices
        for row, v in ((path, plan2._coerce_values(values)),
                       (path + "b", cs.band_values(plan2, values, BATCH))):
            if plan2._conj is not None:
                v = v * plan2._conj
            sr, si = gk.decompress(v, ss, dz, pair_io)
            fr = sr[..., :s, :].contiguous()
            fi = si[..., :s, :].contiguous()
            rows[row] = {
                "dec": both(lambda: gk.decompress(v, ss, dz, pair_io)),
                "cmp": both(lambda: gk.compress(fr, fi, vi, pair_io))}
            del sr, si, fr, fi
        pair(f"{path} fused", plan, values)
        pair(f"{path} two-kernel", plan2, values)

    def dist(path, plan, stacked):
        plan2 = sp.DistributedTransformPlan(plan.dist_plan, mesh=plan.mesh,
                                            fused=False)
        dp = plan2.dist_plan
        sticks = tuple(torch.randn((1, dp.num_shards, dp.max_sticks,
                                    dp.dim_z), device=dev) for _ in range(2))
        rows[path] = {
            "dec": both(recorded(gk, lambda: plan2._z_backward(
                stacked[:, None]))),
            "cmp": both(recorded(gk, lambda: plan2._z_forward(sticks,
                                                              True)))}
        pair(f"{path} fused", plan, stacked)
        pair(f"{path} two-kernel", plan2, stacked)

    plan, trip, values = cs.main_path_plan(sp, N, dev)
    local("8", plan, values)
    dplan, stacked = cs.dist_plan(sp, N, trip, values, dev)
    dist("8d", dplan, stacked)
    del plan, trip, values, dplan, stacked
    plan, trip, values, _ = cs.r2c_plan(sp, N, dev)
    local("8r", plan, values)
    dplan, stacked = cs.dist_plan(sp, N, trip, values, dev, r2c=True)
    dist("8dr", dplan, stacked)
    return {"tree": tree, "rows": rows, "pairs": pairs}


def main() -> int:
    if sys.argv[1:2] == ["--tree"]:
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", tree], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-3000:] + proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for row in runs[0]["rows"]:
        for d in ("dec", "cmp"):
            cells = " | ".join(f"{r['rows'][row][d][0]:.4f} / "
                               f"{r['rows'][row][d][1]:.4f}" for r in runs)
            print(f"row {row} {d} (call / device ms): {cells}")
    for name in runs[0]["pairs"]:
        cells = " | ".join(f"{r['pairs'][name][0]:.4f} / "
                           f"{r['pairs'][name][1]:.4f}" for r in runs)
        print(f"pair {name} (call / device ms): {cells}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "torch_gather_ab.json"), "w") as f:
        json.dump({"device": smi.stdout.strip(), "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
