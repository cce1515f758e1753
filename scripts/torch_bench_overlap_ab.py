#!/usr/bin/env python
"""Same-session interleaved A/B of the port's distributed exchange:
monolithic (K = 1) against chunked (K in {2, 4}) ``overlap_chunks``,
for the block (``buffered``) and the ragged (``ragged``) exchange — the
port of ``scripts/bench_overlap_ab.py`` with its flags and payload keys.

Protocol: one process builds every (exchange, K) plan of S shards on
one device and the timed rounds INTERLEAVE across plans (A/B/A/B), so
drift (allocator warm-up, clocks) hits every variant alike. Per variant
it reports the median and the least of the rounds' pair times (one
``apply_pointwise`` round trip, ``--reps`` of them between two reads of
the clock, the device synchronized at the end of each group) and the
exchange's structure: its collectives a direction (one a chunk) and the
bytes the plan's wire moves. The port's S shards share one device and
one stream, so K chunks overlap nothing: ``async_starts`` is 0 and
``overlap_meaningful`` false, and the rows measure what chunking costs.
The exchange only moves values, so every variant's round trip must be
bit for bit the same plan's without chunks; the script exits 1
otherwise.

    python scripts/torch_bench_overlap_ab.py [--shards 8] [--dim 48] \
        [--reps 10] [--rounds 5] [--cpu] [-o overlap_ab.json]

It runs on the card; ``--cpu`` runs the plans' plain versions on the
host.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--reps", type=int, default=10,
                    help="pairs per measurement group")
    ap.add_argument("--rounds", type=int, default=5,
                    help="interleaved rounds per variant")
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host: device='cpu', the kernels' "
                         "plain PyTorch versions")
    ap.add_argument("-o", "--output", default=None, metavar="FILE.json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from spfft_tpu_torch import ExchangeType, TransformType
    from spfft_tpu_torch.errors import DeviceError
    from spfft_tpu_torch.parallel import make_distributed_plan, make_mesh
    from spfft_tpu_torch.plan import resolve_device
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition,
                                                 spherical_cutoff_triplets)

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    n, S = args.dim, args.shards
    tr = spherical_cutoff_triplets(n)
    parts = round_robin_stick_partition(tr, (n, n, n), S)
    planes = even_plane_split(n, S)
    mesh = make_mesh(S, device)
    rng = np.random.default_rng(42)
    vals_np = [(rng.uniform(-1, 1, len(p))
                + 1j * rng.uniform(-1, 1, len(p))).astype(np.complex64)
               for p in parts]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    failures = []
    variants = []
    for exch, ename in ((ExchangeType.DEFAULT, "buffered"),
                        (ExchangeType.COMPACT_BUFFERED, "ragged")):
        base = make_distributed_plan(TransformType.C2C, n, n, n, parts,
                                     planes, mesh=mesh, exchange=exch,
                                     overlap_chunks=1)
        want = base.apply_pointwise(base.shard_values(vals_np))
        for k in args.chunks:
            plan = make_distributed_plan(
                TransformType.C2C, n, n, n, parts, planes, mesh=mesh,
                exchange=exch, overlap_chunks=k)
            v = plan.shard_values(vals_np)
            if not torch.equal(plan.apply_pointwise(v), want):
                failures.append(f"{ename} K={plan.overlap_chunks}: the "
                                f"round trip differs from the plan's "
                                f"without chunks")
            variants.append({
                "label": f"{ename}-k{plan.overlap_chunks}",
                "exchange": ename, "k": plan.overlap_chunks,
                "plan": plan, "values": v,
                # one collective a chunk, a direction (the plan's
                # schedule; no compiler merges or splits them here)
                "collectives_bwd": plan.overlap_chunks,
                # one stream: no collective starts ahead of its wait
                "async_starts": 0,
                "wire_total_bytes": int(plan.exchange_wire_bytes()),
                "times": []})
        del base, want

    for var in variants:  # warm every plan before any timing
        var["plan"].apply_pointwise(var["values"])
    sync()
    for _ in range(args.rounds):
        for var in variants:  # interleaved: one group per variant
            t0 = time.perf_counter()
            for _ in range(args.reps):
                var["plan"].apply_pointwise(var["values"])
            sync()
            var["times"].append((time.perf_counter() - t0) / args.reps)

    rows = []
    base_ms = {}
    for var in variants:
        ms = sorted(t * 1e3 for t in var["times"])
        med = statistics.median(ms)
        if var["k"] == 1:
            base_ms[var["exchange"]] = med
        rows.append({k: var[k] for k in
                     ("label", "exchange", "k", "collectives_bwd",
                      "async_starts", "wire_total_bytes")}
                    | {"pair_ms_median": round(med, 3),
                       "pair_ms_min": round(ms[0], 3),
                       "vs_k1": round(base_ms[var["exchange"]] / med, 3)})
    payload = {
        "backend": device.type, "shards": S, "dim": n,
        "num_values": int(len(tr)), "reps": args.reps,
        "rounds": args.rounds,
        "overlap_meaningful": False,
        "note": ("the S shards share one device and one stream: K "
                 "chunks overlap nothing, so K>1 measures chunking "
                 "overhead, not overlap wins"),
        "rows": rows,
    }
    print(json.dumps(payload, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.output}")
    for msg in failures:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
