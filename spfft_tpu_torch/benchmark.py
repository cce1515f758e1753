"""Benchmark CLI: ``python -m spfft_tpu_torch.benchmark`` (the port of
``spfft_tpu/benchmark.py``).

Rebuild of the reference benchmark program (reference:
tests/programs/benchmark.cpp) with the JAX CLI's knobs and output schema:

* workload: dense-within-cutoff stick set — all (x, y) sticks with
  ``x < dim_x_freq * sparsity``, full z sticks, split round-robin over
  shards when distributed (reference: benchmark.cpp:176-205);
* measurement: warm-up pairs, then repeated backward+forward pairs
  (reference: benchmark.cpp:84-96), wall clock with
  ``torch.cuda.synchronize()`` after the warm-up and at the end of the
  timed loop (where the JAX CLI hard-syncs): ``pair_seconds`` is the
  timed loop's wall clock over ``-r`` pairs;
* output: the per-phase timing tree of :mod:`spfft_tpu_torch.timing` and
  a JSON dump with ``timings`` and ``parameters`` sections (reference:
  benchmark.cpp:276-308).

Flags are the JAX CLI's: -d dims, -r repeats, -w warm-ups, -s sparsity,
-t c2c|r2c, -e exchange, -p host|device, -m num transforms, -o json
output, --fused-pair, --fused/--no-fused, --shards, --precision,
--profile-dir. On the port:

* it runs on the card; ``--cpu`` runs the plain PyTorch versions on the
  host (``device="cpu"``). Without a card and without ``--cpu`` it exits
  1 with the port's :class:`~spfft_tpu_torch.errors.DeviceError`;
* ``--fused`` / ``--no-fused`` are the plan's ``fused=`` argument (no
  environment variable);
* ``--shards S`` runs the distributed plan's S shards on one device (the
  JAX CLI refuses more shards than devices);
* ``--profile-dir`` writes a ``torch.profiler`` trace of the timed loop;
* ``-e`` takes every exchange of the JAX CLI and ``--overlap-chunks K``
  any K; ``-e all`` (with ``--shards`` > 1) runs the JAX CLI's exchange
  sweep: one workload under buffered, bufferedFloat, compact,
  compactFloat and unbuffered, a row each (``exchange_sweep``: the pair's
  seconds through ``apply_pointwise``, the aggregate and busiest-link
  wire bytes, the stick set's trimming);
* ``--serve`` runs each repeat's ``-m`` backward and ``-m`` forward
  requests through the serving layer (``spfft_tpu_torch.serve``: a
  registry seeded with the plan, a ``ServeExecutor`` prewarmed for its
  signature, same-signature requests bucketed into the batched route)
  and reports the executor's metrics snapshot as ``params["serve"]``;
* ``--store-dir DIR`` adds the plan-artifact store's cold / warm pair:
  ``cold_start_ms``, this process resolving the plan through a registry
  over the store in DIR and running one backward (a build and a spill
  where DIR starts empty), and ``warm_start_ms``, a fresh ``python -m
  spfft_tpu_torch.serve.store prewarm DIR --compile --strict --json``
  process loading the artifact and running it (``warm_builds`` 0).

The JSON ``parameters`` has every key of the JAX CLI's, meaning on the
port: ``backend`` ``"cuda"`` or ``"cpu"``; ``devices`` the visible
cards; ``pallas`` true where the plan's kernels run on the card;
``fused_fallback`` the plan's ``fused_fallback_reasons``; and two keys
more, ``device_kind`` and ``power_limit`` (``utils.platform``), so that
every number it prints names its card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def cutoff_stick_triplets(dim_x: int, dim_y: int, dim_z: int,
                          sparsity: float, hermitian: bool) -> np.ndarray:
    """Dense-within-cutoff stick set (reference: benchmark.cpp:176-205):
    every (x, y) stick with x below ``dim_x_freq * sparsity``, full z."""
    dim_x_freq = dim_x // 2 + 1 if hermitian else dim_x
    num_x = max(1, min(dim_x_freq, int(round(dim_x_freq * sparsity))))
    x = np.arange(num_x, dtype=np.int32)
    y = np.arange(dim_y, dtype=np.int32)
    z = np.arange(dim_z, dtype=np.int32)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m spfft_tpu_torch.benchmark",
        description="spfft_tpu_torch benchmark (reference: tests/programs/"
                    "benchmark.cpp)")
    p.add_argument("-d", "--dimensions", type=int, nargs="+", required=True,
                   metavar="N", help="grid dims: one value (cubic) or three")
    p.add_argument("-r", "--repeats", type=int, default=10)
    p.add_argument("-w", "--warmups", type=int, default=1)
    p.add_argument("-s", "--sparsity", type=float, default=1.0,
                   help="fraction of x range covered by sticks (default 1)")
    p.add_argument("-t", "--transform", choices=["c2c", "r2c"],
                   default="c2c")
    p.add_argument("-e", "--exchange",
                   choices=["default", "buffered", "bufferedFloat",
                            "compact", "compactFloat", "unbuffered", "all"],
                   default="default",
                   help="exchange of a distributed plan; all: one row per "
                        "exchange (needs --shards > 1)")
    p.add_argument("-p", "--proc", choices=["host", "device"],
                   default="device",
                   help="host: numpy I/O every repeat; device: tensors stay "
                        "resident (reference -p cpu|gpu|gpu-gpu)")
    p.add_argument("-m", "--num-transforms", type=int, default=1)
    p.add_argument("-o", "--output", default=None, metavar="FILE.json")
    p.add_argument("--fused-pair", action="store_true",
                   help="time backward+forward as one apply_pointwise call "
                        "(the identity; requires -m 1)")
    p.add_argument("--fused", dest="fused", action="store_true",
                   default=None,
                   help="the fused compression+z-DFT kernels (the plan's "
                        "fused=True, its default)")
    p.add_argument("--no-fused", dest="fused", action="store_false",
                   help="the two-kernel route (the plan's fused=False)")
    p.add_argument("--serve", action="store_true",
                   help="run each repeat's transforms as requests through "
                        "the serving layer (registry + batching "
                        "executor)")
    p.add_argument("--shards", type=int, default=1,
                   help="run the distributed plan over N shards held on "
                        "one device (default local)")
    p.add_argument("--overlap-chunks", type=int, default=None,
                   metavar="K",
                   help="split the distributed exchange into K "
                        "destination-balanced chunks (default 1, or "
                        "SPFFT_TPU_OVERLAP_CHUNKS)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host: device='cpu', the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="measure the plan-artifact store's cold start "
                        "(this process, empty DIR) against a warm boot "
                        "(a fresh prewarm process over DIR)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the timed loop "
                        "into DIR (trace.json, for chrome://tracing or "
                        "Perfetto)")
    args = p.parse_args(argv)
    if args.fused_pair and args.num_transforms != 1:
        p.error("--fused-pair requires -m 1")
    if args.serve and (args.shards > 1 or args.fused_pair):
        p.error("--serve requires --shards 1 and no --fused-pair")
    if args.store_dir and args.shards > 1:
        p.error("--store-dir measures local plan resolution "
                "(requires --shards 1)")
    return args


_EXCHANGE = {
    "default": "default", "buffered": "buffered",
    "bufferedFloat": "buffered_float", "compact": "compact_buffered",
    "compactFloat": "compact_buffered_float", "unbuffered": "unbuffered",
}


def _store_cold_warm(args, ttype, dims, triplets, device,
                     fused: bool) -> dict:
    """The --store-dir pair (the JAX CLI's ``_store_cold_warm``):
    resolve this workload's plan and run its first backward through a
    store-backed registry in this process (a true COLD start when DIR
    begins empty — build, spill), then the WARM boot in a fresh
    interpreter (``python -m spfft_tpu_torch.serve.store prewarm DIR
    --compile --strict --json``: artifact load + first execution,
    ``builds == 0``)."""
    import os
    import subprocess

    from .serve.registry import PlanRegistry
    from .serve.store import PlanArtifactStore
    from .timing import wait_ready

    cpu = device.type == "cpu"
    store = PlanArtifactStore(args.store_dir, plan_kwargs={"device": "cpu"}
                              if cpu else None)
    reg = PlanRegistry(store=store)
    t0 = time.perf_counter()
    sig, plan = reg.get_or_build(ttype, *dims, triplets,
                                 precision=args.precision, device=device,
                                 fused=fused)
    n = plan.index_plan.num_values
    wait_ready(plan.backward(np.zeros((n, 2), np.float32)
                             if plan.precision == "single"
                             else np.zeros(n, np.complex128)))
    cold_ms = (time.perf_counter() - t0) * 1e3
    store.drain()
    out = {
        "store_dir": args.store_dir,
        # a pre-populated DIR makes the in-process number a warm one;
        # disclose rather than silently mislabel
        "store_was_cold": reg.stats()["builds"] == 1,
        "cold_start_ms": {"value": round(cold_ms, 3), "unit": "ms",
                          "metric": "plan resolve + first execute, "
                                    "empty store (build + spill)"},
    }
    # the fresh process imports this package from the same tree
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(
        [sys.executable, "-m", "spfft_tpu_torch.serve.store", "prewarm",
         args.store_dir, "--compile", "--strict", "--json"]
        + (["--device", "cpu"] if cpu else []),
        capture_output=True, text=True, timeout=1800, env=env)
    if proc.returncode != 0:
        print(f"warning: warm-boot subprocess failed:\n{proc.stderr}",
              file=sys.stderr)
        return out
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    out["warm_start_ms"] = {
        "value": report["warm_resolve_ms"], "unit": "ms",
        "metric": "plan resolve + first execute, fresh process over "
                  "the populated store (artifact load, builds==0)"}
    out["warm_builds"] = report["builds"]
    out["warm_store"] = report["store"]
    return out


def _exchange_sweep(args, dims, ttype, triplets, rng, cdt, device) -> int:
    """-e all: one workload, every exchange (reference:
    benchmark.cpp:138-156 runs the benchmark once per exchange for
    'all'), as the JAX CLI's ``_exchange_sweep``: a table of the pair's
    seconds (``apply_pointwise``, synchronized) and the aggregate and
    busiest-link wire bytes, and the same rows in the -o JSON."""
    import torch
    from .parallel import make_distributed_plan, make_mesh
    from .types import ExchangeType
    from .utils.platform import platform_summary
    from .utils.workloads import (even_plane_split,
                                  round_robin_stick_partition)

    nx, ny, nz = dims
    parts = round_robin_stick_partition(triplets, dims, args.shards)
    planes = even_plane_split(nz, args.shards)
    values_np = [
        (rng.uniform(-1, 1, len(p)) + 1j * rng.uniform(-1, 1, len(p)))
        .astype(cdt) for p in parts]
    fused = True if args.fused is None else args.fused

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    for name in ("buffered", "bufferedFloat", "compact", "compactFloat",
                 "unbuffered"):
        plan = make_distributed_plan(
            ttype, nx, ny, nz, parts, planes,
            mesh=make_mesh(args.shards, device), precision=args.precision,
            exchange=ExchangeType(_EXCHANGE[name]),
            overlap_chunks=args.overlap_chunks, fused=fused)
        values = plan.shard_values(values_np)
        for _ in range(max(args.warmups, 1)):
            plan.apply_pointwise(values)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            plan.apply_pointwise(values)
        sync()
        pair_s = (time.perf_counter() - t0) / args.repeats
        # an R2C plan's exchange ships the non-redundant stick set only,
        # so its wire bytes do not compare with a C2C sweep's
        folded = sum(int(p.value_conj.sum())
                     for p in plan.dist_plan.shard_plans
                     if p.value_conj is not None)
        rows.append({
            "exchange": name,
            "overlap_chunks": plan.overlap_chunks,
            "pair_seconds": round(pair_s, 6),
            "wire_total_bytes": int(plan.exchange_wire_bytes()),
            "busiest_link_bytes": int(plan.exchange_busiest_link_bytes()),
            "hermitian_trimmed": bool(plan.dist_plan.hermitian),
            "folded_mirror_values": folded,
        })
    print(f"{'exchange':>14s} {'pair ms':>10s} {'wire total MB':>14s} "
          f"{'busiest link MB':>16s} {'stick set':>18s}")
    for r in rows:
        trim = ("r2c-trimmed" + (f"(+{r['folded_mirror_values']}f)"
                                 if r["folded_mirror_values"] else "")
                if r["hermitian_trimmed"] else "untrimmed")
        print(f"{r['exchange']:>14s} {r['pair_seconds'] * 1e3:10.3f} "
              f"{r['wire_total_bytes'] / 1e6:14.3f} "
              f"{r['busiest_link_bytes'] / 1e6:16.3f} {trim:>18s}")
    summary = platform_summary(device)
    payload = {
        "parameters": {
            "dim_x": nx, "dim_y": ny, "dim_z": nz,
            "shards": args.shards, "sparsity": args.sparsity,
            "transform_type": args.transform,
            "precision": args.precision, "repeats": args.repeats,
            "backend": summary["backend"],
            "num_values": int(len(triplets)),
            "device_kind": summary["device_kind"],
            "power_limit": summary["power_limit"],
        },
        "exchange_sweep": rows,
    }
    print(json.dumps(payload))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.output}")
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from .errors import DeviceError
    try:
        return _run(args)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1


def _run(args) -> int:
    dims = args.dimensions
    if len(dims) == 1:
        dims = dims * 3
    if len(dims) != 3:
        print("error: -d takes one or three values", file=sys.stderr)
        return 2
    if args.num_transforms < 1:
        print("error: -m must be >= 1", file=sys.stderr)
        return 2
    if args.repeats < 1 or args.warmups < 0:
        print("error: -r must be >= 1 and -w >= 0", file=sys.stderr)
        return 2
    nx, ny, nz = dims

    import torch
    from . import timing
    from .grid import Transform
    from .multi import multi_transform_backward, multi_transform_forward
    from .parallel import make_distributed_plan, make_mesh
    from .plan import make_local_plan, resolve_device
    from .types import ExchangeType, Scaling, TransformType
    from .utils.dtypes import as_interleaved
    from .utils.platform import platform_summary
    from .utils.workloads import (even_plane_split,
                                  round_robin_stick_partition)

    device = resolve_device("cpu" if args.cpu else None)
    cuda = device.type == "cuda"
    ttype = TransformType.C2C if args.transform == "c2c" else TransformType.R2C
    hermitian = ttype == TransformType.R2C
    triplets = cutoff_stick_triplets(nx, ny, nz, args.sparsity, hermitian)
    rng = np.random.default_rng(42)
    cdt = np.complex64 if args.precision == "single" else np.complex128
    if args.exchange == "all":
        if args.shards < 2:
            print("error: -e all compares exchange mechanisms and needs "
                  "--shards > 1", file=sys.stderr)
            return 2
        return _exchange_sweep(args, dims, ttype, triplets, rng, cdt,
                               device)
    exchange = ExchangeType(_EXCHANGE[args.exchange])
    fused = True if args.fused is None else args.fused

    t0 = time.perf_counter()
    if args.shards > 1:
        parts = round_robin_stick_partition(triplets, dims, args.shards)
        planes = even_plane_split(nz, args.shards)
        plan = make_distributed_plan(ttype, nx, ny, nz, parts, planes,
                                     mesh=make_mesh(args.shards, device),
                                     precision=args.precision,
                                     exchange=exchange,
                                     overlap_chunks=args.overlap_chunks,
                                     fused=fused)
        values_np = [
            (rng.uniform(-1, 1, len(p)) + 1j * rng.uniform(-1, 1, len(p)))
            .astype(cdt) for p in parts]
        values = plan.shard_values(values_np)
    else:
        plan = make_local_plan(ttype, nx, ny, nz, triplets,
                               precision=args.precision, device=device,
                               fused=fused)
        n = len(triplets)
        v = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)).astype(cdt)
        values_np = np.asarray(as_interleaved(v, args.precision))
        values = torch.as_tensor(values_np, device=device)
    if cuda:
        torch.cuda.synchronize(device)
    plan_s = time.perf_counter() - t0

    transforms = [Transform(plan) for _ in range(args.num_transforms)]
    m = args.num_transforms
    serve_executor = None
    if args.serve:
        # the serving layer over the SAME plan: the registry is seeded
        # with the already-built plan and each repeat submits m backward
        # and then m forward requests — the executor's same-signature
        # bucketing turns each phase into batched buckets
        from .serve import PlanRegistry, PlanSignature, ServeExecutor
        registry = PlanRegistry()
        serve_sig = PlanSignature.of_plan(plan)
        registry.put(serve_sig, plan)
        serve_executor = ServeExecutor(registry)
        # every repeat submits exactly m same-signature requests, so the
        # adaptive observer pins the exact shape m after a few repeats —
        # prewarm it alongside the pow2 ladder
        serve_executor.prewarm(serve_sig, batch_sizes=(m,))

        def run_pair(vals):
            spaces = [f.result() for f in
                      [serve_executor.submit(serve_sig, vals)
                       for _ in range(m)]]
            return [f.result() for f in
                    [serve_executor.submit(serve_sig, s, "forward")
                     for s in spaces]]
    elif args.fused_pair:
        def run_pair(vals):
            # backward + forward as one call (the identity operator)
            return plan.apply_pointwise(vals)
    else:
        def run_pair(vals):
            spaces = multi_transform_backward(transforms, [vals] * m)
            return multi_transform_forward(transforms, spaces,
                                           [Scaling.NONE] * m)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    host_io = args.proc == "host"
    feed = values_np if host_io else values

    def read_back(outs):
        # host mode copies results to numpy inside the timed loop, so both
        # transfer directions are measured (reference -p cpu semantics)
        for a in (outs if isinstance(outs, list) else [outs]):
            a.cpu().numpy()

    for _ in range(args.warmups):
        run_pair(feed)
    sync()

    profiler = None
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
    timing.enable()
    timing.GlobalTimer.reset()
    t0 = time.perf_counter()
    for _ in range(args.repeats):
        outs = run_pair(feed)
        if host_io:
            read_back(outs)
    sync()
    total = time.perf_counter() - t0
    timing.disable()
    if profiler is not None:
        import os
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        print(f"wrote torch.profiler trace to {path}", file=sys.stderr)

    pair_s = total / args.repeats
    result = timing.GlobalTimer.process()
    summary = platform_summary(device)
    params = {
        "proc": args.proc, "shards": args.shards,
        "devices": summary["device_count"], "backend": summary["backend"],
        "dim_x": nx, "dim_y": ny, "dim_z": nz,
        "exchange": args.exchange, "repeats": args.repeats,
        "overlap_chunks": int(getattr(plan, "overlap_chunks", 1)),
        "transform_type": args.transform, "num_transforms": m,
        "fused_pair": bool(args.fused_pair),
        "sparsity": args.sparsity, "precision": args.precision,
        "num_values": int(len(triplets)),
        "pallas": cuda,
        "fused": bool(getattr(plan, "fused_active", False)),
        "fused_fallback": dict(getattr(plan, "fused_fallback_reasons",
                                       None) or {}),
        "fused_dist": bool(getattr(plan, "fused_dist_active", False)),
        "fused_dist_fallback": {
            k: v for k, v in
            (("bwd", getattr(plan, "fused_dist_fallback_reason", None)),
             ("fwd", getattr(plan, "fused_dist_fwd_fallback_reason",
                             None)))
            if v is not None},
        "plan_seconds": round(plan_s, 4),
        "pair_seconds": round(pair_s, 6),
        "device_kind": summary["device_kind"],
        "power_limit": summary["power_limit"],
    }
    if serve_executor is not None:
        serve_executor.close()
        params["serve"] = serve_executor.metrics.snapshot(
            serve_executor.registry)
    if args.store_dir:
        params.update(_store_cold_warm(args, ttype, (nx, ny, nz),
                                       triplets, device, fused))
    print(json.dumps(params, indent=2))
    result.print()
    if args.output:
        payload = json.loads(result.json())
        payload["parameters"] = params
        with open(args.output, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
