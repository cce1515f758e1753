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
* ``--serve``, ``--store-dir``, ``--overlap-chunks K > 1`` and ``-e``
  bufferedFloat, compact, compactFloat, unbuffered and all exit 2 with
  the port's typed not-in-slice error: their modules come later.

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
                   help="exchange of a distributed plan; the port runs "
                        "default and buffered (the block exchange)")
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
                   help="the serving layer (not in this slice)")
    p.add_argument("--shards", type=int, default=1,
                   help="run the distributed plan over N shards held on "
                        "one device (default local)")
    p.add_argument("--overlap-chunks", type=int, default=None,
                   metavar="K",
                   help="chunks of the distributed exchange (only 1 in "
                        "this slice)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the host: device='cpu', the kernels' plain "
                        "PyTorch versions")
    p.add_argument("--precision", choices=["single", "double"],
                   default="single")
    p.add_argument("--store-dir", default=None, metavar="DIR",
                   help="the plan-artifact store A/B (not in this slice)")
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


def _out_of_slice(args):
    """The typed not-in-slice error of the first flag this slice does
    not run, or None."""
    from .plan import _not_in_slice
    if args.serve:
        return _not_in_slice("--serve (the serving layer)", "serving")
    if args.store_dir:
        return _not_in_slice("--store-dir (the plan-artifact store)",
                             "serving")
    if args.overlap_chunks is not None and args.overlap_chunks > 1:
        return _not_in_slice(f"--overlap-chunks {args.overlap_chunks}",
                             "compact, ring and overlap exchange")
    if args.exchange not in ("default", "buffered"):
        later = "wire-ladder" if args.exchange == "bufferedFloat" \
            else "compact, ring and overlap exchange"
        return _not_in_slice(f"-e {args.exchange}", later)
    return None


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from .errors import DeviceError
    refused = _out_of_slice(args)
    if refused is not None:
        print(f"error: {type(refused).__name__}: {refused}", file=sys.stderr)
        return 2
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
    if args.fused_pair:
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
