#!/usr/bin/env python
"""Multi-process distributed transform — how to run spfft_tpu_torch over
several processes, one per GPU.

One process per card; each process contributes only its own shards' sparse
indices, the allgather-based plan build makes the identical global plan
everywhere (the reference's MPI stick-list exchange, indices.hpp:58-102),
and plan construction cross-checks parameters across processes. The plan's
8 shards are spread over the processes of a ``torch.distributed`` group,
8 / P on each, and each process checks only its own shards.

Launch one process per rank, passing rank 0's address as the coordinator:

    python examples_torch/example_multihost.py --coordinator 10.0.0.1:8476 \\
        --num-processes 4 --process-id $RANK

With one card for each process the group runs over NCCL; where several
processes share a card (NCCL refuses two ranks on one device), or with
``--device cpu``, over gloo. Run without arguments it is one process that
holds all 8 shards and exercises the same code path.

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the host. Without a card and without ``--device
cpu`` it exits 1 with the port's ``DeviceError``.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import spfft_tpu_torch as sp  # noqa: E402
from spfft_tpu_torch.parallel import multihost  # noqa: E402
from spfft_tpu_torch.plan import resolve_device  # noqa: E402
from spfft_tpu_torch.utils.workloads import (  # noqa: E402
    even_plane_split, round_robin_stick_partition, spherical_cutoff_triplets)

SHARDS = 8
#: the bar of the round trip's max error over this process's shards
TOLERANCE = 1e-3


def process_device(device, process_id: int) -> torch.device:
    """This process's device: ``device`` where given, else the card
    ``process_id % device_count`` (raises the port's ``DeviceError``
    without a card)."""
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    return resolve_device(device)


def group_backend(device: torch.device, num_processes: int):
    """The process group's backend: the port's default (NCCL on a card)
    where each process has a card of its own, gloo on the host or where
    processes share a card."""
    if device.type != "cuda" or torch.cuda.device_count() < num_processes:
        return "gloo"
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (omit = 1 process)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the card "
                         "process-id modulo the card count; 'cpu' runs the "
                         "kernels' plain PyTorch versions on the host)")
    args = ap.parse_args(argv)

    try:
        device = process_device(args.device, args.process_id or 0)
    except sp.DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.cuda.set_device(device)
    num_processes = args.num_processes or 1
    multihost.initialize(args.coordinator, args.num_processes,
                         args.process_id,
                         backend=group_backend(device, num_processes))

    import torch.distributed as dist
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = sp.make_mesh(SHARDS, device, process_group=group)
    pidx, pcount = mesh.rank, mesh.num_processes

    # every process computes the same global partition, then keeps its own
    # shards — in a real application each process would know only its part
    n = args.dim
    triplets = spherical_cutoff_triplets(n)
    parts = round_robin_stick_partition(triplets, (n, n, n), SHARDS)
    planes = even_plane_split(n, SHARDS)
    mine = mesh.shard_range

    dist_plan = multihost.build_distributed_plan_multihost(
        sp.TransformType.C2C, n, n, n,
        local_triplets=parts[mine.start:mine.stop],
        local_planes=planes[mine.start:mine.stop], process_group=group)
    plan = sp.DistributedTransformPlan(dist_plan, mesh=mesh,
                                       precision="single")

    rng = np.random.default_rng(0)
    values = [
        (rng.uniform(-1, 1, len(p)) + 1j * rng.uniform(-1, 1, len(p)))
        .astype(np.complex64) for p in parts]
    out = plan.apply_pointwise([values[r] for r in mine],
                               scaling=sp.Scaling.FULL)
    # each process holds, and reads, only its own shards
    err = 0.0
    for r, got in zip(mine, plan.unshard_values(out)):
        if len(got):
            err = max(err, float(np.abs(got - values[r]).max()))
    print(f"process {pidx}/{pcount}: {SHARDS} shards, "
          f"round-trip max err over local shards = {err:.2e}", flush=True)
    if group is not None:
        dist.destroy_process_group()
    if not err < TOLERANCE:
        print(f"error: the round trip's max error {err:.2e} is not under "
              f"{TOLERANCE:.0e}", file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
