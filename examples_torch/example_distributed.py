"""Distributed sparse transform over a shard mesh: spherical-cutoff C2C on
8 shards (slab/pencil decomposition), over spfft_tpu_torch.

The 8 shards sit on one device (``make_mesh(8)``): the exchange between
them is a copy on that device. Over several GPUs the same plan runs one
process per card on a mesh over a ``torch.distributed`` group
(``examples_torch/example_multihost.py``).

Run: python examples_torch/example_distributed.py [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the host. Without a card and without ``--device
cpu`` it exits 1 with the port's ``DeviceError``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import spfft_tpu_torch as sp  # noqa: E402
from spfft_tpu_torch.plan import resolve_device  # noqa: E402
from spfft_tpu_torch.utils.workloads import (  # noqa: E402
    even_plane_split, round_robin_stick_partition, spherical_cutoff_triplets)

SHARDS = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain PyTorch versions "
                         "on the host)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except sp.DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1

    n = 32
    triplets = spherical_cutoff_triplets(n)
    parts = round_robin_stick_partition(triplets, (n, n, n), SHARDS)
    planes = even_plane_split(n, SHARDS)

    plan = sp.make_distributed_plan(sp.TransformType.C2C, n, n, n, parts,
                                    planes, mesh=sp.make_mesh(SHARDS, device),
                                    precision="single")
    print(f"{plan.num_global_elements} sparse values over "
          f"{plan.mesh.num_shards} shards")

    rng = np.random.default_rng(0)
    values = [(rng.uniform(-1, 1, len(p)) + 1j * rng.uniform(-1, 1, len(p)))
              .astype(np.complex64) for p in parts]

    space = plan.backward(values)                # freq -> space, exchange inside
    freq = plan.forward(space, sp.Scaling.FULL)  # space -> freq, scaled

    round_trip = plan.unshard_values(freq)
    err = max(np.abs(round_trip[r] - values[r]).max() for r in range(SHARDS))
    print(f"round-trip max error: {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
