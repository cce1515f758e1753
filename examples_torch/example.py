"""Dense 2x2x2 C2C round-trip through the Grid/Transform API — the
reference's example program (reference: examples/example.cpp, also embedded
in README.md:73-159), in Python over spfft_tpu_torch.

Run: python examples_torch/example.py [--device cpu]

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

    dim_x = dim_y = dim_z = 2
    print(f"Dimensions: x = {dim_x}, y = {dim_y}, z = {dim_z}\n")

    # use all frequency elements, like the reference example
    indices = np.array([(x, y, z)
                        for x in range(dim_x)
                        for y in range(dim_y)
                        for z in range(dim_z)], np.int32)
    num_elements = len(indices)
    values = np.arange(num_elements) * (1.0 - 1.0j)

    print("Input:")
    for v in values:
        print(f"{v.real}, {v.imag}")

    grid = sp.Grid(dim_x, dim_y, dim_z, dim_x * dim_y,
                   sp.ProcessingUnit.DEVICE, device=device)
    transform = grid.create_transform(
        sp.ProcessingUnit.DEVICE, sp.TransformType.C2C, dim_x, dim_y, dim_z,
        local_z_length=dim_z, num_local_elements=num_elements,
        index_format=sp.IndexFormat.TRIPLETS, indices=indices)

    space = transform.backward(values)
    print("\nAfter backward transform:")
    for v in space.cpu().numpy().reshape(-1, 2):
        print(f"{v[0]}, {v[1]}")

    freq = transform.forward(scaling=sp.Scaling.NONE)
    print("\nAfter forward transform (without scaling):")
    for v in freq.cpu().numpy():
        print(f"{v[0]}, {v[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
