#!/usr/bin/env python
"""Spectral Poisson solver on the sparse frequency set, over
spfft_tpu_torch.

Solves ∇²φ = -ρ on a periodic box the way plane-wave DFT codes do
(Hartree potential): forward-transform the density, scale each sparse
coefficient by 1/|G|² (the whole point of the sparse representation — the
multiplier is applied only to the stored coefficients, no dense cube
exists), and transform back.

Run: python examples_torch/example_poisson.py [--device cpu]

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
from spfft_tpu_torch.utils import as_complex_np  # noqa: E402
from spfft_tpu_torch.utils.workloads import (  # noqa: E402
    spherical_cutoff_triplets)

#: the bar of the residual, relative to max |ρ|
TOLERANCE = 1e-4


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
    box = 2 * np.pi  # box length -> G vectors are integer frequencies
    triplets = spherical_cutoff_triplets(n)  # centered indexing
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, triplets,
                              precision="single", device=device)

    # a density: two opposite Gaussian blobs (net neutral), dense on the
    # grid
    zz, yy, xx = np.meshgrid(*(np.linspace(0, box, n, endpoint=False),) * 3,
                             indexing="ij")

    def blob(cx, cy, cz, sign):
        r2 = (xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2
        return sign * np.exp(-r2 / 0.5)

    rho = blob(2.0, 2.0, 2.0, +1.0) + blob(4.5, 4.5, 4.5, -1.0)
    rho = rho.astype(np.complex64)

    # forward: dense space field -> sparse coefficients (with 1/N scaling)
    rho_g = as_complex_np(plan.forward(rho, sp.Scaling.FULL))

    # spectral solve: phi_G = rho_G / |G|^2, G=0 mode fixed to 0
    # (neutrality)
    g2 = (triplets.astype(np.float64) ** 2).sum(axis=1)
    phi_g = np.where(g2 > 0, rho_g / np.maximum(g2, 1), 0).astype(
        np.complex64)

    # backward: sparse potential coefficients -> dense potential (the
    # program's product; the check below works on the coefficients)
    phi = as_complex_np(plan.backward(phi_g))  # noqa: F841

    # residual check: -∇²φ computed spectrally must reproduce rho (within
    # the cutoff sphere — the solver lives entirely in the sparse set)
    lap_g = (-g2 * phi_g).astype(np.complex64)
    lap = as_complex_np(plan.backward(lap_g))
    rho_in_cutoff = as_complex_np(plan.backward(rho_g))
    err = np.abs(lap + rho_in_cutoff).max() / np.abs(rho_in_cutoff).max()
    print(f"grid {n}^3, {len(triplets)} plane waves "
          f"({len(triplets) / n**3:.0%} of dense)")
    print(f"max |∇²φ + ρ| / max|ρ| = {err:.2e}")
    if not err < TOLERANCE:
        print(f"error: the residual {err:.2e} is not under {TOLERANCE:.0e}",
              file=sys.stderr)
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
