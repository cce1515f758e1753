#!/usr/bin/env python
"""SCF-style inner loop: apply a local potential in the space domain.

The workload SpFFT exists for (plane-wave DFT codes): each iteration takes
sparse frequency coefficients, transforms to real space, multiplies by a
potential field, and transforms back. Here the whole step is one
``apply_pointwise`` call — the potential is a tensor on the plan's device
passed through ``fn_args``, updated between iterations.

Updating it builds nothing: after the first step no kernel library is
built or loaded and no DFT table is made, and every step launches the same
kernels the same number of times. Each step prints its launches (the
kernel wrappers' counters; 0 on the CPU, where only the plain versions
run) and its builds, and the run fails when a later step builds or
launches differently.

Run: python examples_torch/example_scf.py [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the kernels'
plain PyTorch versions on the host. Without a card and without ``--device
cpu`` it exits 1 with the port's ``DeviceError``.
"""

import argparse
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))
import spfft_tpu_torch as sp  # noqa: E402
from spfft_tpu_torch.ops import (_build, dft, dft_kernel,  # noqa: E402
                                 fused_kernel, gather_kernel, wire_kernel)
from spfft_tpu_torch.plan import resolve_device  # noqa: E402
from spfft_tpu_torch.utils.workloads import (  # noqa: E402
    spherical_cutoff_triplets)

STEPS = 5


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, by name."""
    return {name: fn.launches
            for mod in (dft_kernel, fused_kernel, gather_kernel, wire_kernel)
            for name, fn in vars(mod).items()
            if not name.startswith("_") and hasattr(fn, "launches")}


def builds() -> int:
    """Kernel libraries built or loaded, and DFT tables made, so far in
    this process."""
    tables = sum(f.cache_info().misses for f in vars(dft).values()
                 if hasattr(f, "cache_info"))
    return len(_build.build_log) + tables


def apply_potential(space, potential):
    # space is (nz, ny, nx, 2) interleaved; the potential is real and
    # multiplies both components
    return space * potential[..., None]


def next_potential(potential):
    """The potential of the next step: relaxed towards a cosine along x."""
    n = potential.shape[-1]
    wave = torch.cos(torch.linspace(0, math.pi, n, dtype=potential.dtype,
                                    device=potential.device))
    return potential * 0.99 + 0.01 * wave[None, None, :]


def initial_coeffs(n_values: int) -> np.ndarray:
    """The first step's coefficients, from the seed of the JAX example."""
    rng = np.random.default_rng(0)
    return (rng.uniform(-1, 1, n_values)
            + 1j * rng.uniform(-1, 1, n_values)).astype(np.complex64)


def main(n: int = 32, device=None, steps: int = STEPS, on_step=None) -> list:
    """``steps`` SCF steps on the ``n``^3 sphere on ``device`` (the card by
    default). ``on_step(it, coeffs, potential, result)``, where given, sees
    each step's inputs and result before the next step. Returns one record
    a step: ``norm``, ``launches`` (by wrapper) and ``builds``. Raises
    RuntimeError when a step after the first builds anything or launches
    differently from the first."""
    device = resolve_device(device)
    triplets = spherical_cutoff_triplets(n)
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, triplets,
                              precision="single", device=device)
    coeffs = initial_coeffs(len(triplets))
    coeffs = torch.as_tensor(np.stack([coeffs.real, coeffs.imag], -1),
                             device=device)
    potential = torch.ones((n, n, n), dtype=torch.float32, device=device)
    records = []
    for it in range(steps):
        launched, built = launch_counts(), builds()
        # one step: backward -> V*psi -> forward, scaled back to
        # coefficient convention
        result = plan.apply_pointwise(coeffs, apply_potential, potential,
                                      scaling=sp.Scaling.FULL)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        launched = {k: v - launched[k] for k, v in launch_counts().items()
                    if v != launched[k]}
        built = builds() - built
        if on_step is not None:
            on_step(it, coeffs, potential, result)
        coeffs = result
        # update the potential between steps: no build, the same launches
        potential = next_potential(potential)
        norm = float(torch.linalg.norm(coeffs))
        records.append({"norm": norm, "launches": launched, "builds": built})
        print(f"iter {it}: |coeffs| = {norm:.6f}, "
              f"kernel launches: {sum(launched.values())}, "
              f"builds: {built}", flush=True)
    for it, rec in enumerate(records[1:], 1):
        if rec["builds"] or rec["launches"] != records[0]["launches"]:
            raise RuntimeError(
                f"step {it} built {rec['builds']} and launched "
                f"{rec['launches']}, against step 0's launches "
                f"{records[0]['launches']}: potential updates must not "
                f"build anything or change the launches")
    print("OK")
    return records


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain PyTorch versions "
                         "on the host)")
    args = ap.parse_args(argv)
    try:
        main(device=args.device)
    except sp.DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
