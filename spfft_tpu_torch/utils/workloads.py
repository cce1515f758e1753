"""Canonical benchmark workload generators (counterpart of
``spfft_tpu.utils.workloads``).

The flagship workload is the full spherical cutoff of a plane-wave DFT
code (reference: tests/programs/benchmark.cpp:176-205 builds a
dense-within-cutoff stick set). Pure numpy, identical output to the JAX
package's generators.
"""

from __future__ import annotations

import numpy as np

from ..indexing import to_storage_index


def round_robin_stick_partition(triplets: np.ndarray, dims,
                                num_shards: int) -> list:
    """Assign whole z-sticks round-robin to shards, in ascending stick
    key order (a stick must live wholly on one shard — reference
    README.md:8). Returns a list of per-shard triplet arrays."""
    triplets = np.asarray(triplets)
    _, ny, _ = dims
    storage = np.where(triplets < 0,
                       triplets + np.asarray(dims, triplets.dtype), triplets)
    keys = storage[:, 0].astype(np.int64) * ny + storage[:, 1]
    _, rank = np.unique(keys, return_inverse=True)
    owners = rank.reshape(-1) % num_shards
    return [triplets[owners == r] for r in range(num_shards)]


def even_plane_split(dim_z: int, num_shards: int) -> list:
    """Split z planes as evenly as possible (slab heights, sum ==
    dim_z)."""
    base, extra = divmod(dim_z, num_shards)
    return [base + (1 if r < extra else 0) for r in range(num_shards)]


def spherical_cutoff_triplets(n: int, radius: int | None = None) -> np.ndarray:
    """All (x, y, z) with x^2+y^2+z^2 <= radius^2 in centered indexing
    (default radius n//2) — the plane-wave sphere of a DFT code."""
    c = np.arange(n)
    c = np.where(c > n // 2, c - n, c).astype(np.int32)
    r = n // 2 if radius is None else radius
    X, Y, Z = np.meshgrid(c, c, c, indexing="ij")
    mask = X * X + Y * Y + Z * Z <= r * r
    return np.stack([X[mask], Y[mask], Z[mask]], axis=1)


def sort_triplets_stick_major(triplets: np.ndarray, dims) -> np.ndarray:
    """Sort sparse triplets stick-major (by storage (x, y)) and
    z-ascending within each stick — the layout the reference recommends
    for performance (docs/source/details.rst "Data Distribution").
    Returns a new array; the caller's value arrays must be reordered the
    same way."""
    t = np.asarray(triplets).reshape(-1, 3)
    storage = np.stack([to_storage_index(n, t[:, axis])
                        for axis, n in enumerate(dims)], axis=1)
    order = np.lexsort((storage[:, 2],
                        storage[:, 0].astype(np.int64) * dims[1]
                        + storage[:, 1]))
    return t[order]
