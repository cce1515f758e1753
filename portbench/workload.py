"""The inputs of a cell: the frequency triplets of its configuration and
the bands and potential drawn from ``--seed``.

:func:`cutoff_stick_triplets` is a frozen copy of the stick set of
SpFFT's benchmark program (``tests/programs/benchmark.cpp``), as
``spfft_tpu_torch.benchmark.cutoff_stick_triplets`` ports it (which
rounds ``dimXFreq * sparsity`` where the source's loop takes every x
below it), kept here so that a change to the program cannot change the
yardstick. Only numpy and torch are imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

REAL_DTYPES = {"single": torch.float32, "double": torch.float64}


def cutoff_stick_triplets(dims, transform: str,
                          sparsity: float) -> np.ndarray:
    """Every (x, y) stick with x below ``dim_x_freq * sparsity``, each
    full in z, in storage indexing, x-major, then y, then z ascending
    (``dim_x_freq`` is ``dim_x // 2 + 1`` for ``r2c``, else ``dim_x``),
    as the source's loop ``for (x = 0; x < dimXFreq * sparsity; ++x)``
    takes them. ``(N, 3)`` int32."""
    nx, ny, nz = dims
    dim_x_freq = nx // 2 + 1 if transform == "r2c" else nx
    num_x = min(dim_x_freq, math.ceil(dim_x_freq * sparsity))
    if num_x < 1:
        raise ValueError(f"sparsity {sparsity} leaves no stick")
    x = np.arange(num_x, dtype=np.int32)
    y = np.arange(ny, dtype=np.int32)
    z = np.arange(nz, dtype=np.int32)
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)


def config_triplets(cfg: dict) -> np.ndarray:
    """The triplets a configuration states: its ``cutoff`` at its
    ``sparsity``."""
    if cfg["cutoff"] != "x_below_sparsity":
        raise ValueError(f"{cfg['name']}: unknown cutoff {cfg['cutoff']!r}")
    return cutoff_stick_triplets(cfg["dims"], cfg["transform"],
                                 cfg["sparsity"])


def storage_indices(trip: np.ndarray, dims) -> np.ndarray:
    """Centered (x, y, z) -> storage indices in [0, dim), ``(N, 3)``."""
    d = np.asarray(dims, np.int64)
    t = trip.astype(np.int64)
    return np.where(t < 0, t + d, t)


def stick_count(trip: np.ndarray, dims) -> int:
    """The number of distinct (x, y) sticks of ``trip``."""
    s = storage_indices(trip, dims)
    return int(np.unique(s[:, 0] * dims[1] + s[:, 1]).size)


def column_count(trip: np.ndarray, dims) -> int:
    """The number of distinct x columns that hold a stick."""
    return int(np.unique(storage_indices(trip, dims)[:, 0]).size)


def hermitian_pairs(trip: np.ndarray, dims):
    """Pairs of the set whose storage indices mirror each other, k and
    -k mod dims: ``(src, dst, selfs)``, each value ``dst[i]`` the
    conjugate of ``src[i]`` (``src < dst``), and ``selfs`` the values
    that are their own mirror (the origin and the Nyquist points), which
    a real field makes real."""
    s = storage_indices(trip, dims)
    d = np.asarray(dims, np.int64)
    m = (-s) % d
    key = (s[:, 0] * d[1] + s[:, 1]) * d[2] + s[:, 2]
    mkey = (m[:, 0] * d[1] + m[:, 1]) * d[2] + m[:, 2]
    order = np.argsort(key, kind="stable")
    pos = np.searchsorted(key[order], mkey)
    pos = np.minimum(pos, key.size - 1)
    found = key[order][pos] == mkey
    idx = np.arange(key.size)
    mirror = np.where(found, order[pos], -1)
    pair = found & (mirror > idx)
    return idx[pair], mirror[pair], idx[found & (mirror == idx)]


def draw_inputs(cfg: dict, trip: np.ndarray, seed: int, device):
    """The ``(bands, N, 2)`` values and the real ``(dim_z, dim_y, dim_x)``
    potential of a run, drawn from ``seed`` on ``device`` in the
    configuration's real type, in two calls of one generator: the same
    seed gives the same inputs, every seed the same sizes. An ``r2c``
    set is made hermitian-consistent (a real field's spectrum)."""
    dtype = REAL_DTYPES[cfg["precision"]]
    nb = cfg["bands"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    values = torch.randn((nb, trip.shape[0], 2), generator=gen, dtype=dtype,
                         device=device)
    nz, ny, nx = cfg["dims"][2], cfg["dims"][1], cfg["dims"][0]
    potential = torch.rand((nz, ny, nx), generator=gen, dtype=dtype,
                           device=device)
    if cfg["transform"] == "r2c":
        src, dst, selfs = (torch.as_tensor(a, device=device)
                           for a in hermitian_pairs(trip, cfg["dims"]))
        values[:, dst, 0] = values[:, src, 0]
        values[:, dst, 1] = -values[:, src, 1]
        values[:, selfs, 1] = 0
    return values, potential
