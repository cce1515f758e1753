"""The bytes and operations a band pair needs, by stage, and the least
time the card could take for them.

Frozen from the arithmetic of ``chip_smoke.py`` (``fft_flops``,
``bound``), with the kernels' own tables left out: only each stage's
inputs and outputs count, each read or written once, so the bound reads
the same work whatever implements it. An FFT of length n costs
5 n log2 n operations a complex line and half that a real one.

Per pair (one backward plus one forward), in elements of the real type
(``e`` bytes), with N values in S sticks of length dim_z:

- z stage: each direction N values (complex) and S * dim_z stick
  elements (complex);
- xy stage: each direction the S * dim_z stick elements (complex) and
  the space slab, dim_x * dim_y * dim_z elements, complex for C2C and
  real for R2C; its operations are the y FFTs on the dim_z * C columns
  that hold sticks (C distinct x) and the x FFTs on dim_z * dim_y rows;
- the pair: the N values and the slab each direction.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
BYTES = {"single": 4, "double": 8}


def fft_flops(lines: int, n: int) -> float:
    """Real operations of ``lines`` complex FFTs of length ``n``."""
    return 5.0 * lines * n * math.log2(n) if n > 1 else 0.0


def pair_counts(transform: str, precision: str, dims, values: int,
                sticks: int, columns: int) -> dict:
    """``{stage: (bytes, flops)}`` of one pair, for the stages ``z``,
    ``xy`` and ``pair``."""
    nx, ny, nz = dims
    e = BYTES[precision]
    r2c = transform == "r2c"
    slab = nx * ny * nz * (1 if r2c else 2) * e
    stick_bytes = sticks * nz * 2 * e
    value_bytes = values * 2 * e
    z_flops = 2 * fft_flops(sticks, nz)
    x_flops = fft_flops(nz * ny, nx) / (2 if r2c else 1)
    xy_flops = 2 * (fft_flops(nz * columns, ny) + x_flops)
    return {"z": (2 * (value_bytes + stick_bytes), z_flops),
            "xy": (2 * (stick_bytes + slab), xy_flops),
            "pair": (2 * (value_bytes + slab), z_flops + xy_flops)}


def load_peaks(path: Path = PEAKS) -> dict:
    return json.loads(Path(path).read_text())


def bound_seconds(nbytes: float, flops: float, precision: str,
                  peaks: dict) -> float:
    """The least time of moving ``nbytes`` and doing ``flops``: the
    larger of the two over the card's published peaks."""
    return max(nbytes / peaks["memory_bytes_per_s"],
               flops / peaks["flop_per_s"][precision])
