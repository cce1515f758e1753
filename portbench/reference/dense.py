"""The plain reference of a band pair: backward, times V(r), forward
with FULL scaling, computed densely.

A band's values are scattered into the dense ``(dim_z, dim_y, dim_x)``
spectrum at the storage indices of its triplets (for R2C the conjugates
at the mirrored indices too, the hermitian completion), transformed with
``torch.fft`` (``ifftn`` unnormalised: the backward; ``fftn`` over
``dim_x * dim_y * dim_z``: the forward with FULL scaling), multiplied by
the potential in the space domain, and gathered back at the triplets.
The reference builds its own index map from the triplets and imports
nothing of the program under test.

The control (:func:`control_pair`) is the same pipeline one precision
below the configuration's: a float64 configuration in complex64, a
float32 one in TF32, whose DFTs are matrix products with every operand
rounded to TF32 (10 mantissa bits), as the tensor cores take them.
"""

from __future__ import annotations

import math

import torch

COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _scatter(values: torch.Tensor, idx: torch.Tensor, dims, r2c: bool,
             cdtype) -> torch.Tensor:
    """``(N, 2)`` values at storage ``idx`` ``(N, 3)`` (x, y, z) -> the
    dense ``(dim_z, dim_y, dim_x)`` spectrum of ``cdtype``."""
    nx, ny, nz = dims
    grid = torch.zeros((nz, ny, nx), dtype=cdtype, device=values.device)
    v = torch.complex(values[:, 0], values[:, 1]).to(cdtype)
    x, y, z = idx[:, 0], idx[:, 1], idx[:, 2]
    if r2c:  # the mirrors first: a value given at both ends wins as given
        grid[(-z) % nz, (-y) % ny, (-x) % nx] = v.conj()
    grid[z, y, x] = v
    return grid


def _gather(grid: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    g = grid[idx[:, 2], idx[:, 1], idx[:, 0]]
    return torch.stack((g.real, g.imag), dim=-1)


def reference_pair(values: torch.Tensor, potential: torch.Tensor,
                   idx: torch.Tensor, dims, r2c: bool) -> torch.Tensor:
    """The pair of one band in complex128: ``(N, 2)`` float64 values."""
    grid = _scatter(values, idx, dims, r2c, torch.complex128)
    space = torch.fft.ifftn(grid, norm="forward")
    del grid
    if r2c:
        space = space.real
    space = space * potential.to(torch.float64)
    freq = torch.fft.fftn(space, norm="forward")
    return _gather(freq, idx)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _dft_matrix(n: int, sign: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64, device=device)
    ang = sign * 2 * math.pi * torch.outer(k, k) / n
    return torch.complex(torch.cos(ang), torch.sin(ang)).to(torch.complex64)


def _tf32_dft_last(x: torch.Tensor, sign: int) -> torch.Tensor:
    """The DFT along the last axis of complex64 ``x`` as a matrix product
    of TF32 operands, accumulated in float32."""
    w = _dft_matrix(x.shape[-1], sign, x.device)
    xr, xi = _tf32(x.real), _tf32(x.imag)
    wr, wi = _tf32(w.real), _tf32(w.imag)
    return torch.complex(xr @ wr - xi @ wi, xr @ wi + xi @ wr)


def _tf32_dftn(x: torch.Tensor, sign: int) -> torch.Tensor:
    for axis in (2, 1, 0):
        x = _tf32_dft_last(x.movedim(axis, -1), sign).movedim(-1, axis)
    return x


def control_pair(values: torch.Tensor, potential: torch.Tensor,
                 idx: torch.Tensor, dims, r2c: bool) -> torch.Tensor:
    """The pair of one band one precision below ``values``' real type:
    ``(N, 2)`` values of that type."""
    if values.dtype == torch.float64:
        grid = _scatter(values, idx, dims, r2c, torch.complex64)
        space = torch.fft.ifftn(grid, norm="forward")
        if r2c:
            space = space.real
        space = space * potential.to(torch.float32)
        freq = torch.fft.fftn(space, norm="forward")
        return _gather(freq, idx).to(torch.float64)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the rounding is ours
    try:
        grid = _scatter(values, idx, dims, r2c, torch.complex64)
        space = _tf32_dftn(grid, +1)
        if r2c:
            space = torch.complex(space.real, torch.zeros_like(space.real))
        space = space * potential.to(torch.float32)
        freq = _tf32_dftn(space, -1) / float(dims[0] * dims[1] * dims[2])
        return _gather(freq, idx)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
