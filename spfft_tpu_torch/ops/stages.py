"""Placement, symmetry and xy stages of the sparse 3D FFT pipeline
(counterpart of ``spfft_tpu.ops.stages``, the parts the port's plans
run).

The local stick <-> plane transpose (reference:
src/transpose/transpose_host.hpp:94-154), written as row gathers through
plan-time inverse maps, and the R2C hermitian completion on planar
operands. In the JAX package these are XLA ops, not Pallas kernels;
plain tensor ops are their counterpart here.

The xy stages at the end run in the distributed plan's plane layout
``(planes, dim_y, x)`` (x the occupied window when split) on planar
pairs, through the kernel wrappers of :mod:`.dft_kernel`: the C2C stage
is one ``pdft2_swapped`` call; the split C2C stages and the R2C stages
run ``pdft_last`` and, for the real x axis, ``prdft_last`` /
``pirdft_last``. They take the plan's device matrices instead of
building them from the dimensions.
"""

from __future__ import annotations

import torch

from . import dft_kernel


def gather_rows_with_sentinel(rows: torch.Tensor, idx: torch.Tensor):
    """Gather the rows ``rows[..., idx, :]`` of ``(..., n, c)`` where
    index ``n`` (the sentinel of the plan-time inverse maps) selects a
    zero row; leading axes are a batch."""
    zero = rows.new_zeros(tuple(rows.shape[:-2]) + (1, rows.shape[-1]))
    return torch.cat([rows, zero], dim=-2)[..., idx, :]


def sticks_to_grid(sticks: torch.Tensor, col_inv: torch.Tensor,
                   dim_y: int, dim_x_freq: int):
    """Place z-transformed sticks ``(num_sticks, num_planes)`` into the
    plane grid ``(num_planes, dim_y, dim_x_freq)`` through the inverse
    column map (sentinel ``num_sticks`` -> zero row). The plan passes
    the transposed ``(w, dim_y)`` extents and gets the T layout. The
    result is contiguous, as the DFT kernels require."""
    num_planes = sticks.shape[1]
    grid_t = gather_rows_with_sentinel(sticks, col_inv)
    return grid_t.t().contiguous().reshape(num_planes, dim_y, dim_x_freq)


def sticks_to_grid_padded(sticks: torch.Tensor, col_inv: torch.Tensor,
                          dim_y: int, dim_x_freq: int):
    """:func:`sticks_to_grid` for stick arrays that already carry a
    trailing ZERO row at index ``num_sticks``: the sentinel selects it
    directly and the zero-row concatenation (a copy of the whole stick
    array) disappears. Sticks ``(B, num_sticks + 1, num_planes)`` give
    the batch of grids ``(B, num_planes, dim_y, dim_x_freq)``."""
    num_planes = sticks.shape[-1]
    return sticks[..., col_inv, :].transpose(-1, -2).contiguous().reshape(
        tuple(sticks.shape[:-2]) + (num_planes, dim_y, dim_x_freq))


def grid_to_sticks(grid: torch.Tensor, scatter_cols: torch.Tensor):
    """Gather sticks out of the plane grid ``(num_planes, a, b)``
    (reference forward pack, transpose_host.hpp:94-116). Returns
    ``(num_sticks, num_planes)``, contiguous; a batch of grids ``(B,
    num_planes, a, b)`` gives ``(B, num_sticks, num_planes)``."""
    flat = grid.flatten(-2)
    return flat[..., scatter_cols].transpose(-1, -2).contiguous()


# -- hermitian completion (R2C backward only; reference applies stick
# symmetry before the z-FFT and plane symmetry after it —
# execution_host.cpp:306-308, 340-342) --------------------------------------

def complete_stick_hermitian(re: torch.Tensor, im: torch.Tensor):
    """Complete planar sticks along the minor axis: an entry whose real
    and imaginary parts are both exactly 0 counts as missing and becomes
    the conjugate of its mirror ``v[(n - i) % n]``, read from the values
    before completion; given entries win. Slot 0 (and, for even n, slot
    n/2) mirrors itself. Returns new tensors (reference
    symmetry_host.hpp:69-91; ``spfft_tpu.ops.stages.
    complete_stick_hermitian`` on a planar pair)."""
    mr = torch.roll(re.flip(-1), 1, dims=-1)
    mi = torch.roll(im.flip(-1), 1, dims=-1)
    given = (re != 0) | (im != 0)
    return torch.where(given, re, mr), torch.where(given, im, -mi)


def complete_plane_hermitian_t(gr: torch.Tensor, gi: torch.Tensor) -> None:
    """Complete the x = 0 row of the transposed plane grid ``(..., planes,
    w, dim_y)`` along y, in place (:func:`complete_stick_hermitian` on
    ``[..., 0, :]``; ``spfft_tpu.ops.stages.complete_plane_hermitian_t``
    on a planar pair)."""
    gr[..., 0, :], gi[..., 0, :] = complete_stick_hermitian(gr[..., 0, :],
                                                            gi[..., 0, :])


def complete_plane_hermitian(gr: torch.Tensor, gi: torch.Tensor) -> None:
    """Complete the x = 0 column of the plane grid ``(..., planes, dim_y,
    x)`` along y, in place (:func:`complete_stick_hermitian` on ``[...,
    :, 0]``; ``spfft_tpu.ops.stages.complete_plane_hermitian`` on a
    planar pair)."""
    gr[..., :, 0], gi[..., :, 0] = complete_stick_hermitian(gr[..., :, 0],
                                                            gi[..., :, 0])


# -- xy stages in the plane layout (planes, dim_y, x) -------------------------

def _cdft_mid(xr: torch.Tensor, xi: torch.Tensor, mats):
    """Complex DFT along axis -2, ``(..., M, L) -> (..., M', L)`` against
    ``mats`` ``(M, M')``: swap to minor, one ``pdft_last``, swap back
    (two transposing copies, as in the JAX package)."""
    yr, yi = dft_kernel.pdft_last(xr.transpose(-1, -2).contiguous(),
                                  xi.transpose(-1, -2).contiguous(), mats)
    return (yr.transpose(-1, -2).contiguous(),
            yi.transpose(-1, -2).contiguous())


def xy_backward_c2c(gr: torch.Tensor, gi: torch.Tensor, mats_x, mats_y):
    """Backward xy stage ``(P, dim_y, xf) -> (P, dim_y, dim_x)``: the
    x-DFT (``mats_x`` ``(xf, dim_x)``) then the y-DFT, one
    ``pdft2_swapped`` call over all planes."""
    return dft_kernel.pdft2_swapped(gr, gi, mats_x, mats_y)


def xy_forward_c2c(xr: torch.Tensor, xi: torch.Tensor, mats_x, mats_y):
    """Forward xy stage ``(P, dim_y, dim_x) -> (P, dim_y, xf)``, one
    ``pdft2_swapped`` call."""
    return dft_kernel.pdft2_swapped(xr, xi, mats_x, mats_y)


def xy_backward_c2c_split(gr: torch.Tensor, gi: torch.Tensor, mats_y,
                          mats_x_rows):
    """Backward xy stage on the occupied x window (the reference's y
    transform over non-empty x rows only, execution_host.cpp:139-145):
    ``(P, dim_y, w)``, the y-DFT on the w columns, then the x-DFT from
    the window's rows of the DFT matrix (``mats_x_rows`` ``(w, dim_x)``,
    a wrapped window being a row selection) -> ``(P, dim_y, dim_x)``."""
    gr, gi = _cdft_mid(gr, gi, mats_y)
    return dft_kernel.pdft_last(gr, gi, mats_x_rows)


def xy_forward_c2c_split(xr: torch.Tensor, xi: torch.Tensor, mats_x_cols,
                         mats_y):
    """Forward mirror of :func:`xy_backward_c2c_split`: the x-DFT to the
    window's columns (``mats_x_cols`` ``(dim_x, w)``), then the y-DFT on
    them -> ``(P, dim_y, w)``."""
    gr, gi = dft_kernel.pdft_last(xr, xi, mats_x_cols)
    return _cdft_mid(gr, gi, mats_y)


def xy_backward_r2c(gr: torch.Tensor, gi: torch.Tensor, mats_y, mats_c2r):
    """R2C backward xy stage: the y-DFT, then the real inverse x-DFT
    (``mats_c2r`` ``(xf, dim_x)`` from ``dft.device_c2r``) -> real ``(P,
    dim_y, dim_x)``. With the window's rows (``device_c2r(rows=...)``)
    and a ``(P, dim_y, w)`` grid it is the split stage too (the JAX
    package's ``xy_backward_r2c_split``): the matrices carry the
    window."""
    gr, gi = _cdft_mid(gr, gi, mats_y)
    return dft_kernel.pirdft_last(gr, gi, mats_c2r)


def xy_forward_r2c(x: torch.Tensor, mats_r2c, mats_y):
    """R2C forward xy stage: the real x-DFT (``mats_r2c`` ``(dim_x,
    xf)`` from ``dft.device_r2c``, or the window's columns for the split
    stage, the JAX package's ``xy_forward_r2c_split``), then the y-DFT
    -> planar ``(P, dim_y, xf)``."""
    gr, gi = dft_kernel.prdft_last(x, mats_r2c)
    return _cdft_mid(gr, gi, mats_y)
