"""Placement and symmetry stages of the sparse 3D FFT pipeline
(counterpart of ``spfft_tpu.ops.stages``, the parts the local plan runs).

The local stick <-> plane transpose (reference:
src/transpose/transpose_host.hpp:94-154), written as row gathers through
plan-time inverse maps, and the R2C hermitian completion on planar
operands. In the JAX package these are XLA ops, not Pallas kernels;
plain tensor ops are their counterpart here.
"""

from __future__ import annotations

import torch


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
