"""The slab <-> pencil exchange, block part: pack, all-to-all, unpack
(counterpart of ``spfft_tpu.parallel.exchange``, the padded
``(num_shards, max_sticks, max_planes)`` block layout of the reference's
BUFFERED MPI_Alltoall, transpose_mpi_buffered_host.cpp).

Pack and unpack are gathers through plan-time tables with the JAX
package's sentinels (an index one past the end selects zero). Every
function takes any leading axes, so the plan runs them on its stacked
shards, ``(B, S, ...)``, at once: the leading axes are a batch and the
shard axis, and :func:`all_to_all_blocks` swaps the two shard axes of
the stacked blocks, ``out[..., s, r] = in[..., r, s]`` — one transposing
copy on the device, what the collective moves between devices. The
compact, ring and float-wire exchanges are not in this slice.
"""

from __future__ import annotations

import torch

from ..ops import stages


def _take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` where an index ``x.shape[-1]`` (the sentinel; the
    axis is never empty) selects zero; the result has ``idx``'s shape as
    its trailing axes."""
    pad = idx >= x.shape[-1]
    return x[..., torch.where(pad, 0, idx)].masked_fill_(pad, 0)


def pack_freq_to_blocks(sticks: torch.Tensor, z_map: torch.Tensor):
    """Split z-transformed sticks into per-target-shard plane blocks
    (reference pack_backward,
    transpose_mpi_compact_buffered_host.cpp:109-125).

    ``sticks`` ``(..., max_sticks, dim_z)``; ``z_map`` ``(num_shards,
    max_planes)``, the global z of each target shard's p-th plane,
    sentinel ``dim_z`` for slab padding. Returns ``(..., num_shards,
    max_sticks, max_planes)`` (a transposed view)."""
    return _take_last(sticks, z_map).transpose(-3, -2)


def all_to_all_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """The exchange on the stacked layout: ``blocks`` ``(..., S_src,
    S_dst, max_sticks, max_planes)``; block (r -> s) lands at (s, slot
    r). Returns ``(..., S_dst, S_src, max_sticks, max_planes)``,
    contiguous."""
    return blocks.transpose(-4, -3).contiguous()


def unpack_blocks_to_grid(blocks: torch.Tensor, global_col_inv: torch.Tensor,
                          dim_y: int, dim_x_freq: int) -> torch.Tensor:
    """Place received stick segments into the local plane grid (reference
    unpack_backward, :128-175), as a row gather.

    ``blocks`` ``(..., num_shards, max_sticks, max_planes)``, ``blocks[...,
    s, :, :]`` shard s's sticks restricted to this shard's planes;
    ``global_col_inv`` ``(dim_y * dim_x_freq,)``, plane column -> global
    padded stick ``shard * max_sticks + i``, sentinel ``num_shards *
    max_sticks``. Returns ``(..., max_planes, dim_y, dim_x_freq)``,
    contiguous."""
    lead = tuple(blocks.shape[:-3])
    s, ms, mp = blocks.shape[-3:]
    rows = blocks.reshape(lead + (s * ms, mp))
    grid_t = stages.gather_rows_with_sentinel(rows, global_col_inv)
    return grid_t.transpose(-1, -2).contiguous().reshape(
        lead + (mp, dim_y, dim_x_freq))


def pack_space_to_blocks(grid: torch.Tensor, all_scatter_cols: torch.Tensor,
                         num_shards: int, max_sticks: int) -> torch.Tensor:
    """Forward pack: gather every shard's stick columns out of the local
    plane grid (reference pack_forward, :203-242).

    ``grid`` ``(..., max_planes, dim_y, dim_x_freq)``;
    ``all_scatter_cols`` ``(num_shards * max_sticks,)``, sentinel ``dim_y
    * dim_x_freq``. Returns ``(..., num_shards, max_sticks, max_planes)``
    (a permuted view)."""
    lead = tuple(grid.shape[:-3])
    mp = grid.shape[-3]
    cols = _take_last(grid.reshape(lead + (mp, -1)), all_scatter_cols)
    return cols.reshape(lead + (mp, num_shards, max_sticks)).movedim(-3, -1)


def unpack_blocks_to_sticks(blocks: torch.Tensor,
                            z_src: torch.Tensor) -> torch.Tensor:
    """Forward unpack: reassemble full-z sticks from the received
    per-source-shard plane blocks (reference unpack_forward, :245-266)
    through the total map ``z_src`` ``(dim_z,)``, global z -> ``owner *
    max_planes + p``. ``blocks`` ``(..., num_shards, max_sticks,
    max_planes)``; returns ``(..., max_sticks, dim_z)``, contiguous."""
    lead = tuple(blocks.shape[:-3])
    s, ms, mp = blocks.shape[-3:]
    flat = blocks.transpose(-3, -2).reshape(lead + (ms, s * mp))
    return flat[..., z_src]
