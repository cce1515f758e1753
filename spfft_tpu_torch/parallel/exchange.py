"""The slab <-> pencil exchange (counterpart of
``spfft_tpu.parallel.exchange``): pack, the collective, unpack.

The S shards live stacked on one device (:mod:`.mesh`), so a collective
is a copy on that device with the collective's semantics. Every
function takes any leading axes, so the plan runs them on its stacked
shards, ``(B, S, ...)``, at once: the leading axes are a batch and the
shard axis. Three mechanisms, as in the JAX package:

* the padded block layout ``(num_shards, max_sticks, max_planes)`` of the
  reference's BUFFERED MPI_Alltoall (transpose_mpi_buffered_host.cpp):
  pack and unpack are gathers through plan-time tables with the JAX
  package's sentinels (an index one past the end selects zero), and the
  exchange swaps the two shard axes of the stacked blocks, ``out[..., s,
  r] = in[..., r, s]`` — one transposing copy (:func:`all_to_all_blocks`)
  or, for ``UNBUFFERED``, S − 1 hop copies and the ring's reversal and
  roll (:func:`ring_exchange_blocks`);
* the exact-count schedules of ``COMPACT_BUFFERED`` (the reference's
  Alltoallv, transpose_mpi_compact_buffered_host.cpp:83-200): the
  one-collective ragged schedule (:class:`RaggedSchedule`,
  :func:`ragged_exchange`) and the exact-size op schedule
  (:class:`CompactSchedule`, :func:`compact_exchange`), with the JAX
  package's tables entry for entry; every table gather runs the gather
  kernel (``csrc/gather.cu``), one launch over all shards and the batch
  on the real and imaginary planes;
* the wire ladder around the collective: a cast of the planes to float32
  or bfloat16 and back (the reference's ``*_FLOAT`` exchanges), or the
  int8 rung, quantized per (slot, quant row) with a float32 absmax scale
  by ``csrc/wire.cu`` (:mod:`..ops.wire_kernel`) before the move and
  dequantized after it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..indexing import window_sub_cols
from ..ops import gather_kernel, stages, wire_kernel


def dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` with the strides of a fresh tensor of its shape: a view of
    the same memory where ``t`` is contiguous, a copy where it is not.
    ``.contiguous()`` alone keeps a view whose size-1 axis has another
    stride (a shard's slice of a batch of one), and the CPU's plain
    matrix products round such a view differently from a fresh tensor;
    the kernels read from the data pointer and see no difference, and
    no copy is added for them."""
    want, acc = [], 1
    for n in reversed(t.shape):
        want.append(acc)
        acc *= n
    want = tuple(reversed(want))
    if want == t.stride():
        return t
    if t.is_contiguous():
        return t.as_strided(t.shape, want)
    return t.clone(memory_format=torch.contiguous_format)


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


def all_to_all_blocks(blocks: torch.Tensor, tail: int = 2) -> torch.Tensor:
    """The exchange on the stacked layout: ``blocks`` ``(..., S_src,
    S_dst, *tail)`` (``tail`` trailing axes: a block's two, or one for the
    int8 wire's scales); block (r -> s) lands at (s, slot r). Returns
    ``(..., S_dst, S_src, *tail)``, contiguous."""
    return dense(blocks.transpose(-tail - 2, -tail - 1))


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
    return dense(grid_t.transpose(-1, -2)).reshape(
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


@dataclasses.dataclass(frozen=True)
class CompactSchedule:
    """Plan-time schedule for the exact-count (ragged) exchange — the
    Alltoallv analogue (reference:
    src/transpose/transpose_mpi_compact_buffered_host.cpp:83-105 computes
    per-rank counts/displacements at plan time; :183-200 runs the
    MPI_Alltoallv).

    Collectives are fixed-shape, so "ragged" becomes a static schedule
    of exact-size ``ppermute`` ops: the (stick-owner ``j`` -> plane-owner
    ``d``) pairs of each hop distance ``k = (d - j) % S`` are grouped into
    *size classes* (exact element count ``ns(j) * np(d)``, a plan-time
    constant; BUCKET_FACTOR=1.25 buckets when a hop has more than
    MAX_EXACT_CLASSES distinct sizes),
    and each (hop, class) becomes one ppermute carrying ONLY its member
    pairs — a ppermute transfers nothing along pairs absent from its
    permutation, so a pair never pays for a bigger pair in the same hop.
    Total off-shard wire elements per shard therefore track the true
    per-pair counts (the padded layout ships
    ``(S-1) * max_sticks * max_planes`` regardless — the padding waste
    SURVEY.md §7.3 flags as the scaling risk); with a skewed PLANE
    distribution, a plain per-hop-max schedule would pad every hop to the
    big destination's size and save nothing. The same ops serve both
    directions (the pairs flow reversed).

    Pack/unpack are element gathers through plan-time index tables with
    out-of-range sentinels (an index at or past the end reads 0).
    Layout of an op's flat buffer, sent by shard ``j`` to ``d``
    (backward; forward reverses): element ``i * np(d) + p`` is stick ``i``,
    plane ``p`` of shard ``d``'s slab.
    """

    num_shards: int
    ops: tuple                       # (k, L, pairs) — hop distance, buffer
                                     # elements, tuple of (src, dst) pairs
                                     # carried (backward direction)
    bwd_pack: tuple                  # per-op (S, L) into flat sticks
    bwd_unpack: np.ndarray           # (S, mp*Y*Xf) into concat recv buffer
    fwd_pack: tuple                  # per-op (S, L) into flat grid
    fwd_unpack: np.ndarray           # (S, ms*dz) into concat recv buffer

    @property
    def hop_sizes(self) -> tuple:
        """Buffer elements per op (kept name: op count == len(hop_sizes))."""
        return tuple(L for _, L, _ in self.ops)

    @property
    def total_recv(self) -> int:
        return int(sum(self.hop_sizes))

    def _send_recv_per_shard(self):
        send = np.zeros(self.num_shards, np.int64)
        recv = np.zeros(self.num_shards, np.int64)
        for k, L, pairs in self.ops:
            if k == 0:
                continue
            for j, d in pairs:
                send[j] += L
                recv[d] += L
        return send, recv

    def wire_elements(self) -> int:
        """TOTAL off-shard complex elements per exchange, summed over all
        shards (hop 0 is local). The aggregate-traffic metric; compare
        with the padded layout's ``S * (S-1) * max_sticks * max_planes``.

        Counts what the ppermute ops actually ship: each pair is charged
        its op's full buffer size L — exact when the hop has <=
        MAX_EXACT_CLASSES distinct sizes, and under BUCKET_FACTOR (1.25x)
        of exact otherwise (tests/test_compact_exchange.py asserts the
        bound on random skews)."""
        send, _ = self._send_recv_per_shard()
        return int(send.sum())

    def busiest_link_elements(self) -> int:
        """Max over shards of max(sent, received) off-shard complex
        elements per exchange — the bottleneck-link metric. On a skewed
        PLANE distribution the big plane-owner's ingress is real payload
        (a true Alltoallv ships the same bytes), so this metric does NOT
        shrink the way the aggregate does; capacity planning should read
        this one. Bucketed ops are counted at bucket size, as in
        :meth:`wire_elements` (same <= 1.25x-of-exact bound)."""
        send, recv = self._send_recv_per_shard()
        both = np.maximum(send, recv)
        return int(both.max()) if self.num_shards else 0


#: Bucket growth factor when a hop has more distinct payload sizes than
#: MAX_EXACT_CLASSES: a pair is charged at most this multiple of its
#: exact payload (asserted against random skews in
#: tests/test_compact_exchange.py).
BUCKET_FACTOR = 1.25
MAX_EXACT_CLASSES = 8


def _bucket_ladder(max_size: int) -> list:
    """Ascending bucket sizes 1, ..., <= max_size with ratio <=
    BUCKET_FACTOR between consecutive entries (each step also advances by
    >= 1 so the ladder terminates)."""
    ladder = [1]
    while ladder[-1] < max_size:
        ladder.append(min(max_size,
                          max(ladder[-1] + 1,
                              int(ladder[-1] * BUCKET_FACTOR))))
    return ladder


def _size_classes(sizes_by_src: dict, max_exact: int = MAX_EXACT_CLASSES
                  ) -> list:
    """Group a hop's pairs by exact payload size; if more than ``max_exact``
    distinct sizes, merge into BUCKET_FACTOR-spaced buckets clamped to the
    hop's max exact size — every pair is charged < BUCKET_FACTOR times its
    exact payload (and never more than the per-hop max, so the compact
    layout never exceeds the padded one; op count <= log_1.25 of the hop's
    size range). Returns [(L, [srcs])] sorted by L."""
    groups: dict = {}
    for j, e in sizes_by_src.items():
        groups.setdefault(int(e), []).append(j)
    if len(groups) > max_exact:
        ladder = _bucket_ladder(max(groups))
        buckets: dict = {}
        for e, js in groups.items():
            b = next(v for v in ladder if v >= e)
            buckets.setdefault(b, []).extend(js)
        groups = buckets
    return sorted((L, sorted(js)) for L, js in groups.items())


def build_compact_schedule(dp, x_window=None) -> CompactSchedule:
    """Build the exact-count exchange schedule from a
    ``DistributedIndexPlan`` (duck-typed to avoid a circular import).

    ``x_window=(x0, w)`` composes the schedule with the split-x grid: the
    unpack/pack grid tables then index the occupied-x window (width ``w``)
    instead of the full plane (see dist._init_split_x).
    """
    S = dp.num_shards
    ms, mp_ = dp.max_sticks, dp.max_planes
    dz, Y, Xf = dp.dim_z, dp.dim_y, dp.dim_x_freq
    Xe = Xf if x_window is None else x_window[1]

    def grid_cols(cols):
        if x_window is None:
            return np.asarray(cols, np.int64)
        return window_sub_cols(cols, Xf, *x_window).astype(np.int64)
    ns = [p.num_sticks for p in dp.shard_plans]
    npl = list(dp.num_planes)
    off = list(dp.plane_offsets)

    ops = []  # (k, L, pairs)
    for k in range(S):
        sizes = {j: ns[j] * npl[(j + k) % S] for j in range(S)
                 if ns[j] * npl[(j + k) % S] > 0}
        for L, js in _size_classes(sizes):
            ops.append((k, int(L), tuple((j, (j + k) % S) for j in js)))
    if not ops:  # degenerate: no sticks anywhere — keep one dummy slot
        ops = [(0, 1, ())]
    L = [o[1] for o in ops]
    offs = np.concatenate([[0], np.cumsum(L)]).astype(np.int64)
    total = int(offs[-1])
    # recv-buffer offset of each pair's op
    op_of_pair = {}
    for oi, (k, _, pairs) in enumerate(ops):
        for pr in pairs:
            op_of_pair[pr] = oi

    bwd_pack = []
    for oi, (k, Lo, pairs) in enumerate(ops):
        tbl = np.full((S, Lo), ms * dz, np.int32)  # sentinel: off-range
        for j, d in pairs:
            n = ns[j] * npl[d]
            i = np.arange(ns[j])[:, None]
            z = off[d] + np.arange(npl[d])[None, :]
            tbl[j, :n] = (i * dz + z).reshape(-1)
        bwd_pack.append(tbl)

    # backward unpack: grid flat index p*Y*Xe + col -> recv position
    bwd_unpack = np.full((S, mp_ * Y * Xe), total, np.int32)
    for r in range(S):
        if npl[r] == 0:
            continue
        for s in range(S):
            if ns[s] == 0:
                continue
            cols = grid_cols(dp.shard_plans[s].scatter_cols)
            i = np.arange(ns[s])[:, None]
            p = np.arange(npl[r])[None, :]
            pos = offs[op_of_pair[(s, r)]] + i * npl[r] + p
            flat_idx = p * (Y * Xe) + cols[:, None]
            bwd_unpack[r][flat_idx.reshape(-1)] = pos.reshape(-1)

    # forward pack: for backward pair (d, j) the forward sender is j,
    # receiver d, payload = (ns(d), np(j)) gathered from j's local grid
    fwd_pack = []
    for oi, (k, Lo, pairs) in enumerate(ops):
        tbl = np.full((S, Lo), mp_ * Y * Xe, np.int32)
        for d, j in pairs:  # backward (src=d, dst=j): forward j sends to d
            n = ns[d] * npl[j]
            cols = grid_cols(dp.shard_plans[d].scatter_cols)
            p = np.arange(npl[j])[None, :]
            tbl[j, :n] = (p * (Y * Xe) + cols[:, None]).reshape(-1)
        fwd_pack.append(tbl)

    # forward unpack: stick flat index i*dz + z -> recv position
    fwd_unpack = np.full((S, ms * dz), total, np.int32)
    z_owner = np.empty(dz, np.int64)
    z_plane = np.empty(dz, np.int64)
    for s in range(S):
        z_owner[off[s]:off[s] + npl[s]] = s
        z_plane[off[s]:off[s] + npl[s]] = np.arange(npl[s])
    for r in range(S):
        if ns[r] == 0:
            continue
        # stick-owner r receives from plane-owner o = z_owner[z]; that is
        # backward pair (r, o)
        base = np.asarray([offs[op_of_pair[(r, int(o))]] for o in z_owner],
                          np.int64) + z_plane
        npl_z = np.asarray(npl)[z_owner]      # (dz,)
        i = np.arange(ns[r])[:, None]
        idx = base[None, :] + i * npl_z[None, :]
        fwd_unpack[r, :ns[r] * dz] = idx.reshape(-1)

    return CompactSchedule(num_shards=S, ops=tuple(ops),
                           bwd_pack=tuple(bwd_pack),
                           bwd_unpack=bwd_unpack, fwd_pack=tuple(fwd_pack),
                           fwd_unpack=fwd_unpack)


@dataclasses.dataclass(frozen=True)
class RaggedSchedule:
    """Plan-time tables for the ONE-COLLECTIVE exact-count exchange — the
    true Alltoallv (reference MPI_Alltoallv,
    transpose_mpi_compact_buffered_host.cpp:183-200), built in the JAX
    package on a ragged all-to-all: per-pair element counts ride offset
    vectors into one fixed-capacity buffer, so the launch count is 1 per
    direction at any shard count and the wire carries exactly the
    per-pair counts (no 1.25x bucket factor).

    Backward direction: stick-owner ``j`` sends ``ns(j) * np(d)``
    elements to plane-owner ``d``; forward reverses (counts transpose).
    Send buffers are laid out destination-major, receive buffers
    source-major, both with static capacity = the max total over shards
    (the ragged op needs one static shape; the capacity slack stays in
    HBM and off the wire — unlike the padded layout, which ships it).

    On one card the S shards' send buffers are stacked, which is what
    the emulation's ``all_gather`` makes, so the collective is the
    emulation gather ``emu_*``: every receive slot indexes the
    concatenated sends (sentinel ``S * send_cap`` reads 0). The pack,
    emulation and unpack tables are the JAX package's, entry for entry.
    """

    num_shards: int
    send_cap: int                 # static send-buffer elements per shard
    recv_cap: int                 # static recv-buffer elements per shard
    # per-direction offset vectors, each (S, S) int32, row = this shard:
    bwd_offsets: tuple            # (input_offsets, send_sizes,
                                  #  output_offsets, recv_sizes)
    fwd_offsets: tuple
    bwd_pack: np.ndarray          # (S, send_cap) into flat local sticks
    bwd_unpack: np.ndarray        # (S, mp*Y*Xe) into the recv buffer
    fwd_pack: np.ndarray          # (S, send_cap) into the flat local grid
    fwd_unpack: np.ndarray        # (S, ms*dz) into the recv buffer
    emu_bwd: np.ndarray           # (S, recv_cap) into allgathered sends
    emu_fwd: np.ndarray           # (S, recv_cap)

    def _counts(self):
        """Backward per-pair element counts n[j, d] (forward is n.T)."""
        io, ss, oo, rs = self.bwd_offsets
        return ss

    def wire_elements(self) -> int:
        """TOTAL off-shard complex elements per exchange (exact — the
        ragged op ships per-pair counts with no padding or buckets)."""
        n = np.asarray(self._counts(), np.int64)
        return int(n.sum() - np.trace(n))

    def busiest_link_elements(self) -> int:
        """Max over shards of max(sent, received) off-shard elements."""
        n = np.asarray(self._counts(), np.int64).copy()
        np.fill_diagonal(n, 0)
        send = n.sum(axis=1)
        recv = n.sum(axis=0)
        both = np.maximum(send, recv)
        return int(both.max()) if self.num_shards else 0

    def device_tables(self) -> list:
        """The (S, ...) tables the SPMD bodies consume, in a fixed order
        (see dist.TransformPlan's ctables plumbing)."""
        io_b, ss_b, oo_b, rs_b = self.bwd_offsets
        io_f, ss_f, oo_f, rs_f = self.fwd_offsets
        return [self.bwd_pack, self.bwd_unpack, self.fwd_pack,
                self.fwd_unpack, io_b, ss_b, oo_b, rs_b,
                io_f, ss_f, oo_f, rs_f, self.emu_bwd, self.emu_fwd]


def _ragged_direction_tables(S: int, counts: np.ndarray):
    """Offset vectors + emulation table layout for one direction.
    ``counts[j, d]`` = elements shard j sends shard d. Returns
    ((input_offsets, send_sizes, output_offsets, recv_sizes), send_cap,
    recv_cap, recv_offsets)."""
    counts = np.asarray(counts, np.int64)
    input_offsets = np.concatenate(
        [np.zeros((S, 1), np.int64), np.cumsum(counts, axis=1)[:, :-1]],
        axis=1)
    recv_counts = counts.T                      # row d: from each j
    recv_offsets = np.concatenate(
        [np.zeros((S, 1), np.int64), np.cumsum(recv_counts, axis=1)[:, :-1]],
        axis=1)
    # sender j's chunk lands at receiver d's recv_offsets[d, j]
    output_offsets = recv_offsets.T
    send_cap = int(counts.sum(axis=1).max()) if S else 1
    recv_cap = int(recv_counts.sum(axis=1).max()) if S else 1
    offs = tuple(a.astype(np.int32) for a in
                 (input_offsets, counts, output_offsets, recv_counts))
    return offs, max(send_cap, 1), max(recv_cap, 1), recv_offsets


def build_ragged_schedule(dp, x_window=None) -> RaggedSchedule:
    """Build the one-collective exact-count schedule from a
    ``DistributedIndexPlan`` (same duck-typed contract and x-window
    composition as :func:`build_compact_schedule`)."""
    S = dp.num_shards
    ms, mp_ = dp.max_sticks, dp.max_planes
    dz, Y, Xf = dp.dim_z, dp.dim_y, dp.dim_x_freq
    Xe = Xf if x_window is None else x_window[1]

    def grid_cols(cols):
        if x_window is None:
            return np.asarray(cols, np.int64)
        return window_sub_cols(cols, Xf, *x_window).astype(np.int64)

    ns = [p.num_sticks for p in dp.shard_plans]
    npl = list(dp.num_planes)
    off = list(dp.plane_offsets)
    n_bwd = np.asarray([[ns[j] * npl[d] for d in range(S)]
                        for j in range(S)], np.int64)
    bwd_offs, s_cap_b, r_cap_b, roff_b = _ragged_direction_tables(S, n_bwd)
    fwd_offs, s_cap_f, r_cap_f, roff_f = _ragged_direction_tables(S, n_bwd.T)
    send_cap = max(s_cap_b, s_cap_f)
    recv_cap = max(r_cap_b, r_cap_f)
    io_b = bwd_offs[0].astype(np.int64)
    io_f = fwd_offs[0].astype(np.int64)

    bwd_pack = np.full((S, send_cap), ms * dz, np.int32)
    emu_bwd = np.full((S, recv_cap), S * send_cap, np.int32)
    fwd_pack = np.full((S, send_cap), mp_ * Y * Xe, np.int32)
    emu_fwd = np.full((S, recv_cap), S * send_cap, np.int32)
    bwd_unpack = np.full((S, mp_ * Y * Xe), recv_cap, np.int32)
    fwd_unpack = np.full((S, ms * dz), recv_cap, np.int32)

    for j in range(S):
        for d in range(S):
            n = ns[j] * npl[d]
            if n:
                # backward send j -> d: stick-major block (ns[j], npl[d])
                i = np.arange(ns[j])[:, None]
                z = off[d] + np.arange(npl[d])[None, :]
                bwd_pack[j, io_b[j, d]:io_b[j, d] + n] = \
                    (i * dz + z).reshape(-1)
                emu_bwd[d, roff_b[d, j]:roff_b[d, j] + n] = \
                    j * send_cap + io_b[j, d] + np.arange(n)
            m = ns[d] * npl[j]
            if m:
                # forward send j -> d: d's sticks restricted to j's planes
                cols = grid_cols(dp.shard_plans[d].scatter_cols)
                p = np.arange(npl[j])[None, :]
                fwd_pack[j, io_f[j, d]:io_f[j, d] + m] = \
                    (p * (Y * Xe) + cols[:, None]).reshape(-1)
                emu_fwd[d, roff_f[d, j]:roff_f[d, j] + m] = \
                    j * send_cap + io_f[j, d] + np.arange(m)

    for d in range(S):
        if npl[d]:
            for j in range(S):
                if ns[j]:
                    cols = grid_cols(dp.shard_plans[j].scatter_cols)
                    i = np.arange(ns[j])[:, None]
                    p = np.arange(npl[d])[None, :]
                    pos = roff_b[d, j] + i * npl[d] + p
                    flat_idx = p * (Y * Xe) + cols[:, None]
                    bwd_unpack[d][flat_idx.reshape(-1)] = pos.reshape(-1)
        if ns[d]:
            for j in range(S):
                if npl[j]:
                    i = np.arange(ns[d])[:, None]
                    p = np.arange(npl[j])[None, :]
                    pos = roff_f[d, j] + i * npl[j] + p
                    flat_idx = i * dz + (off[j] + p)
                    fwd_unpack[d][flat_idx.reshape(-1)] = pos.reshape(-1)

    return RaggedSchedule(
        num_shards=S, send_cap=send_cap, recv_cap=recv_cap,
        bwd_offsets=bwd_offs, fwd_offsets=fwd_offs, bwd_pack=bwd_pack,
        bwd_unpack=bwd_unpack, fwd_pack=fwd_pack, fwd_unpack=fwd_unpack,
        emu_bwd=emu_bwd, emu_fwd=emu_fwd)


# -- the moves on one device --------------------------------------------------

def ring_exchange_blocks(t: torch.Tensor, tail: int = 2) -> torch.Tensor:
    """The exchange of :func:`all_to_all_blocks` as the JAX package's ring
    (``ring_exchange_blocks``): hop k moves, for every shard r at once,
    the block that source ``(r - k) % S`` addressed to r into
    ``received[k]`` (k = 0 the local block, k = 1 .. S - 1 the S − 1
    hops, one copy each); then ``out[r, s] = received[(r - s) % S, r]``,
    the ring's reversal and roll, in one more copy. ``t`` is ``(...,
    S_src, S_dst, *tail)``; the result is ``(..., S_dst, S_src,
    *tail)``, contiguous, equal to :func:`all_to_all_blocks`'s."""
    s = t.shape[-tail - 1]
    ar = torch.arange(s, device=t.device)
    rest = (slice(None),) * tail
    received = t.new_empty(t.shape[:-tail - 2] + (s, s) + t.shape[-tail:])
    for k in range(s):
        received[(Ellipsis, k, slice(None)) + rest] = \
            t[(Ellipsis, (ar - k) % s, ar) + rest]
    hop = (ar[:, None] - ar[None, :]) % s
    return received[(Ellipsis, hop, ar[:, None].expand(s, s)) + rest]


def move_blocks(planes: tuple, wire, quant_axis: int, real_dtype,
                ring: bool = False) -> tuple:
    """Exchange the stacked block pair ``(re, im)``, each ``(...,
    S_src, S_dst, max_sticks, max_planes)`` -> ``(..., S_dst, S_src,
    max_sticks, max_planes)``, contiguous, of ``real_dtype``: by the
    transposing copy, or by the ring (``ring``), on the wire ``wire``:
    None (the plan's precision), ``torch.float32`` / ``torch.bfloat16``
    (the planes cast down before the move and back after it) or
    ``torch.int8`` (:func:`wire_kernel.quantize` per (slot, row of
    ``quant_axis``: 1 sticks, 2 planes), the payload and the scales
    moved, :func:`wire_kernel.dequantize` after)."""
    move = ring_exchange_blocks if ring else all_to_all_blocks
    if wire is None:
        return tuple(move(t, 2) for t in planes)
    if wire == torch.int8:
        lead = tuple(planes[0].shape[:-3])  # the batch and S_src
        g = tuple(t.reshape((-1,) + tuple(t.shape[-3:])) for t in planes)
        q_re, q_im, scales = wire_kernel.quantize(g, quant_axis)
        q_re, q_im = (move(q.view(lead + tuple(q.shape[1:])), 2)
                      for q in (q_re, q_im))
        scales = move(scales.view(lead + tuple(scales.shape[1:])), 1)
        out = wire_kernel.dequantize(
            tuple(q.view((-1,) + tuple(q.shape[-3:])) for q in (q_re, q_im)),
            scales.view((-1,) + tuple(scales.shape[-2:])), quant_axis,
            real_dtype)
        # (batch x S_dst, S_src, ...) -> (batch, S_dst, S_src, ...)
        return tuple(o.view(lead + tuple(o.shape[1:])) for o in out)
    return tuple(move(t.to(wire), 2).to(real_dtype) for t in planes)


def gather_planes(src: tuple, idx: torch.Tensor) -> tuple:
    """One launch of the gather kernel on a planar pair: ``src`` ``(re,
    im)``, each ``(B, S, n)`` (any strides), and the stacked table ``idx``
    int32 ``(S, m)`` -> ``(re, im)``, each ``(B, S, m)`` contiguous, with
    ``out[b, s, j] = src[b, s, idx[s, j]]`` and 0 where the index is at or
    past ``n`` (every table's sentinel)."""
    b, s = src[0].shape[:2]
    out = tuple(torch.empty((b, s, idx.shape[1]), dtype=src[0].dtype,
                            device=src[0].device) for _ in range(2))
    gather_kernel.gather(tuple(t.transpose(0, 1) for t in src), idx,
                         tuple(t.transpose(0, 1) for t in out))
    return out


def wire_round(planes: tuple, wire, real_dtype) -> tuple:
    """The float rungs' rounding of a planar pair: cast to ``wire`` and
    back to ``real_dtype`` (the pair itself where ``wire`` is None)."""
    if wire is None:
        return planes
    return tuple(t.to(wire).to(real_dtype) for t in planes)


def ragged_exchange(send: tuple, emu_table: torch.Tensor, wire,
                    real_dtype) -> tuple:
    """One direction of the exact-count exchange on one device: the
    stacked send buffers ``(re, im)``, each ``(B, S, send_cap)``, after
    the wire's rounding (:func:`wire_round`; the JAX package casts the
    whole send buffer), are what the emulation's ``all_gather`` makes; the
    plan-time table ``emu_table`` ``(S, recv_cap)`` gathers each
    receiver's slots from them (every shard reads the same concatenated
    sends, a shard stride of 0). Returns the receive buffers ``(B, S,
    recv_cap)``."""
    send = wire_round(send, wire, real_dtype)
    b, s, cap = send[0].shape
    every = tuple(t.reshape(b, 1, s * cap).expand(b, s, s * cap)
                  for t in send)
    return gather_planes(every, emu_table)


def compact_exchange(bufs: list, perms: list, wire, real_dtype) -> tuple:
    """The exact-size op schedule on one device: ``bufs`` one ``(re, im)``
    pair ``(B, S, L)`` per op, ``perms`` per op None (a hop-0 op, or one
    without pairs: the shard's own buffer, never on the wire) or its
    ``(src, dst)`` shard index tensors in the direction of the move.
    Each op's move copies shard ``src[i]``'s buffer to shard ``dst[i]``
    — only along its pairs: the other shards receive zeros, which the
    unpack tables never read — on the wire ``wire`` (cast down before the
    move, back after). Returns the op buffers concatenated in schedule
    order, ``(B, S, sum L)`` each, the layout the unpack tables index."""
    out = []
    for pair, perm in zip(bufs, perms):
        if perm is None:
            out.append(pair)
            continue
        src, dst = perm
        moved = []
        for t in pair:
            w = t if wire is None else t.to(wire)
            o = torch.zeros_like(w)
            o[:, dst] = w[:, src]
            moved.append(o if wire is None else o.to(real_dtype))
        out.append(tuple(moved))
    if len(out) == 1:
        return out[0]
    return tuple(torch.cat([o[i] for o in out], dim=-1) for i in range(2))


# -- the moves over the ranks of a process group ------------------------------
#
# Over a ``torch.distributed`` group of P ranks (:mod:`.mesh`), rank r holds
# the L = S / P shards ``[r * L, (r + 1) * L)`` and each move above becomes
# a collective of the group with the same result on the rank's own shards:
# the padded blocks one ``all_to_all_single`` (or, for the ring, P - 1 hops
# of ``batch_isend_irecv``), the ragged schedule one ``all_to_all_single``
# with the schedule's exact per-rank counts as split sizes, the op schedule
# each op a ``batch_isend_irecv`` of its pairs. The payload moves in the
# wire's dtype. Every move is issued asynchronously and returns a
# :class:`Pending` whose :meth:`~Pending.wait` waits for it (on NCCL the
# plan's stream then waits for the collective's) and assembles the result.

#: the primitive each exchange kind runs over ranks
RANK_PRIMITIVES = {"all_to_all": "all_to_all_single",
                   "all_to_all_v": "all_to_all_single",
                   "p2p_ring": "batch_isend_irecv",
                   "p2p_ops": "batch_isend_irecv"}


@dataclasses.dataclass(frozen=True)
class RankComm:
    """This rank's view of a plan's process group: the group, its size P,
    this rank and the L shards each rank holds."""

    group: object
    size: int
    rank: int
    local: int

    def peer(self, r: int) -> int:
        """The global rank of the group's rank ``r`` (what ``P2POp``
        takes)."""
        import torch.distributed as dist
        return dist.get_global_rank(self.group, r) \
            if self.group is not None else r


class Pending:
    """A move in flight: ``works`` (collective handles) and ``finish``,
    the function that assembles the result once they are done."""

    def __init__(self, works: list, finish):
        self._works = works
        self._finish = finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


def _rank_major(t: torch.Tensor, tail: int, size: int) -> torch.Tensor:
    """``(..., L_src, S_dst, *tail)`` as ``(P, ..., L_src, S_dst / P,
    *tail)``: the blocks for each destination rank first (a view)."""
    nl = t.dim() - tail - 2
    s = t.shape[nl + 1]
    v = t.reshape(tuple(t.shape[:nl + 1]) + (size, s // size)
                  + tuple(t.shape[nl + 2:]))
    return v.movedim(nl + 1, 0)


def _blocks_send(tensors: tuple, tail: int, comm: RankComm, wire):
    """The send buffer of a block move: the tensors (one dtype after the
    cast to ``wire`` where it is not None) rank-major and stacked, ``(P,
    n, ..., L_src, L_dst, *tail)``, contiguous."""
    return torch.stack([_rank_major(t if wire is None else t.to(wire), tail,
                                    comm.size) for t in tensors], dim=1)


def _blocks_finish(recv: torch.Tensor, n: int, tail: int, real_dtype):
    """The received ``(P_src, n, ..., L_src, L_dst, *tail)`` buffer as n
    tensors ``(..., L_dst, S_src, *tail)``, contiguous, of ``real_dtype``
    where it is not None."""
    out = []
    for i in range(n):
        r = recv[:, i]
        nl = r.dim() - tail - 3
        lead, lsrc, ldst = (tuple(r.shape[1:nl + 1]), r.shape[nl + 1],
                            r.shape[nl + 2])
        tl = tuple(r.shape[nl + 3:])
        r = r.movedim(0, nl).movedim(nl + 2, nl)  # (lead, Ld, P, Ls, tail)
        r = r.reshape(lead + (ldst, r.shape[nl + 1] * lsrc) + tl)
        out.append(dense(r if real_dtype is None else r.to(real_dtype)))
    return out


def rank_move_tensors(tensors: tuple, tail: int, comm: RankComm,
                      wire=None, real_dtype=None, ring: bool = False
                      ) -> Pending:
    """The block exchange of :func:`all_to_all_blocks` over ranks: each
    tensor ``(..., L_src, S_dst, *tail)`` on this rank -> ``(..., L_dst,
    S_src, *tail)``, contiguous; the tensors (one dtype) move together,
    cast to ``wire`` before the move and to ``real_dtype`` after it
    where those are not None. One ``all_to_all_single``, or with ``ring``
    the P - 1 hops of ``batch_isend_irecv`` (hop k: to rank ``r + k``,
    from ``r - k``) and the local block copied."""
    import torch.distributed as dist
    send = _blocks_send(tensors, tail, comm, wire)
    recv = torch.empty_like(send)
    works = []
    if not ring:
        works.append(dist.all_to_all_single(recv, send, group=comm.group,
                                            async_op=True))
    else:
        recv[comm.rank] = send[comm.rank]
        for k in range(1, comm.size):
            dst, src = (comm.rank + k) % comm.size, (comm.rank - k) % comm.size
            works += dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send[dst], comm.peer(dst),
                           comm.group),
                dist.P2POp(dist.irecv, recv[src], comm.peer(src),
                           comm.group)])
    n = len(tensors)
    return Pending(works, lambda: _blocks_finish(recv, n, tail, real_dtype))


def rank_move_blocks(planes: tuple, wire, quant_axis: int, real_dtype,
                     comm: RankComm, ring: bool = False) -> Pending:
    """:func:`move_blocks` over ranks: the block pair ``(re, im)``, each
    ``(..., L_src, S_dst, max_sticks, max_planes)``, -> ``(..., L_dst,
    S_src, max_sticks, max_planes)`` of ``real_dtype``, on the wire
    ``wire``; the int8 rung quantizes this rank's blocks, moves the
    payload pair and the scales (two collectives) and dequantizes the
    received ones."""
    if wire != torch.int8:
        return rank_move_tensors(planes, 2, comm, wire, real_dtype, ring)
    lead = tuple(planes[0].shape[:-3])  # the batch and L_src
    g = tuple(t.reshape((-1,) + tuple(t.shape[-3:])) for t in planes)
    q_re, q_im, scales = wire_kernel.quantize(g, quant_axis)
    q = rank_move_tensors(tuple(x.view(lead + tuple(x.shape[1:]))
                                for x in (q_re, q_im)), 2, comm, ring=ring)
    sc = rank_move_tensors((scales.view(lead + tuple(scales.shape[1:])),),
                           1, comm, ring=ring)

    def finish():
        (q_re, q_im), (scales,) = q.wait(), sc.wait()
        out = wire_kernel.dequantize(
            tuple(x.view((-1,) + tuple(x.shape[-3:])) for x in (q_re, q_im)),
            scales.view((-1,) + tuple(scales.shape[-2:])), quant_axis,
            real_dtype)
        return tuple(o.view(tuple(q_re.shape[:-3]) + tuple(o.shape[1:]))
                     for o in out)

    return Pending([], finish)


@dataclasses.dataclass(frozen=True)
class RankRagged:
    """One direction of a ragged schedule (or of one of its chunks) on
    this rank: the JAX package's pack table composed with the order in
    which the rank's send buffer goes to the ranks, and the unpack table
    composed with where each slot lands in the received buffer.

    ``send`` int32 ``(1, total_send)`` indexes the rank's L shards' flat
    sources concatenated (shard ``j - r * L`` at ``(j - r * L) * n``):
    for each destination rank q, for each of this rank's shards j, for
    each of q's shards d, the ``counts[j, d]`` elements of shard j's send
    buffer for d. ``in_splits`` / ``out_splits`` are the per-rank element
    counts of ``all_to_all_single``; the received buffer holds, for each
    source rank p, for each of p's shards j, for each of this rank's
    shards d, those elements. ``place`` ``(L, recv_cap + 1)`` maps shard
    d's receive slot (the JAX layout, and the sentinel ``recv_cap``) to
    its position in the received buffer (sentinel ``total_recv``)."""

    send: np.ndarray
    in_splits: tuple
    out_splits: tuple
    place: np.ndarray

    @property
    def total_recv(self) -> int:
        return int(sum(self.out_splits))


def rank_ragged_direction(counts, input_offsets, output_offsets, pack,
                          recv_cap: int, n_flat: int, size: int, rank: int
                          ) -> RankRagged:
    """:class:`RankRagged` of one direction from the JAX package's
    tables: ``counts[j, d]`` the elements shard j sends shard d,
    ``input_offsets[j, d]`` where they start in j's send buffer,
    ``output_offsets[j, d]`` where they land in d's receive buffer, and
    ``pack`` ``(S, send_cap)`` into each shard's flat source of ``n_flat``
    elements; ``size`` ranks, this one ``rank``."""
    counts = np.asarray(counts, np.int64)
    io = np.asarray(input_offsets, np.int64)
    oo = np.asarray(output_offsets, np.int64)
    s = counts.shape[0]
    loc = s // size
    mine = range(rank * loc, (rank + 1) * loc)
    send, in_splits = [], []
    for q in range(size):
        n = 0
        for j in mine:
            for d in range(q * loc, (q + 1) * loc):
                c = int(counts[j, d])
                if c:
                    send.append((j - rank * loc) * n_flat
                                + pack[j, io[j, d]:io[j, d] + c]
                                .astype(np.int64))
                    n += c
        in_splits.append(n)
    pos, out_splits, slots = 0, [], []
    for p in range(size):
        n = 0
        for j in range(p * loc, (p + 1) * loc):
            for d in mine:
                c = int(counts[j, d])
                if c:
                    slots.append((d - rank * loc, oo[j, d], pos + n, c))
                    n += c
        out_splits.append(n)
        pos += n
    place = np.full((loc, recv_cap + 1), pos, np.int64)
    for dl, o, start, c in slots:
        place[dl, o:o + c] = start + np.arange(c)
    send = np.concatenate(send) if send else np.zeros(0, np.int64)
    return RankRagged(send=send.astype(np.int32)[None],
                      in_splits=tuple(in_splits),
                      out_splits=tuple(out_splits),
                      place=place.astype(np.int32))


def compose_unpack(unpack: np.ndarray, chunks: list, recv_caps: list
                   ) -> np.ndarray:
    """This rank's unpack table ``(L, m)`` (the JAX layout: positions in
    the receive buffers of the chunks concatenated, sentinel their total)
    as positions in the received buffers of the chunks concatenated
    (sentinel their total): ``chunks`` the chunks' :class:`RankRagged`
    of the direction, ``recv_caps`` their receive capacities."""
    loc = unpack.shape[0]
    total = sum(rr.total_recv for rr in chunks)
    cat = np.full((loc, sum(recv_caps) + 1), total, np.int64)
    at, base = 0, 0
    for rr, cap in zip(chunks, recv_caps):
        body = rr.place[:, :cap].astype(np.int64)
        cat[:, at:at + cap] = np.where(body == rr.total_recv, total,
                                       body + base)
        at += cap
        base += rr.total_recv
    return np.take_along_axis(cat, np.asarray(unpack, np.int64), axis=1) \
        .astype(np.int32)


def _pair_views(buf: torch.Tensor) -> tuple:
    """The ``(re, im)`` views ``(1, B, m)`` of an interleaved ``(m, B, 2)``
    buffer, the gather kernel's sharded operand form."""
    return tuple(buf[..., c].t().unsqueeze(0) for c in range(2))


def rank_ragged_pack(src: tuple, send_table: torch.Tensor) -> torch.Tensor:
    """This rank's send buffer of the ragged schedule: the gather kernel
    reads it straight from the L shards' flat sources ``src`` (``(re,
    im)``, each ``(B, L, n)``) in rank order (``send_table``,
    :attr:`RankRagged.send` on the device) into one interleaved
    ``(total_send, B, 2)`` buffer."""
    b = src[0].shape[0]
    flat = tuple(t.reshape(b, 1, -1).transpose(0, 1) for t in src)
    m = send_table.shape[1]
    buf = torch.empty((m, b, 2), dtype=src[0].dtype, device=src[0].device)
    if m:
        gather_kernel.gather(flat, send_table, _pair_views(buf))
    return buf


def rank_ragged_move(buf: torch.Tensor, rr: RankRagged, wire, real_dtype,
                     comm: RankComm) -> Pending:
    """One direction of the ragged schedule over ranks: the send buffer
    of :func:`rank_ragged_pack` (cast to ``wire`` where it is not None)
    moves with one ``all_to_all_single`` of the exact split sizes; the
    result is the received ``(total_recv, B, 2)`` buffer of
    ``real_dtype`` (:func:`rank_ragged_unpack` reads it)."""
    import torch.distributed as dist
    if wire is not None:
        buf = buf.to(wire)
    recv = buf.new_empty((rr.total_recv,) + tuple(buf.shape[1:]))
    work = dist.all_to_all_single(recv, buf, list(rr.out_splits),
                                  list(rr.in_splits), group=comm.group,
                                  async_op=True)
    return Pending([work], lambda: recv if wire is None
                   else recv.to(real_dtype))


def rank_ragged_unpack(recv: torch.Tensor, table: torch.Tensor) -> tuple:
    """The unpack gather over the received buffer ``(total_recv, B, 2)``
    (every local shard reads the same buffer, a shard stride of 0) through
    this rank's composed table ``(L, m)`` -> ``(re, im)``, each ``(B, L,
    m)`` contiguous."""
    loc, m = table.shape
    b = recv.shape[1]
    out = tuple(torch.zeros((b, loc, m), dtype=recv.dtype,
                            device=recv.device) for _ in range(2))
    if recv.shape[0] and m:
        src = tuple(v.expand(loc, b, recv.shape[0])
                    for v in _pair_views(recv))
        gather_kernel.gather(src, table, tuple(t.transpose(0, 1)
                                               for t in out))
    return out


def rank_compact_move(bufs: list, pairs: list, wire, real_dtype,
                      comm: RankComm, tag0: int = 0) -> Pending:
    """:func:`compact_exchange` over ranks: ``bufs`` one ``(re, im)``
    pair ``(B, L, Lo)`` per op (this rank's shards), ``pairs`` per op
    None (a hop-0 op, or one without pairs) or its ``(src, dst)`` global
    shard pairs in the direction of the move. A pair within this rank is
    a copy; across ranks, each op is one ``batch_isend_irecv`` of its
    pairs (the payload ``(2, B, Lo)`` in the wire's dtype), each pair its
    own tag (a count over the ops' pairs, from ``tag0``, the same on every
    rank). The result, once waited for, is the op buffers concatenated,
    ``(B, L, sum Lo)`` each, as :func:`compact_exchange` returns them
    (zeros where this rank's shard receives nothing)."""
    import torch.distributed as dist
    lo = comm.rank * comm.local
    works, outs, recvs = [], [], []
    tag = tag0
    for pair, prs in zip(bufs, pairs):
        if prs is None:
            outs.append((pair, False))
            continue
        w = tuple(t if wire is None else t.to(wire) for t in pair)
        o = tuple(torch.zeros_like(t) for t in w)
        ops = []
        for s, d in prs:
            so, do = s // comm.local, d // comm.local
            tag += 1
            if so == comm.rank and do == comm.rank:
                for a, b in zip(o, w):
                    a[:, d - lo] = b[:, s - lo]
            elif so == comm.rank:
                ops.append(dist.P2POp(
                    dist.isend, torch.stack([t[:, s - lo] for t in w]),
                    comm.peer(do), comm.group, tag))
            elif do == comm.rank:
                r = torch.empty((2,) + tuple(w[0][:, 0].shape),
                                dtype=w[0].dtype, device=w[0].device)
                ops.append(dist.P2POp(dist.irecv, r, comm.peer(so),
                                      comm.group, tag))
                recvs.append((o, d - lo, r))
        if ops:
            works += dist.batch_isend_irecv(ops)
        outs.append((o, wire is not None))

    def finish():
        for o, dl, r in recvs:
            o[0][:, dl] = r[0]
            o[1][:, dl] = r[1]
        done = [tuple(t.to(real_dtype) for t in p) if cast else p
                for p, cast in outs]
        if len(done) == 1:
            return done[0]
        return tuple(torch.cat([p[i] for p in done], dim=-1)
                     for i in range(2))

    return Pending(works, finish)
