"""The chunked exchange (counterpart of ``spfft_tpu.parallel.overlap``,
copied: pure numpy, the JAX package's schedules entry for entry).

The reference hides its MPI exchange behind compute: the buffered
exchange is issued as a start/finalize pair bracketing the z-stick FFT
stage (reference src/execution/execution_host.cpp). The JAX package
splits the exchange schedule into K destination-balanced sub-schedules
("chunks"), issues each chunk's collective as soon as its rows are
transformed and unpacks once, late. The port runs its z and xy stages
over all rows once (each stick's and plane's transform is independent of
the chunking) and chunks the exchange only, in the same order: each
chunk's pack and move issued early, one unpack late, on the plan's
stream. Over the ranks of a process group each chunk's collective is
issued asynchronously in chunk order and waited on just before the
unpack, so on NCCL chunk c moves while chunk c + 1 packs.

Chunking axes (static slices of the padded per-shard layouts):

* backward — local STICK rows ``[0, max_sticks)``: chunk c ships stick
  rows ``[stick_lo, stick_hi)``;
* forward — local PLANE rows ``[0, max_planes)``: chunk c ships plane
  rows ``[plane_lo, plane_hi)``.

Chunk boundaries come from :func:`chunk_bounds`, which balances the TRUE
row count (sticks/planes actually populated, summed over shards) per
chunk rather than slicing the padded extent evenly — with that split,
every destination's ingress is divided proportionally across chunks.

Three chunk kinds mirror the three exchange mechanisms (exchange.py):

* ``"block"`` — the padded block layouts (the transposing copy and the
  ring): a chunk is a contiguous row/plane slice of the ``(S,
  max_sticks, max_planes)`` block; received chunk blocks concatenate back
  into the full block, so no new tables are needed — only the bounds.
* ``"ragged"`` — the one-collective exact-count exchange: each chunk is a
  complete :class:`~.exchange.RaggedSchedule`-style table set over the
  chunk's rows, with ONE global unpack table per direction indexing the
  concatenation of all chunk receive buffers (unpack runs once, late).
* ``"compact"`` — the exact-size op schedule: per-chunk op lists built by
  the same size-classing as the monolithic schedule, again with one late
  global unpack per direction.

Invariants (tests/test_overlap_exchange.py holds the JAX package's):
the chunks' (src, dst, element) sets partition the monolithic schedule's
exactly, per direction; per-chunk exact wire elements sum to the
monolithic exact total; no chunk's busiest link exceeds the monolithic
schedule's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..errors import InvalidParameterError
from ..indexing import window_sub_cols
from .exchange import _ragged_direction_tables, _size_classes


def chunk_bounds(true_counts, padded: int, num_chunks: int,
                 skew_weight: float = 1.0) -> tuple:
    """Split the padded row range ``[0, padded)`` into ``num_chunks``
    contiguous slices, SKEW-AWARE: balance per-destination ingress
    within each chunk, not just true-row totals.

    ``true_counts[r]`` is shard r's populated row count (``<= padded``;
    rows are always a prefix of the padded extent). Two normalised
    weights are summed per padded row and the bounds slice at equal
    cumulative weight:

    * the INGRESS weight ``#{r : true_counts[r] > i} / total`` — every
      populated row of every shard ships the same per-destination
      element count (``num_planes(d)`` sticks backward /
      ``num_sticks(d)`` planes forward), so equal cumulative population
      per chunk equalises every destination's per-chunk ingress;
    * the BUSIEST-SOURCE weight ``[i < max(true_counts)] / max`` —
      within one chunk the heaviest (src, dst) link belongs to the
      shard with the most populated rows there, and prefix-populated
      rows make that ``clip(max(true_counts), lo, hi)`` for any slice,
      so equal cumulative share of the largest shard's rows equalises
      the per-chunk busiest link.

    Balancing only the first (``skew_weight=0``) lets one dominant
    shard concentrate in a chunk under skewed stick ownership:
    ``true_counts=[10, 100]`` at K=2 cut the total 55/55 but the
    dominant shard's link 45/55 — the pipeline
    then stalls on the uneven chunk exactly where overlap was supposed
    to hide the wire. The combined weight splits the difference;
    perfectly uniform shards reproduce the old bounds (both weights
    are then proportional). Bounds are strictly increasing and cover
    ``[0, padded)`` exactly, so the union/conservation/no-hot-spot
    schedule invariants hold for every ``skew_weight``.
    """
    K = int(num_chunks)
    if K < 1:
        raise InvalidParameterError("num_chunks must be >= 1")
    if K > padded:
        raise InvalidParameterError(
            f"num_chunks ({K}) exceeds padded rows ({padded})")
    w = np.zeros(padded, np.float64)
    for c in true_counts:
        w[: int(c)] += 1.0
    total = w.sum()
    if total > 0:
        w /= total
    cmax = int(max(true_counts, default=0))
    if skew_weight and cmax > 0:
        w[:cmax] += float(skew_weight) / cmax
    cum = np.concatenate([[0.0], np.cumsum(w)])
    bounds = [0]
    for c in range(1, K):
        target = cum[-1] * c / K
        j = int(np.searchsorted(cum, target, side="left"))
        j = max(j, bounds[-1] + 1)     # strictly increasing
        j = min(j, padded - (K - c))   # leave >= 1 row per later chunk
        bounds.append(j)
    bounds.append(padded)
    return tuple(zip(bounds[:-1], bounds[1:]))


def chunk_bounds_aligned(true_counts, padded: int, num_chunks: int,
                         align: int, skew_weight: float = 1.0) -> tuple:
    """Super-tile-aligned variant of :func:`chunk_bounds`: every
    INTERIOR bound snaps to the nearest multiple of ``align`` (the
    fused backward kernel's ``r_sticks`` super-tile height), so a
    chunk-sliced fused launch wastes no partial super-tile at chunk
    seams — only the final chunk may end unaligned (``padded`` itself
    need not be a multiple). Falls back to the unaligned bounds when
    the padded extent cannot give every chunk at least one full
    super-tile (``padded < align * num_chunks``); the per-chunk table
    sets handle arbitrary bounds, alignment is purely a waste
    reduction. Same strict-increase / exact-cover invariants as
    :func:`chunk_bounds`."""
    base = chunk_bounds(true_counts, padded, num_chunks, skew_weight)
    a, K = int(align), int(num_chunks)
    if a <= 1 or padded < a * K:
        return base
    bounds = [0]
    for lo, hi in base[:-1]:
        snapped = int(round(hi / a)) * a
        snapped = max(snapped, bounds[-1] + a)
        snapped = min(snapped, padded - a * (K - len(bounds)))
        bounds.append(snapped)
    bounds.append(padded)
    return tuple(zip(bounds[:-1], bounds[1:]))


def _clip_count(count: int, lo: int, hi: int) -> int:
    """Rows of a populated prefix ``[0, count)`` falling in ``[lo, hi)``."""
    return max(0, min(int(count), hi) - lo)


@dataclasses.dataclass(frozen=True)
class BlockChunk:
    """One chunk of the padded block exchange: pure static bounds."""

    stick_lo: int
    stick_hi: int
    plane_lo: int
    plane_hi: int
    n_bwd: np.ndarray    # (S, S) exact backward pair elements
    n_fwd: np.ndarray    # (S, S) exact forward pair elements


@dataclasses.dataclass(frozen=True)
class RaggedChunk:
    """One chunk of the exact-count (ragged) exchange — a complete
    RaggedSchedule-shaped table set over the chunk's stick/plane rows,
    with pack tables indexing CHUNK-LOCAL flat layouts (the pipelined
    body FFTs exactly the chunk's rows, so the pack gather addresses the
    chunk's output, not the full local array)."""

    stick_lo: int
    stick_hi: int
    plane_lo: int
    plane_hi: int
    send_cap: int
    recv_cap: int
    bwd_offsets: tuple       # (input_offsets, send_sizes, output_offsets,
                             #  recv_sizes), each (S, S) int32
    fwd_offsets: tuple
    bwd_pack: np.ndarray     # (S, send_cap) into chunk-local flat sticks
    fwd_pack: np.ndarray     # (S, send_cap) into chunk-local flat grid
    emu_bwd: np.ndarray      # (S, recv_cap) into allgathered flat sends
    emu_fwd: np.ndarray

    @property
    def n_bwd(self) -> np.ndarray:
        return np.asarray(self.bwd_offsets[1], np.int64)

    @property
    def n_fwd(self) -> np.ndarray:
        return np.asarray(self.fwd_offsets[1], np.int64)


@dataclasses.dataclass(frozen=True)
class CompactChunk:
    """One chunk of the exact-size ppermute op schedule. Unlike the
    monolithic :class:`~.exchange.CompactSchedule` (whose one op list
    serves both directions with pairs reversed), backward chunks slice
    STICKS and forward chunks slice PLANES, so each direction gets its
    own op list; pairs are stored in SEND orientation (src, dst) and
    both directions run ``compact_exchange(..., reverse=False)``."""

    stick_lo: int
    stick_hi: int
    plane_lo: int
    plane_hi: int
    bwd_ops: tuple           # (k, L, pairs) — pairs (src, dst)
    fwd_ops: tuple
    bwd_pack: tuple          # per-op (S, L) into chunk-local flat sticks
    fwd_pack: tuple          # per-op (S, L) into chunk-local flat grid
    n_bwd: np.ndarray        # (S, S) exact pair elements
    n_fwd: np.ndarray

    @property
    def bwd_total(self) -> int:
        return int(sum(L for _, L, _ in self.bwd_ops))

    @property
    def fwd_total(self) -> int:
        return int(sum(L for _, L, _ in self.fwd_ops))


@dataclasses.dataclass(frozen=True)
class OverlapSchedule:
    """K destination-balanced sub-schedules plus the late global unpack
    tables. ``kind`` is ``"block"`` / ``"ragged"`` / ``"compact"``;
    block chunks need no tables (received blocks concatenate back into
    the monolithic layout). Accounting here is EXACT per-pair elements
    (no padding, no 1.25x bucket charge) — for ragged that matches the
    monolithic schedule's accounting; for compact it lower-bounds the
    bucket-charged monolithic numbers."""

    kind: str
    num_shards: int
    chunks: tuple
    bwd_unpack: Optional[np.ndarray]   # (S, mp*Y*Xe) into concat'd recvs
    fwd_unpack: Optional[np.ndarray]   # (S, ms*dz)

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    # -- schedule introspection (fused-dist per-chunk table builds) ---------
    def stick_bounds(self) -> tuple:
        """Per-chunk backward stick-row slices ``((lo, hi), ...)`` of
        the padded local stick extent — the slices a chunk-sliced fused
        decompress+z-DFT build restricts its gather tables to."""
        return tuple((ch.stick_lo, ch.stick_hi) for ch in self.chunks)

    def plane_bounds(self) -> tuple:
        """Per-chunk forward plane-row slices ``((lo, hi), ...)`` of
        the padded local plane extent."""
        return tuple((ch.plane_lo, ch.plane_hi) for ch in self.chunks)

    # -- exact accounting ---------------------------------------------------
    def _chunk_links(self, c: int, forward: bool):
        n = np.asarray(self.chunks[c].n_fwd if forward
                       else self.chunks[c].n_bwd, np.int64).copy()
        np.fill_diagonal(n, 0)
        return n.sum(axis=1), n.sum(axis=0)

    def chunk_wire_elements(self, c: int, forward: bool = False) -> int:
        """Exact off-shard complex elements chunk ``c`` ships."""
        send, _ = self._chunk_links(c, forward)
        return int(send.sum())

    def chunk_busiest_link_elements(self, c: int,
                                    forward: bool = False) -> int:
        """Max over shards of max(sent, received) for chunk ``c``."""
        send, recv = self._chunk_links(c, forward)
        both = np.maximum(send, recv)
        return int(both.max()) if self.num_shards else 0

    def wire_elements(self) -> int:
        """TOTAL exact off-shard elements per exchange (all chunks) —
        chunking moves no extra bytes, so this equals the monolithic
        exact total (tests assert the conservation)."""
        return sum(self.chunk_wire_elements(c)
                   for c in range(self.num_chunks))

    def busiest_link_elements(self) -> int:
        """Bottleneck-link elements for ONE whole exchange: per-shard
        send/recv summed over all chunks, then max — every chunk's data
        still crosses the same links."""
        send = np.zeros(self.num_shards, np.int64)
        recv = np.zeros(self.num_shards, np.int64)
        for c in range(self.num_chunks):
            s, r = self._chunk_links(c, False)
            send += s
            recv += r
        both = np.maximum(send, recv)
        return int(both.max()) if self.num_shards else 0

    def chunk_scale_rows(self, c: int, forward: bool = False) -> int:
        """int8-wire scale rows chunk ``c`` carries: one f32 absmax
        scale per (destination slot, quant row), quant rows being the
        chunk's stick slice backward / plane slice forward — exactly
        the chunk-bound axes, so the per-chunk sidecars partition the
        monolithic one. Only the padded block kind carries the int8
        rung (exact-count kinds decline it), so other kinds report 0."""
        if self.kind != "block":
            return 0
        ch = self.chunks[c]
        return (ch.plane_hi - ch.plane_lo if forward
                else ch.stick_hi - ch.stick_lo)

    def scale_rows(self, forward: bool = False) -> int:
        """TOTAL int8 scale rows per exchange (all chunks). The chunk
        bounds partition ``[0, max_sticks)`` / ``[0, max_planes)``, so
        this is conserved at every K — the sidecar analogue of the
        :meth:`wire_elements` conservation the tests assert."""
        return sum(self.chunk_scale_rows(c, forward)
                   for c in range(self.num_chunks))

    # -- device-table plumbing ----------------------------------------------
    def device_tables(self) -> list:
        """The (S, ...) arrays the SPMD bodies consume, flattened in a
        fixed order: every chunk's tables, then the two global late
        unpack tables (see :meth:`chunk_table_slices` for the per-chunk
        positions). Block kind needs no tables."""
        if self.kind == "block":
            return []
        out = []
        for ch in self.chunks:
            if self.kind == "ragged":
                out.extend([ch.bwd_pack, ch.fwd_pack])
                out.extend(ch.bwd_offsets)
                out.extend(ch.fwd_offsets)
                out.extend([ch.emu_bwd, ch.emu_fwd])
            else:
                out.extend(ch.bwd_pack)
                out.extend(ch.fwd_pack)
        out.extend([self.bwd_unpack, self.fwd_unpack])
        return out

    def chunk_table_slices(self) -> tuple:
        """Per-chunk index map into :meth:`device_tables`'s flat list.
        Ragged: ``{"bwd_pack", "fwd_pack", "offs_b", "offs_f",
        "emu_bwd", "emu_fwd"}``; compact: ``{"bwd_ops", "fwd_ops"}``
        ((start, stop) ranges). The two global unpack tables always sit
        at positions -2 (backward) and -1 (forward)."""
        maps, pos = [], 0
        for ch in self.chunks:
            if self.kind == "ragged":
                maps.append({
                    "bwd_pack": pos, "fwd_pack": pos + 1,
                    "offs_b": (pos + 2, pos + 6),
                    "offs_f": (pos + 6, pos + 10),
                    "emu_bwd": pos + 10, "emu_fwd": pos + 11})
                pos += 12
            elif self.kind == "compact":
                nb, nf = len(ch.bwd_ops), len(ch.fwd_ops)
                maps.append({"bwd_ops": (pos, pos + nb),
                             "fwd_ops": (pos + nb, pos + nb + nf)})
                pos += nb + nf
            else:
                maps.append({})
        return tuple(maps)

    # -- element introspection (tests: union == monolithic) -----------------
    def bwd_pair_elements(self, c: int) -> dict:
        """Chunk ``c``'s backward payload as ``{(src, dst): sorted array
        of GLOBAL flat local-stick indices (i * dim_z + z)}`` — derived
        from the actual pack tables (not the count matrices), so the
        union test exercises what the wire really carries."""
        ch = self.chunks[c]
        out = {}
        rebase = ch.stick_lo * self._dz_cached
        if self.kind == "ragged":
            io = np.asarray(ch.bwd_offsets[0], np.int64)
            n = np.asarray(ch.bwd_offsets[1], np.int64)
            for j in range(self.num_shards):
                for d in range(self.num_shards):
                    if n[j, d]:
                        seg = ch.bwd_pack[j, io[j, d]:io[j, d] + n[j, d]]
                        out[(j, d)] = np.sort(seg.astype(np.int64)
                                              + rebase)
            return out
        if self.kind == "compact":
            loc = (ch.stick_hi - ch.stick_lo) * self._dz_cached
            for oi, (k, L, pairs) in enumerate(ch.bwd_ops):
                tbl = ch.bwd_pack[oi]
                for j, d in pairs:
                    seg = tbl[j].astype(np.int64)
                    out[(j, d)] = np.sort(seg[seg < loc] + rebase)
            return out
        raise InvalidParameterError(
            "element introspection applies to ragged/compact kinds")

    def fwd_pair_elements(self, c: int) -> dict:
        """Chunk ``c``'s forward payload as ``{(src, dst): sorted array
        of GLOBAL flat local-grid indices (p * dim_y * dim_x_eff +
        col)}`` — same table-derived contract as
        :meth:`bwd_pair_elements`."""
        ch = self.chunks[c]
        out = {}
        rebase = ch.plane_lo * self._grid_row_cached
        if self.kind == "ragged":
            io = np.asarray(ch.fwd_offsets[0], np.int64)
            n = np.asarray(ch.fwd_offsets[1], np.int64)
            for j in range(self.num_shards):
                for d in range(self.num_shards):
                    if n[j, d]:
                        seg = ch.fwd_pack[j, io[j, d]:io[j, d] + n[j, d]]
                        out[(j, d)] = np.sort(seg.astype(np.int64)
                                              + rebase)
            return out
        if self.kind == "compact":
            loc = (ch.plane_hi - ch.plane_lo) * self._grid_row_cached
            for oi, (k, L, pairs) in enumerate(ch.fwd_ops):
                tbl = ch.fwd_pack[oi]
                for j, d in pairs:
                    seg = tbl[j].astype(np.int64)
                    out[(j, d)] = np.sort(seg[seg < loc] + rebase)
            return out
        raise InvalidParameterError(
            "element introspection applies to ragged/compact kinds")

    # dz / grid-row extents are stashed by build_overlap_schedule
    # (object.__setattr__ on the frozen dataclass) purely for the
    # introspection helpers above.
    _dz_cached: int = dataclasses.field(default=0, compare=False)
    _grid_row_cached: int = dataclasses.field(default=0, compare=False)


def _chunk_geometry(dp, num_chunks: int, stick_align: int = 1):
    S = dp.num_shards
    ns = [p.num_sticks for p in dp.shard_plans]
    npl = list(dp.num_planes)
    if stick_align > 1:
        sb = chunk_bounds_aligned(ns, dp.max_sticks, num_chunks,
                                  stick_align)
    else:
        sb = chunk_bounds(ns, dp.max_sticks, num_chunks)
    pb = chunk_bounds(npl, dp.max_planes, num_chunks)
    return S, ns, npl, list(dp.plane_offsets), sb, pb


def _pair_counts(S, ns, npl, ns_c, npl_c):
    n_bwd = np.asarray([[ns_c[j] * npl[d] for d in range(S)]
                        for j in range(S)], np.int64)
    n_fwd = np.asarray([[ns[d] * npl_c[j] for d in range(S)]
                        for j in range(S)], np.int64)
    return n_bwd, n_fwd


def build_overlap_schedule(dp, num_chunks: int, kind: str,
                           x_window=None,
                           stick_align: int = 1) -> OverlapSchedule:
    """Build the K-chunk overlap schedule from a ``DistributedIndexPlan``
    (same duck-typed contract and x-window composition as the monolithic
    schedule functions in exchange.py). ``stick_align > 1`` snaps the backward
    stick bounds to super-tile multiples via
    :func:`chunk_bounds_aligned` (best effort — unaligned fallback when
    the extent is too small) for the chunk-sliced fused launches."""
    if kind not in ("block", "ragged", "compact"):
        raise InvalidParameterError(f"unknown overlap kind {kind!r}")
    S, ns, npl, off, sb, pb = _chunk_geometry(dp, num_chunks, stick_align)
    ms, mp_ = dp.max_sticks, dp.max_planes
    dz, Y, Xf = dp.dim_z, dp.dim_y, dp.dim_x_freq
    Xe = Xf if x_window is None else x_window[1]

    def grid_cols(cols):
        if x_window is None:
            return np.asarray(cols, np.int64)
        return window_sub_cols(cols, Xf, *x_window).astype(np.int64)

    if kind == "block":
        chunks = []
        for (s0, s1), (p0, p1) in zip(sb, pb):
            ns_c = [_clip_count(n, s0, s1) for n in ns]
            npl_c = [_clip_count(n, p0, p1) for n in npl]
            n_bwd, n_fwd = _pair_counts(S, ns, npl, ns_c, npl_c)
            chunks.append(BlockChunk(s0, s1, p0, p1, n_bwd, n_fwd))
        sched = OverlapSchedule(kind, S, tuple(chunks), None, None)
        object.__setattr__(sched, "_dz_cached", dz)
        object.__setattr__(sched, "_grid_row_cached", Y * Xe)
        return sched

    # -- z ownership (forward unpack shares it across kinds) ---------------
    z_owner = np.empty(dz, np.int64)
    z_plane = np.empty(dz, np.int64)
    for s in range(S):
        z_owner[off[s]:off[s] + npl[s]] = s
        z_plane[off[s]:off[s] + npl[s]] = np.arange(npl[s])
    # chunk index of each global z (by its owner-local plane row)
    z_chunk = np.empty(dz, np.int64)
    for c, (p0, p1) in enumerate(pb):
        sel = (z_plane >= p0) & (z_plane < p1)
        z_chunk[sel] = c

    if kind == "ragged":
        chunks, roffs = [], []
        for (s0, s1), (p0, p1) in zip(sb, pb):
            ns_c = [_clip_count(n, s0, s1) for n in ns]
            npl_c = [_clip_count(n, p0, p1) for n in npl]
            n_bwd, n_fwd = _pair_counts(S, ns, npl, ns_c, npl_c)
            bwd_offs, s_b, r_b, roff_b = _ragged_direction_tables(S, n_bwd)
            fwd_offs, s_f, r_f, roff_f = _ragged_direction_tables(S, n_fwd)
            send_cap, recv_cap = max(s_b, s_f), max(r_b, r_f)
            io_b = bwd_offs[0].astype(np.int64)
            io_f = fwd_offs[0].astype(np.int64)
            loc_sticks = (s1 - s0) * dz
            loc_grid = (p1 - p0) * Y * Xe
            bwd_pack = np.full((S, send_cap), loc_sticks, np.int32)
            fwd_pack = np.full((S, send_cap), loc_grid, np.int32)
            emu_bwd = np.full((S, recv_cap), S * send_cap, np.int32)
            emu_fwd = np.full((S, recv_cap), S * send_cap, np.int32)
            for j in range(S):
                for d in range(S):
                    n = ns_c[j] * npl[d]
                    if n:
                        i = np.arange(ns_c[j])[:, None]   # chunk-local
                        z = off[d] + np.arange(npl[d])[None, :]
                        bwd_pack[j, io_b[j, d]:io_b[j, d] + n] = \
                            (i * dz + z).reshape(-1)
                        emu_bwd[d, roff_b[d, j]:roff_b[d, j] + n] = \
                            j * send_cap + io_b[j, d] + np.arange(n)
                    m = ns[d] * npl_c[j]
                    if m:
                        cols = grid_cols(dp.shard_plans[d].scatter_cols)
                        p = np.arange(npl_c[j])[None, :]  # chunk-local
                        fwd_pack[j, io_f[j, d]:io_f[j, d] + m] = \
                            (p * (Y * Xe) + cols[:, None]).reshape(-1)
                        emu_fwd[d, roff_f[d, j]:roff_f[d, j] + m] = \
                            j * send_cap + io_f[j, d] + np.arange(m)
            chunks.append(RaggedChunk(
                s0, s1, p0, p1, send_cap, recv_cap, bwd_offs, fwd_offs,
                bwd_pack, fwd_pack, emu_bwd, emu_fwd))
            roffs.append((roff_b, roff_f))
        # late unpack: positions in the chunk-ordered recv concatenation
        # (both directions share the per-chunk recv_cap layout)
        coff = np.concatenate(
            [[0], np.cumsum([ch.recv_cap for ch in chunks])]).astype(
                np.int64)
        total = int(coff[-1])
        bwd_unpack = np.full((S, mp_ * Y * Xe), total, np.int32)
        for r in range(S):
            if npl[r] == 0:
                continue
            for s in range(S):
                for c, ((s0, s1), (roff_b, _)) in enumerate(zip(sb, roffs)):
                    nsc = _clip_count(ns[s], s0, s1)
                    if nsc == 0:
                        continue
                    cols = grid_cols(
                        dp.shard_plans[s].scatter_cols)[s0:s0 + nsc]
                    i = np.arange(nsc)[:, None]
                    p = np.arange(npl[r])[None, :]
                    pos = coff[c] + roff_b[r, s] + i * npl[r] + p
                    flat_idx = p * (Y * Xe) + cols[:, None]
                    bwd_unpack[r][flat_idx.reshape(-1)] = pos.reshape(-1)
        fwd_unpack = np.full((S, ms * dz), total, np.int32)
        npl_cz = np.asarray(  # planes of z's owner inside z's chunk
            [_clip_count(npl[o], *pb[c])
             for o, c in zip(z_owner, z_chunk)], np.int64)
        for d in range(S):
            if ns[d] == 0:
                continue
            base = np.asarray(
                [coff[z_chunk[z]] + roffs[z_chunk[z]][1][d, z_owner[z]]
                 + (z_plane[z] - pb[z_chunk[z]][0]) for z in range(dz)],
                np.int64)
            i = np.arange(ns[d])[:, None]
            idx = base[None, :] + i * npl_cz[None, :]
            fwd_unpack[d, :ns[d] * dz] = idx.reshape(-1)
        sched = OverlapSchedule(kind, S, tuple(chunks), bwd_unpack,
                                fwd_unpack)
        object.__setattr__(sched, "_dz_cached", dz)
        object.__setattr__(sched, "_grid_row_cached", Y * Xe)
        return sched

    # kind == "compact": per-direction exact-size op schedules per chunk
    chunks, meta = [], []
    for (s0, s1), (p0, p1) in zip(sb, pb):
        ns_c = [_clip_count(n, s0, s1) for n in ns]
        npl_c = [_clip_count(n, p0, p1) for n in npl]
        n_bwd, n_fwd = _pair_counts(S, ns, npl, ns_c, npl_c)
        loc_sticks = (s1 - s0) * dz
        loc_grid = (p1 - p0) * Y * Xe

        def build_ops(sizes_of):
            ops = []
            for k in range(S):
                sizes = {j: sizes_of(j, (j + k) % S) for j in range(S)
                         if sizes_of(j, (j + k) % S) > 0}
                for L, js in _size_classes(sizes):
                    ops.append((k, int(L),
                                tuple((j, (j + k) % S) for j in js)))
            return ops or [(0, 1, ())]

        bwd_ops = build_ops(lambda j, d: ns_c[j] * npl[d])
        fwd_ops = build_ops(lambda j, d: ns[d] * npl_c[j])
        bwd_pack = []
        for k, L, pairs in bwd_ops:
            tbl = np.full((S, L), loc_sticks, np.int32)
            for j, d in pairs:
                n = ns_c[j] * npl[d]
                i = np.arange(ns_c[j])[:, None]
                z = off[d] + np.arange(npl[d])[None, :]
                tbl[j, :n] = (i * dz + z).reshape(-1)
            bwd_pack.append(tbl)
        fwd_pack = []
        for k, L, pairs in fwd_ops:
            tbl = np.full((S, L), loc_grid, np.int32)
            for j, d in pairs:
                m = ns[d] * npl_c[j]
                cols = grid_cols(dp.shard_plans[d].scatter_cols)
                p = np.arange(npl_c[j])[None, :]
                tbl[j, :m] = (p * (Y * Xe) + cols[:, None]).reshape(-1)
            fwd_pack.append(tbl)

        def op_index(ops):
            offs = np.concatenate(
                [[0], np.cumsum([L for _, L, _ in ops])]).astype(np.int64)
            op_of = {}
            for oi, (k, _, pairs) in enumerate(ops):
                for pr in pairs:
                    op_of[pr] = oi
            return offs, op_of

        chunks.append(CompactChunk(s0, s1, p0, p1, tuple(bwd_ops),
                                   tuple(fwd_ops), tuple(bwd_pack),
                                   tuple(fwd_pack), n_bwd, n_fwd))
        meta.append((op_index(bwd_ops), op_index(fwd_ops)))
    coff_b = np.concatenate(
        [[0], np.cumsum([ch.bwd_total for ch in chunks])]).astype(np.int64)
    coff_f = np.concatenate(
        [[0], np.cumsum([ch.fwd_total for ch in chunks])]).astype(np.int64)
    bwd_unpack = np.full((S, mp_ * Y * Xe), int(coff_b[-1]), np.int32)
    for r in range(S):
        if npl[r] == 0:
            continue
        for s in range(S):
            for c, ((s0, s1), ((offs_b, op_b), _)) in enumerate(
                    zip(sb, meta)):
                nsc = _clip_count(ns[s], s0, s1)
                if nsc == 0:
                    continue
                cols = grid_cols(
                    dp.shard_plans[s].scatter_cols)[s0:s0 + nsc]
                i = np.arange(nsc)[:, None]
                p = np.arange(npl[r])[None, :]
                pos = (coff_b[c] + offs_b[op_b[(s, r)]]
                       + i * npl[r] + p)
                flat_idx = p * (Y * Xe) + cols[:, None]
                bwd_unpack[r][flat_idx.reshape(-1)] = pos.reshape(-1)
    fwd_unpack = np.full((S, ms * dz), int(coff_f[-1]), np.int32)
    npl_cz = np.asarray([_clip_count(npl[o], *pb[c])
                         for o, c in zip(z_owner, z_chunk)], np.int64)
    for d in range(S):
        if ns[d] == 0:
            continue
        base = np.empty(dz, np.int64)
        for z in range(dz):
            c = int(z_chunk[z])
            (offs_f, op_f) = meta[c][1]
            base[z] = (coff_f[c] + offs_f[op_f[(int(z_owner[z]), d)]]
                       + (z_plane[z] - pb[c][0]))
        i = np.arange(ns[d])[:, None]
        idx = base[None, :] + i * npl_cz[None, :]
        fwd_unpack[d, :ns[d] * dz] = idx.reshape(-1)
    sched = OverlapSchedule(kind, S, tuple(chunks), bwd_unpack, fwd_unpack)
    object.__setattr__(sched, "_dz_cached", dz)
    object.__setattr__(sched, "_grid_row_cached", Y * Xe)
    return sched
