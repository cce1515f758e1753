"""Distributed sparse 3D FFT plans over S shards (counterpart of
``spfft_tpu.parallel.dist``).

The reference's distributed layout (SURVEY.md §5.7): the space domain
split into z-plane *slabs* per shard, the frequency domain into z-stick
*pencils*; an exchange re-localises z between the two (reference:
src/parameters/parameters.cpp:43-140, src/execution/execution_host.cpp:
249-352). Per shard, as in the JAX package's SPMD body:

  backward:  decompress + [stick symmetry] + z-DFT -> pack -> exchange ->
             unpack -> [plane symmetry] -> xy-DFT
  forward:   xy-DFT -> pack -> exchange -> unpack -> z-DFT + compress

This slice holds the S shards in one process on one device (see
:mod:`.mesh`), in the JAX package's stacked caller layouts:

* frequency values ``(S, max_values, 2)`` interleaved, shard r's values
  first, zero-padded;
* space ``(S, max_planes, dim_y, dim_x[, 2])``: shard r's slab is rows
  ``[0, num_planes(r))`` of its block (zero-padded after), global z
  ``plane_offsets(r) + p``.

Batched calls put the batch second: ``(S, B, ...)``.

What runs on the card, per pair:

* the z stage once per shard on that shard's own tables: the fused
  ``decompress_zdft`` / ``zdft_compress`` kernels (its ``slot_src`` row,
  sentinel ``max_values``; its CSR over ``max_sticks`` sticks; its (0,0)
  stick, or -1 where another shard owns it) — S launches of each; or,
  with ``fused=False``, the gather kernel once in each direction over
  every shard's stacked tables and one ``pdft_last`` over every shard's
  sticks;
* the block exchange (:mod:`.exchange`) as tensor gathers and one
  transposing copy;
* the xy stage once over all ``S * max_planes`` planes (the planes are
  independent): C2C one ``pdft2_swapped`` call (two launches) per
  direction; split-x C2C and R2C ``pdft_last`` for the y-DFT (and the
  split C2C x-DFT), R2C's real x-DFT one ``prdft_last`` /
  ``pirdft_last`` launch (the real FFT form of ``csrc/rfft.cu`` where
  dim_x is even with a 2^a 3^b 5^c half).

FULL scaling is folded into the forward z matrix, as the local plan does
(the JAX distributed forward multiplies after the gather; the two agree
within the precision's tolerance). ``precision="double"`` runs every
stage, table and matrix in float64 through the kernels' float64
instances, and the exchange moves 16-byte values, as the local plan
does. The JAX package's TPU window tables and uniform per-shard table
padding have no counterpart: the CUDA kernels take every shard's shape.
Its one fused-kernel decline kept here is by length: a z axis above
``ops.fused_kernel.MAX_DIM_Z`` (``"dimz_over_cap"``,
``fused_dist_fallback_reason``) takes the two-kernel route. Long axes run
as in the local plan: each stage takes its form by its length
(``ops.dft.c2c_form`` / ``real_form``), in the per-shard z stage, the y
stage and the split or R2C x stages.

A plan of one shard below ``PAIR_IO_THRESHOLD`` values runs through the
local :class:`~spfft_tpu_torch.plan.TransformPlan` (the reference treats
a size-1 communicator as local, grid_internal.cpp:182), keeping the
stacked API. Not in this slice, each raising a typed error that names
its slice: the compact, ring and float-wire exchanges, ``overlap_chunks
> 1``, the wire ladder and a mesh over several devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..errors import InvalidParameterError, ParameterMismatchError
from ..indexing import (build_index_plan, check_stick_duplicates,
                        occupied_x_window, window_sub_cols)
from ..ops import dft, dft_kernel, fused_kernel, gather_kernel, stages
from ..plan import (PAIR_IO_THRESHOLD, TransformPlan, _not_in_slice,
                    resolve_device)
from ..timing import timed_transform
from ..types import ExchangeType, Scaling, TransformType
from ..utils.dtypes import as_interleaved, real_dtype, torch_real_dtype
from .exchange import (all_to_all_blocks, pack_freq_to_blocks,
                       pack_space_to_blocks, unpack_blocks_to_grid,
                       unpack_blocks_to_sticks)
from .mesh import Mesh, make_mesh


@dataclasses.dataclass(frozen=True)
class DistributedIndexPlan:
    """The global distribution plan: per-shard stick sets + slab split
    (reference ``Parameters`` in distributed mode, parameters.cpp:43-140)."""

    transform_type: TransformType
    dim_x: int
    dim_y: int
    dim_z: int
    shard_plans: tuple
    num_planes: tuple
    plane_offsets: tuple

    @property
    def num_shards(self) -> int:
        return len(self.shard_plans)

    @property
    def max_sticks(self) -> int:
        return max(p.num_sticks for p in self.shard_plans)

    @property
    def max_planes(self) -> int:
        return max(self.num_planes)

    @property
    def max_values(self) -> int:
        return max(p.num_values for p in self.shard_plans)

    @property
    def dim_x_freq(self) -> int:
        return self.shard_plans[0].dim_x_freq

    @property
    def hermitian(self) -> bool:
        return self.transform_type == TransformType.R2C

    @property
    def num_global_elements(self) -> int:
        """Total sparse values across shards (reference
        transform.hpp:145)."""
        return sum(p.num_values for p in self.shard_plans)


def _check_planes(num_shards: int, planes_per_shard: Sequence[int],
                  dim_z: int) -> tuple:
    if num_shards != len(planes_per_shard):
        raise InvalidParameterError(
            "triplets_per_shard and planes_per_shard length mismatch")
    if num_shards == 0:
        raise InvalidParameterError("need at least one shard")
    planes = tuple(int(p) for p in planes_per_shard)
    if any(p < 0 for p in planes):
        raise InvalidParameterError("negative plane count")
    if sum(planes) != dim_z:
        # reference: parameters.cpp:107-109 (MPIParameterMismatchError)
        raise ParameterMismatchError(
            f"sum of planes per shard ({sum(planes)}) != dim_z ({dim_z})")
    return planes


def distributed_index_plan(shard_plans: Sequence,
                           planes_per_shard: Sequence[int]
                           ) -> DistributedIndexPlan:
    """Validate per-shard index plans of one transform and its slab
    heights into a :class:`DistributedIndexPlan`: the plane sum, stick
    duplicates across shards (reference indices.hpp:105-117) and the
    stick total (parameters.cpp:103-106)."""
    shard_plans = tuple(shard_plans)
    if not shard_plans:
        raise InvalidParameterError("need at least one shard")
    p0 = shard_plans[0]
    dims = (p0.transform_type, p0.dim_x, p0.dim_y, p0.dim_z)
    if any((p.transform_type, p.dim_x, p.dim_y, p.dim_z) != dims
           for p in shard_plans):
        raise InvalidParameterError(
            "shard plans differ in transform type or dimensions")
    planes = _check_planes(len(shard_plans), planes_per_shard, p0.dim_z)
    check_stick_duplicates([p.stick_keys for p in shard_plans])
    total_sticks = sum(p.num_sticks for p in shard_plans)
    if total_sticks > p0.dim_x * p0.dim_y:
        raise ParameterMismatchError(
            f"total sticks ({total_sticks}) exceed xy plane size")
    offsets = tuple(int(o) for o in np.concatenate(
        [[0], np.cumsum(planes)[:-1]]))
    return DistributedIndexPlan(
        transform_type=p0.transform_type, dim_x=p0.dim_x, dim_y=p0.dim_y,
        dim_z=p0.dim_z, shard_plans=shard_plans, num_planes=planes,
        plane_offsets=offsets)


def build_distributed_plan(transform_type: TransformType,
                           dim_x: int, dim_y: int, dim_z: int,
                           triplets_per_shard: Sequence[np.ndarray],
                           planes_per_shard: Sequence[int],
                           ) -> DistributedIndexPlan:
    """Build and validate the global distribution plan.
    ``triplets_per_shard[r]`` is shard r's sparse triplet list (a z-stick
    lives wholly on one shard); ``planes_per_shard[r]`` its slab height.
    Any distribution is allowed, empty shards included (reference
    tests/mpi_tests/test_transform.cpp:110-165)."""
    transform_type = TransformType(transform_type)
    # the slab heights are refused before any triplet, as in the JAX
    # package
    _check_planes(len(triplets_per_shard), planes_per_shard, dim_z)
    return distributed_index_plan(
        [build_index_plan(transform_type, dim_x, dim_y, dim_z,
                          np.asarray(t).reshape(-1, 3))
         for t in triplets_per_shard], planes_per_shard)


def _check_out_of_slice(precision, exchange, overlap_chunks,
                        wire_precision, wire_error_budget) -> None:
    """The typed refusals of what this slice does not run."""
    real_dtype(precision)
    if exchange.compact or exchange == ExchangeType.UNBUFFERED:
        raise _not_in_slice(f"the {exchange.value} exchange",
                            "compact, ring and overlap exchange")
    if exchange.float_wire:
        raise _not_in_slice(f"the {exchange.value} exchange", "wire-ladder")
    if overlap_chunks is not None:
        if int(overlap_chunks) < 1:
            raise InvalidParameterError(
                f"overlap_chunks must be >= 1, got {overlap_chunks}")
        if int(overlap_chunks) > 1:
            raise _not_in_slice(f"overlap_chunks={overlap_chunks}",
                                "compact, ring and overlap exchange")
    if wire_precision is not None:
        if not 0 <= int(wire_precision) <= 3:
            raise InvalidParameterError(
                f"wire_precision must be in [0, 3], got {wire_precision}")
        if int(wire_precision) > 0:
            raise _not_in_slice(f"wire_precision={wire_precision}",
                                "wire-ladder")
    if wire_error_budget is not None:
        raise _not_in_slice("wire_error_budget", "wire-ladder")


def _shard_rows(sticks: torch.Tensor) -> torch.Tensor:
    """Contiguous sticks ``(B, S, max_sticks, dim_z)`` as the gather's
    ``(S, B, max_sticks * dim_z)`` view."""
    b, s = sticks.shape[:2]
    return sticks.view(b, s, -1).transpose(0, 1)


class DistributedTransformPlan:
    """A distributed sparse 3D FFT over the S shards of a mesh —
    a distributed reference ``Transform`` (transform.hpp:56-227 with an
    MPI communicator). ``fused=False`` takes the two-kernel z stage."""

    def __init__(self, dist_plan: DistributedIndexPlan,
                 mesh: Optional[Mesh] = None, precision: str = "single",
                 exchange: ExchangeType = ExchangeType.DEFAULT,
                 overlap_chunks: Optional[int] = None,
                 wire_precision: Optional[int] = None,
                 wire_error_budget: Optional[float] = None,
                 device=None, fused: bool = True):
        dp = dist_plan
        self.exchange = ExchangeType(exchange)
        _check_out_of_slice(precision, self.exchange, overlap_chunks,
                            wire_precision, wire_error_budget)
        if mesh is None:
            mesh = make_mesh(dp.num_shards, device)
        elif not isinstance(mesh, Mesh):
            raise InvalidParameterError(
                f"mesh must come from make_mesh, got {type(mesh).__name__}")
        elif device is not None and resolve_device(device) != mesh.device:
            raise InvalidParameterError(
                f"device {device} differs from the mesh's {mesh.device}")
        if mesh.num_shards != dp.num_shards:
            raise InvalidParameterError(
                f"mesh has {mesh.num_shards} shards but plan has "
                f"{dp.num_shards} shards")
        self.dist_plan = dp
        self.precision = precision
        #: the torch real type of every tensor the plan computes on
        self.real_dtype = torch_real_dtype(precision)
        self._np_real = real_dtype(precision)
        self.mesh = mesh
        self.axis_name = mesh.axis_name
        self.device = mesh.device
        #: why the fused z kernels decline this plan's z axis, or None
        self._fused_reason = fused_kernel.eligible_dim(dp.dim_z) \
            if fused else None
        self._fused = bool(fused) and self._fused_reason is None
        self._r2c = dp.hermitian
        self._init_split_x()
        self._build_tables()
        self._init_device_tables()
        # comm-size-1 collapse (reference grid_internal.cpp:182)
        self._local1 = None
        if dp.num_shards == 1 \
                and dp.shard_plans[0].num_values < PAIR_IO_THRESHOLD:
            self._local1 = TransformPlan(dp.shard_plans[0],
                                         precision=precision,
                                         device=self.device,
                                         fused=self._fused)

    # -- static tables (the JAX package's, entry for entry) ------------------
    def _init_split_x(self) -> None:
        """The global split-x window: when the union of every shard's
        occupied x columns spans at most 70 % of the x extent, every
        shard's plane grid and both unpack layouts shrink to it (cyclic
        for C2C, linear in the half spectrum for R2C)."""
        dp = self.dist_plan
        self._split_x = None
        self._xf_eff = dp.dim_x_freq
        cols = [p.scatter_cols for p in dp.shard_plans if p.num_sticks]
        if not cols:
            return
        xs = np.concatenate(cols) % dp.dim_x_freq
        x0, w = occupied_x_window(xs, dp.dim_x_freq,
                                  allow_wrap=not dp.hermitian)
        if w > 0.7 * dp.dim_x_freq:
            return
        self._split_x = (x0, w)
        self._xf_eff = w

    def _sub_cols(self, cols: np.ndarray) -> np.ndarray:
        if self._split_x is None:
            return cols
        x0, w = self._split_x
        return window_sub_cols(cols, self.dist_plan.dim_x_freq, x0, w)

    def _build_tables(self) -> None:
        """Per-shard value, slot, column, plane and symmetry tables, as
        numpy, with the JAX package's layouts and sentinels."""
        dp = self.dist_plan
        S, ms, mp_, mv = (dp.num_shards, dp.max_sticks, dp.max_planes,
                          dp.max_values)
        dim_z = dp.dim_z
        vi = np.full((S, mv), ms * dim_z, np.int32)
        slot_src = np.full((S, ms * dim_z), mv, np.int32)
        cols = np.full((S, ms), dp.dim_y * self._xf_eff, np.int32)
        col_inv = np.full(dp.dim_y * self._xf_eff, S * ms, np.int32)
        onehot = np.zeros((S, ms), np.float32)
        for r, p in enumerate(dp.shard_plans):
            vi[r, :p.num_values] = p.value_indices
            slot_src[r, :p.num_sticks * dim_z] = \
                np.where(p.slot_src == p.num_values, mv, p.slot_src)
            cols[r, :p.num_sticks] = self._sub_cols(p.scatter_cols)
            col_inv[self._sub_cols(p.scatter_cols)] = \
                r * ms + np.arange(p.num_sticks)
            if p.zero_stick_id is not None:
                onehot[r, p.zero_stick_id] = 1.0
        zmap = np.full((S, mp_), dim_z, np.int32)
        z_src = np.empty(dim_z, np.int32)
        for r in range(S):
            n, off = dp.num_planes[r], dp.plane_offsets[r]
            zmap[r, :n] = off + np.arange(n)
            z_src[off:off + n] = r * mp_ + np.arange(n)
        self._has_conj = any(
            p.value_conj is not None and bool(p.value_conj.any())
            for p in dp.shard_plans)
        conj_mult = np.ones((S, mv if self._has_conj else 1, 2),
                            self._np_real)
        for r, p in enumerate(dp.shard_plans):
            if self._has_conj and p.value_conj is not None:
                conj_mult[r, :p.num_values, 1] = np.where(p.value_conj,
                                                          -1.0, 1.0)
        self._vi = vi
        self._slot_src = slot_src
        self._cols_flat = cols.reshape(-1)
        self._col_inv = col_inv
        self._zmap = zmap
        self._z_src = z_src
        self._onehot = onehot
        self._conj_mult = conj_mult

    def _init_device_tables(self) -> None:
        """The tables the pipeline reads, on the plan's device, and the
        DFT matrices (the split window's rows and columns for x)."""
        dp = self.dist_plan
        dev = self.device

        def idx(a, dtype=np.int64):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=dev)

        self._t_slot_src = idx(self._slot_src, np.int32)
        # the fused compress reads a CSR by stick, the gather the slots
        self._t_csr = [tuple(idx(a, np.int32) for a in
                             fused_kernel.compress_csr(
                                 p.value_indices, dp.max_sticks, dp.dim_z))
                       for p in dp.shard_plans] if self._fused else []
        # the gather's (fused=False): value_indices stacked (S,
        # max_values), padded with max_sticks * dim_z, the extent of a
        # shard's stick rows (read as 0, as slot_src's sentinel
        # max_values is), its rows 16 bytes apart (whole index loads)
        self._t_vi = None
        if not self._fused:
            mv = dp.max_values
            vi = np.full((dp.num_shards, -(-mv // 4) * 4),
                         dp.max_sticks * dp.dim_z, np.int32)
            vi[:, :mv] = self._vi
            self._t_vi = idx(vi, np.int32)[:, :mv]
        # each shard's (0,0) stick, -1 where another shard owns it
        self._zero_sticks = [int(np.argmax(row)) if self._r2c and row.any()
                             else -1 for row in self._onehot]
        self._t_zmap = idx(self._zmap)
        self._t_col_inv = idx(self._col_inv)
        self._t_cols = idx(self._cols_flat)
        self._t_z_src = idx(self._z_src)
        # folded values are stored conjugated: ±1 on the imaginary lane
        self._t_conj = (torch.as_tensor(self._conj_mult[:, None],
                                        device=dev)
                        if self._has_conj else None)

        rdt = self.real_dtype

        def c2c(n, sign, **window):
            return dft.device_c2c(n, sign, device=dev, dtype=rdt, **window)

        gs = 1.0 / float(self.global_size)
        self._mats = {
            "z_b": c2c(dp.dim_z, dft.BACKWARD),
            "z_f": c2c(dp.dim_z, dft.FORWARD),
            "z_fs": c2c(dp.dim_z, dft.FORWARD, scale=gs),
            "y_b": c2c(dp.dim_y, dft.BACKWARD),
            "y_f": c2c(dp.dim_y, dft.FORWARD),
        }
        x0, w = self._split_x or (0, dp.dim_x_freq)
        if self._r2c:
            self._mats["x_b"] = dft.device_c2r(dp.dim_x, rows=(x0, w),
                                               device=dev, dtype=rdt)
            self._mats["x_f"] = dft.device_r2c(dp.dim_x, cols=(x0, w),
                                               device=dev, dtype=rdt)
        else:
            self._mats["x_b"] = c2c(dp.dim_x, dft.BACKWARD, rows=(x0, w))
            self._mats["x_f"] = c2c(dp.dim_x, dft.FORWARD, cols=(x0, w))
        # plane symmetry applies when the window starts at x = 0
        self._complete_x0 = self._r2c and x0 == 0

    def _device_tables(self) -> list:
        ts = [self._t_slot_src, self._t_zmap, self._t_col_inv, self._t_cols,
              self._t_z_src]
        ts += [a for t in self._t_csr for a in t]
        ts += [] if self._t_vi is None else [self._t_vi]
        ts += [] if self._t_conj is None else [self._t_conj]
        ts += [t for m in self._mats.values() for t in m.tensors]
        return ts

    # -- the pipeline, on stacked planar operands (B, S, ...) ----------------
    def _z_backward(self, v: torch.Tensor):
        """Values ``(S, B, max_values, 2)`` -> z-transformed planar
        sticks, each ``(B, S, max_sticks, dim_z)``: per shard, the fused
        kernel; or the gather kernel over all shards, then one
        ``pdft_last``."""
        dp = self.dist_plan
        if self._t_conj is not None:
            v = v * self._t_conj
        b = v.shape[1]
        shape = (b, dp.num_shards, dp.max_sticks, dp.dim_z)
        sr = torch.empty(shape, dtype=self.real_dtype, device=self.device)
        si = torch.empty_like(sr)
        z = self._mats["z_b"]
        if self._fused:
            for r, zid in enumerate(self._zero_sticks):
                sr[:, r], si[:, r] = fused_kernel.decompress_zdft(
                    v[r], self._t_slot_src[r], z, dp.dim_z, False, zid)
            return sr, si
        gather_kernel.gather((v[..., 0], v[..., 1]), self._t_slot_src,
                             (_shard_rows(sr), _shard_rows(si)))
        for r, zid in enumerate(self._zero_sticks):
            if zid >= 0:
                sr[:, r, zid], si[:, r, zid] = \
                    stages.complete_stick_hermitian(sr[:, r, zid],
                                                    si[:, r, zid])
        return dft_kernel.pdft_last(sr, si, z)

    def _exchange_steps(self, forward: bool = False) -> tuple:
        """The block exchange of one direction as its three steps, ``(name,
        function)`` pairs, each function taking the previous one's output
        (:meth:`_exchange` runs them on the real and imaginary planes):
        backward, sticks ``(B, S, max_sticks, dim_z)`` -> plane grid ``(B,
        S, max_planes, dim_y, x)``; forward, the reverse."""
        dp = self.dist_plan
        if forward:
            return (("pack", lambda t: pack_space_to_blocks(
                        t, self._t_cols, dp.num_shards, dp.max_sticks)),
                    ("transpose", all_to_all_blocks),
                    ("unpack", lambda t: unpack_blocks_to_sticks(
                        t, self._t_z_src)))
        return (("pack", lambda t: pack_freq_to_blocks(t, self._t_zmap)),
                ("transpose", all_to_all_blocks),
                ("unpack", lambda t: unpack_blocks_to_grid(
                    t, self._t_col_inv, dp.dim_y, self._xf_eff)))

    def _exchange(self, planes: tuple, forward: bool = False) -> tuple:
        """Sticks -> plane grid (backward) or plane grid -> sticks
        (``forward``), each of the planar pair through
        :meth:`_exchange_steps`."""
        out = []
        for t in planes:
            for _, step in self._exchange_steps(forward):
                t = step(t)
            out.append(t)
        return tuple(out)

    def _xy_backward(self, grid: tuple):
        """Plane grid ``(B, S, max_planes, dim_y, x)`` -> planar space
        ``(B, S, max_planes, dim_y, dim_x)``: ``(xr, xi)`` for C2C, the
        real slab for R2C."""
        dp = self.dist_plan
        gr, gi = grid
        shape = tuple(gr.shape[:3]) + (dp.dim_y, dp.dim_x)
        planes = (-1, dp.dim_y, self._xf_eff)
        gr, gi = gr.view(planes), gi.view(planes)
        m = self._mats
        if self._r2c:
            if self._complete_x0:
                stages.complete_plane_hermitian(gr, gi)
            return stages.xy_backward_r2c(gr, gi, m["y_b"],
                                          m["x_b"]).view(shape)
        if self._split_x is None:
            xr, xi = stages.xy_backward_c2c(gr, gi, m["x_b"], m["y_b"])
        else:
            xr, xi = stages.xy_backward_c2c_split(gr, gi, m["y_b"], m["x_b"])
        return xr.view(shape), xi.view(shape)

    def _xy_forward(self, space) -> tuple:
        """Planar space (as :meth:`_xy_backward` returns it; contiguous)
        -> the plane grid ``(B, S, max_planes, dim_y, x)``."""
        dp = self.dist_plan
        m = self._mats
        planes = (-1, dp.dim_y, dp.dim_x)
        if self._r2c:
            b = space.shape[0]
            gr, gi = stages.xy_forward_r2c(space.view(planes), m["x_f"],
                                           m["y_f"])
        else:
            b = space[0].shape[0]
            xr, xi = space[0].view(planes), space[1].view(planes)
            if self._split_x is None:
                gr, gi = stages.xy_forward_c2c(xr, xi, m["x_f"], m["y_f"])
            else:
                gr, gi = stages.xy_forward_c2c_split(xr, xi, m["x_f"],
                                                     m["y_f"])
        grid = (b, dp.num_shards, dp.max_planes, dp.dim_y, self._xf_eff)
        return gr.view(grid), gi.view(grid)

    def _z_forward(self, sticks: tuple, scaled: bool) -> torch.Tensor:
        """Planar sticks ``(B, S, max_sticks, dim_z)`` -> values ``(S, B,
        max_values, 2)``, FULL scaling folded into the z matrix: per
        shard, the fused kernel; or one ``pdft_last`` for all, then the
        gather kernel over all shards, which writes every value slot (a
        shard's padding as 0)."""
        dp = self.dist_plan
        sr, si = sticks
        b = sr.shape[0]
        m = self._mats
        z = m["z_fs" if scaled else "z_f"]
        shape = (dp.num_shards, b, dp.max_values, 2)
        if self._fused:
            out = torch.zeros(shape, dtype=self.real_dtype,
                              device=self.device)
            for r, p in enumerate(dp.shard_plans):
                out[r, :, :p.num_values] = fused_kernel.zdft_compress(
                    sr[:, r].contiguous(), si[:, r].contiguous(), z,
                    self._t_csr[r])
        else:
            sr, si = dft_kernel.pdft_last(sr, si, z)
            out = torch.empty(shape, dtype=self.real_dtype,
                              device=self.device)
            gather_kernel.gather((_shard_rows(sr), _shard_rows(si)),
                                 self._t_vi, (out[..., 0], out[..., 1]))
        return out if self._t_conj is None else out.mul_(self._t_conj)

    def _bwd_space(self, v: torch.Tensor):
        """Values ``(S, B, max_values, 2)`` -> planar space ``(B, S,
        max_planes, dim_y, dim_x)``."""
        return self._xy_backward(self._exchange(self._z_backward(v)))

    def _fwd_values(self, space, scaled: bool) -> torch.Tensor:
        """Planar space (as :meth:`_bwd_space` returns it) -> values
        ``(S, B, max_values, 2)``."""
        return self._z_forward(self._exchange(self._xy_forward(space),
                                              forward=True), scaled)

    def _public_space(self, space) -> torch.Tensor:
        """Planar ``(B, S, ...)`` -> the public ``(S, B, max_planes,
        dim_y, dim_x)`` layout, interleaved ``(..., 2)`` for C2C."""
        if self._r2c:
            return space.transpose(0, 1).contiguous()
        xr, xi = space
        out = torch.empty((xr.shape[1], xr.shape[0]) + tuple(xr.shape[2:])
                          + (2,), dtype=self.real_dtype, device=self.device)
        out[..., 0] = xr.transpose(0, 1)
        out[..., 1] = xi.transpose(0, 1)
        return out

    def _planar_space(self, space: torch.Tensor):
        """A coerced public ``(S, B, ...)`` space -> the planar operands
        of :meth:`_fwd_values`."""
        t = space.transpose(0, 1)
        if self._r2c:
            return t.contiguous()
        return t[..., 0].contiguous(), t[..., 1].contiguous()

    # -- getters (reference transform.hpp:91-171) ----------------------------
    @property
    def transform_type(self) -> TransformType:
        return self.dist_plan.transform_type

    @property
    def dim_x(self) -> int:
        return self.dist_plan.dim_x

    @property
    def dim_y(self) -> int:
        return self.dist_plan.dim_y

    @property
    def dim_z(self) -> int:
        return self.dist_plan.dim_z

    @property
    def global_size(self) -> int:
        return self.dim_x * self.dim_y * self.dim_z

    @property
    def num_global_elements(self) -> int:
        return self.dist_plan.num_global_elements

    def local_z_length(self, shard: int) -> int:
        return self.dist_plan.num_planes[shard]

    def local_z_offset(self, shard: int) -> int:
        return self.dist_plan.plane_offsets[shard]

    def local_slice_size(self, shard: int) -> int:
        return self.dim_x * self.dim_y * self.local_z_length(shard)

    def num_local_elements(self, shard: int) -> int:
        return self.dist_plan.shard_plans[shard].num_values

    @property
    def split_x(self):
        """The global occupied x window ``(x0, w)`` the xy stage runs on,
        or None for the full x extent."""
        return self._split_x

    @property
    def fused_dist_active(self) -> bool:
        """True when both z stages run the fused kernels."""
        return self._fused

    @property
    def fused_dist_bwd_active(self) -> bool:
        return self._fused

    @property
    def fused_dist_fwd_active(self) -> bool:
        return self._fused

    @property
    def fused_dist_fallback_reason(self) -> Optional[str]:
        """Why the fused backward z stage is not running:
        ``"dimz_over_cap"`` where ``fused=True`` was asked for and dim_z
        exceeds ``ops.fused_kernel.MAX_DIM_Z`` (the plan then takes the
        two-kernel route), else None (the CUDA kernels take every shard's
        shape, and otherwise the two-kernel route is the caller's
        choice)."""
        return self._fused_reason

    @property
    def fused_dist_fwd_fallback_reason(self) -> Optional[str]:
        return self._fused_reason

    @property
    def _wire_elem_bytes(self) -> int:
        """Bytes of one complex element on the wire: 8 (complex64) for a
        single plan, 16 (complex128) for a double one."""
        return 2 * self.real_dtype.itemsize

    def exchange_wire_bytes(self, forward: bool = False) -> int:
        """Total off-shard bytes of ONE exchange, summed over shards: the
        padded block layout ships ``S * (S - 1) * max_sticks *
        max_planes`` complex elements of the plan's precision whatever
        the distribution, in both directions."""
        dp = self.dist_plan
        return (dp.num_shards * (dp.num_shards - 1) * dp.max_sticks
                * dp.max_planes * self._wire_elem_bytes)

    def exchange_busiest_link_bytes(self, forward: bool = False) -> int:
        """Max over shards of the off-shard bytes one shard sends (or
        receives) in ONE exchange of the padded block layout."""
        dp = self.dist_plan
        return ((dp.num_shards - 1) * dp.max_sticks * dp.max_planes
                * self._wire_elem_bytes)

    def estimated_device_bytes(self) -> int:
        """Bytes of the tables and matrices the plan keeps on its device
        for its lifetime."""
        return sum(t.numel() * t.element_size()
                   for t in self._device_tables())

    # -- data movement helpers -----------------------------------------------
    def shard_values(self, values_per_shard: Sequence) -> torch.Tensor:
        """Per-shard value arrays -> the padded ``(S, max_values, 2)``
        tensor of the plan's real type on its device."""
        dp = self.dist_plan
        if len(values_per_shard) != dp.num_shards:
            raise InvalidParameterError("one value array per shard required")
        out = np.zeros((dp.num_shards, dp.max_values, 2), self._np_real)
        for r, v in enumerate(values_per_shard):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            il = as_interleaved(v, self.precision)
            if il.shape != (dp.shard_plans[r].num_values, 2):
                raise InvalidParameterError(
                    f"shard {r}: expected {dp.shard_plans[r].num_values} "
                    f"values, got {il.shape[:-1]}")
            out[r, :il.shape[0]] = il
        return torch.as_tensor(out, device=self.device)

    def unshard_values(self, values) -> list:
        """Padded ``(S, max_values, 2)`` values -> per-shard numpy complex
        arrays."""
        dp = self.dist_plan
        arr = np.asarray(values.detach().cpu() if isinstance(
            values, torch.Tensor) else values)
        return [arr[r, :p.num_values, 0] + 1j * arr[r, :p.num_values, 1]
                for r, p in enumerate(dp.shard_plans)]

    def _slab_shape(self) -> tuple:
        dp = self.dist_plan
        shape = (dp.max_planes, dp.dim_y, dp.dim_x)
        return shape if self._r2c else shape + (2,)

    def shard_space(self, slabs: Sequence) -> torch.Tensor:
        """Per-shard space-domain slabs -> the padded ``(S, max_planes,
        dim_y, dim_x[, 2])`` tensor of the plan's real type on its
        device."""
        dp = self.dist_plan
        if len(slabs) != dp.num_shards:
            raise InvalidParameterError("one slab per shard required")
        out = np.zeros((dp.num_shards,) + self._slab_shape(), self._np_real)
        for r, slab in enumerate(slabs):
            if isinstance(slab, torch.Tensor):
                slab = slab.detach().cpu().numpy()
            n = dp.num_planes[r]
            expect = (n, dp.dim_y, dp.dim_x)
            if self._r2c:
                if np.iscomplexobj(slab) or np.shape(slab) != expect:
                    raise InvalidParameterError(
                        f"shard {r}: expected real slab {expect}, got "
                        f"{np.shape(slab)}")
                arr = np.asarray(slab, self._np_real)
            else:
                arr = as_interleaved(slab, self.precision)
                if arr.shape != expect + (2,):
                    raise InvalidParameterError(
                        f"shard {r}: expected complex slab {expect}, got "
                        f"{arr.shape[:-1]}")
            out[r, :n] = arr
        return torch.as_tensor(out, device=self.device)

    def unshard_space(self, space) -> list:
        """Padded space -> per-shard numpy slabs (complex for C2C, real
        for R2C), trimmed to each shard's slab height."""
        dp = self.dist_plan
        arr = np.asarray(space.detach().cpu() if isinstance(
            space, torch.Tensor) else space)
        out = []
        for r in range(dp.num_shards):
            slab = arr[r, :dp.num_planes[r]]
            out.append(slab if self._r2c else slab[..., 0] + 1j * slab[..., 1])
        return out

    def _tensor(self, t: torch.Tensor, shape: tuple, what: str):
        """A caller's tensor -> contiguous tensor of the plan's real type
        and ``shape`` on its device (complex tensors as interleaved
        pairs)."""
        t = t.to(self.device)
        if t.is_complex():
            t = torch.view_as_real(t)
        if tuple(t.shape) != shape:
            raise InvalidParameterError(
                f"expected {what} of shape {shape}, got {tuple(t.shape)}")
        return t.to(self.real_dtype).contiguous()

    def _values(self, values) -> torch.Tensor:
        """Values as ``(S, max_values, 2)`` on the device: a tensor as it
        is, anything else through :meth:`shard_values`."""
        dp = self.dist_plan
        if isinstance(values, torch.Tensor):
            return self._tensor(values, (dp.num_shards, dp.max_values, 2),
                                "stacked values")
        return self.shard_values(values)

    def _space(self, space) -> torch.Tensor:
        if isinstance(space, torch.Tensor):
            if self._r2c and space.is_complex():
                raise InvalidParameterError(
                    "expected a real space-domain slab, got a complex one")
            return self._tensor(space, (self.dist_plan.num_shards,)
                                + self._slab_shape(), "stacked space")
        return self.shard_space(space)

    # -- execution ------------------------------------------------------------
    def backward(self, values) -> torch.Tensor:
        """Frequency -> space over the shards. ``values``: a per-shard
        list or the padded ``(S, max_values, 2)`` tensor. Returns the
        padded ``(S, max_planes, dim_y, dim_x[, 2])`` space on the plan's
        device (the unnormalised inverse DFT)."""
        v = self._values(values)
        with timed_transform("backward") as box:
            if self._local1 is not None:
                box.value = self._local1.backward(v[0])[None]
            else:
                box.value = self._public_space(
                    self._bwd_space(v[:, None]))[:, 0]
        return box.value

    def forward(self, space, scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """Space -> frequency over the shards. ``space``: a per-shard slab
        list or the padded space tensor. Returns the padded ``(S,
        max_values, 2)`` values; ``Scaling.FULL`` multiplies by
        1/(Nx·Ny·Nz). Rows past a shard's slab height are ignored."""
        scaling = Scaling(scaling)
        sp = self._space(space)
        with timed_transform("forward") as box:
            if self._local1 is not None:
                box.value = self._local1.forward(sp[0], scaling)[None]
            else:
                box.value = self._fwd_values(
                    self._planar_space(sp[:, None]),
                    scaling is Scaling.FULL)[:, 0]
        return box.value

    # -- batched execution ----------------------------------------------------
    def shard_values_batch(self, values_batch: Sequence) -> torch.Tensor:
        """B value sets (each a per-shard list or a padded ``(S,
        max_values, 2)`` tensor) -> one ``(S, B, max_values, 2)``
        tensor."""
        if len(values_batch) == 0:
            raise InvalidParameterError("a batch needs at least one row")
        return torch.stack([self._values(v) for v in values_batch], dim=1)

    def unshard_values_batch(self, values) -> list:
        """``(S, B, max_values, 2)`` -> B per-shard lists of numpy complex
        values."""
        return [self.unshard_values(values[:, b])
                for b in range(values.shape[1])]

    def backward_batched(self, values_batch) -> torch.Tensor:
        """Backward-execute B transforms over this plan at once:
        ``values_batch`` is ``(S, B, max_values, 2)`` or a sequence of B
        value sets. Returns ``(S, B, max_planes, ...)``, each band equal
        to :meth:`backward` of its values, with the launches of one
        single call."""
        dp = self.dist_plan
        if isinstance(values_batch, torch.Tensor) and values_batch.dim() == 4:
            v = self._tensor(values_batch, (dp.num_shards,
                                            values_batch.shape[1],
                                            dp.max_values, 2),
                             "stacked values batch")
        else:
            v = self.shard_values_batch(values_batch)
        with timed_transform("backward_batched") as box:
            if self._local1 is not None:
                box.value = self._local1.backward_batched(v[0])[None]
            else:
                box.value = self._public_space(self._bwd_space(v))
        return box.value

    def forward_batched(self, space_batch,
                        scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """Forward-execute a batch: ``space_batch`` is ``(S, B,
        max_planes, ...)`` or a sequence of B per-shard slab lists or
        padded space tensors. Returns ``(S, B, max_values, 2)``."""
        scaling = Scaling(scaling)
        nd = len(self._slab_shape()) + 2
        if isinstance(space_batch, torch.Tensor) and space_batch.dim() == nd:
            sp = self._tensor(space_batch, (self.dist_plan.num_shards,
                                            space_batch.shape[1])
                              + self._slab_shape(), "stacked space batch")
        else:
            if len(space_batch) == 0:
                raise InvalidParameterError("a batch needs at least one row")
            sp = torch.stack([self._space(s) for s in space_batch], dim=1)
        with timed_transform("forward_batched") as box:
            if self._local1 is not None:
                box.value = self._local1.forward_batched(sp[0], scaling)[None]
            else:
                box.value = self._fwd_values(self._planar_space(sp),
                                             scaling is Scaling.FULL)
        return box.value

    def coalesce_backward(self, values_list: Sequence) -> list:
        """N requests' value sets through one batched call, demuxed: a
        list of N ``(S, max_planes, ...)`` spaces, each equal to
        :meth:`backward` of its values."""
        if len(values_list) == 1:
            return [self.backward(values_list[0])]
        return list(self.backward_batched(values_list).unbind(1))

    def coalesce_forward(self, space_list: Sequence,
                         scaling: Scaling = Scaling.NONE) -> list:
        """Forward twin of :meth:`coalesce_backward`."""
        if len(space_list) == 1:
            return [self.forward(space_list[0], scaling)]
        return list(self.forward_batched(space_list, scaling).unbind(1))

    # -- the round trip -------------------------------------------------------
    def _local1_fn(self, fn):
        """The stacked pointwise contract on the local delegate: ``fn``
        sees ``(1, ...)``, the delegate hands it the bare slab."""
        if fn is None:
            return None
        return lambda s, *a: fn(s[None], *a)[0]

    def _pair(self, v: torch.Tensor, fn, fn_args, scaled: bool):
        space = self._bwd_space(v[:, None])
        if fn is not None:
            out = fn(self._public_space(space)[:, 0], *fn_args)
            space = self._planar_space(self._space(out)[:, None])
        return self._fwd_values(space, scaled)[:, 0]

    def apply_pointwise(self, values, fn=None, *fn_args,
                        scaling: Scaling = Scaling.NONE) -> torch.Tensor:
        """backward -> ``fn(space, *fn_args)`` -> forward. ``fn`` sees the
        padded stacked space ``(S, max_planes, dim_y, dim_x[, 2])`` (the
        JAX package hands each shard its ``(1, ...)`` block; an
        elementwise ``fn`` computes the same) and returns that shape;
        rows past a shard's slab height are ignored. ``fn_args`` are
        stacked like the space (a potential as padded slabs).
        ``fn=None`` is the identity round trip. Returns the padded
        values."""
        scaling = Scaling(scaling)
        v = self._values(values)
        with timed_transform("apply_pointwise") as box:
            if self._local1 is not None:
                box.value = self._local1.apply_pointwise(
                    v[0], self._local1_fn(fn), *fn_args,
                    scaling=scaling)[None]
            else:
                box.value = self._pair(v, fn, fn_args,
                                       scaling is Scaling.FULL)
        return box.value

    def iterate_pointwise(self, values, fn, *fn_args, steps: int,
                          scaling: Scaling = Scaling.FULL) -> torch.Tensor:
        """``steps`` round trips as :meth:`apply_pointwise` runs one;
        ``scaling`` defaults to FULL, a fixed-point map. Returns the final
        padded values."""
        scaling = Scaling(scaling)
        if int(steps) < 0:
            raise InvalidParameterError(f"steps must be >= 0, got {steps}")
        v = self._values(values)
        with timed_transform("iterate_pointwise") as box:
            if self._local1 is not None:
                box.value = self._local1.iterate_pointwise(
                    v[0], self._local1_fn(fn), *fn_args, steps=steps,
                    scaling=scaling)[None]
            else:
                for _ in range(int(steps)):
                    v = self._pair(v, fn, fn_args, scaling is Scaling.FULL)
                box.value = v
        return box.value


def make_distributed_plan(transform_type: TransformType,
                          dim_x: int, dim_y: int, dim_z: int,
                          triplets_per_shard: Sequence[np.ndarray],
                          planes_per_shard: Sequence[int],
                          mesh: Optional[Mesh] = None,
                          precision: str = "single",
                          exchange: ExchangeType = ExchangeType.DEFAULT,
                          overlap_chunks: Optional[int] = None,
                          wire_precision: Optional[int] = None,
                          wire_error_budget: Optional[float] = None,
                          device=None, fused: bool = True,
                          ) -> DistributedTransformPlan:
    """Plan a distributed transform in one call (the distributed analogue
    of ``Grid::create_transform``, reference grid.hpp:138-141), on
    ``mesh`` or, without one, on ``make_mesh(len(triplets_per_shard),
    device)``: the card by default, ``device="cpu"`` for the plain
    PyTorch versions."""
    dist = build_distributed_plan(transform_type, dim_x, dim_y, dim_z,
                                  triplets_per_shard, planes_per_shard)
    return DistributedTransformPlan(
        dist, mesh=mesh, precision=precision, exchange=exchange,
        overlap_chunks=overlap_chunks, wire_precision=wire_precision,
        wire_error_budget=wire_error_budget, device=device, fused=fused)
