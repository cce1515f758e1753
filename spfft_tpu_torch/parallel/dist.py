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

A process holds L of the S shards (see :mod:`.mesh`): all S on one
device without a process group, or L = S / P on each of the P ranks of
one, rank r the shards ``[r * L, (r + 1) * L)``; its callers pass and get
those shards' values and slabs only (the JAX package's callers pass
global arrays), in the JAX package's stacked layouts:

* frequency values ``(L, max_values, 2)`` interleaved, shard r's values
  first, zero-padded;
* space ``(L, max_planes, dim_y, dim_x[, 2])``: shard r's slab is rows
  ``[0, num_planes(r))`` of its block (zero-padded after), global z
  ``plane_offsets(r) + p``.

Batched calls put the batch second: ``(L, B, ...)``. Every table is the
global plan's (every rank builds the same one, :mod:`.multihost`), cut
to the rank's own shards where it is per shard.

What runs on the card, per pair:

* the z stage once per shard on that shard's own tables: the fused
  ``decompress_zdft`` / ``zdft_compress`` kernels (its ``slot_src`` row,
  sentinel ``max_values``; its CSR over ``max_sticks`` sticks; its (0,0)
  stick, or -1 where another shard owns it) — L launches of each; or,
  with ``fused=False``, the gather kernel once in each direction over
  the L shards' stacked tables and one ``pdft_last`` over their sticks;
* the exchange (:mod:`.exchange`), selected as the JAX package selects
  it: the padded block exchange (tensor gathers and one transposing copy;
  ``UNBUFFERED`` S − 1 hop copies of the ring), the one-collective ragged
  schedule of ``COMPACT_BUFFERED`` (at S > 1; three gather-kernel
  launches a direction: pack, the emulated collective, unpack) or the
  exact-size op schedule (``SPFFT_TPU_COMPACT_PPERMUTE=1``, and at S =
  1); ``overlap_chunks`` K > 1 splits it into K chunks, each packed and
  moved early, unpacked once, late; the wire ladder's rung (float32,
  bfloat16 casts, or int8 through ``csrc/wire.cu``) wraps each move.
  Over ranks each move is a collective of the group (``exchange_kind``
  ``all_to_all``, ``p2p_ring``, ``all_to_all_v`` — its gathers two a
  direction, the pack in rank order and the unpack — or ``p2p_ops``),
  the payload in the wire's dtype; a backend that refuses the
  collective on the plan's device is refused at construction
  (``DistributedError``);
* the xy stage once over all ``L * max_planes`` planes (the planes are
  independent): C2C one ``pdft2_swapped`` call (two launches) per
  direction; split-x C2C and R2C ``pdft_last`` for the y-DFT (and the
  split C2C x-DFT), R2C's real x-DFT one ``prdft_last`` /
  ``pirdft_last`` launch (the real FFT form of ``csrc/rfft.cu`` where
  dim_x is even with a 2^a 3^b 5^c 7^d 11^e half).

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

A plan of one shard in one process below ``PAIR_IO_THRESHOLD`` values
runs through the local :class:`~spfft_tpu_torch.plan.TransformPlan` (the
reference treats a size-1 communicator as local, grid_internal.cpp:182),
keeping the stacked API.

The knobs ``overlap_chunks``, ``wire_precision`` and
``wire_error_budget``: the caller's argument, else the environment
variable of the JAX package's name, else the process-global config's
knob (``control.config.global_config()``, whose defaults are 1, 0 and
0.01), as the JAX package resolves them (``dist.py:252``, ``:473-482``).

Faults and observability, at the JAX package's places: the int8 rung's
probe consults the ``exchange.quantize`` seam (a firing check declines
the rung, reason ``fault_injected``); the first call of each executable
the JAX package would compile consults ``exchange.pack``,
``exchange.collective`` and ``exchange.unpack`` (``exchange.chunk`` and
``exchange.pack`` per chunk with ``overlap_chunks`` K > 1) in the order
its traced body reaches them, on one device and over ranks alike;
construction records ``record_plan_build``, ``record_exchange_plan``
(wire and per-chunk bytes, the ``exchange.plan_build`` span, the
``spfft_wire_rung`` gauge), the ``wire.decline`` / ``wire.resolve``
events and each fused decline (``dist_fused_*`` stages).
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from .. import faults, obs
from ..control.config import global_config
from ..errors import (DistributedError, InvalidParameterError,
                      ParameterMismatchError)
from ..indexing import (build_index_plan, check_stick_duplicates,
                        occupied_x_window, window_sub_cols)
from ..ops import dft, dft_kernel, fused_kernel, gather_kernel, stages
from ..plan import PAIR_IO_THRESHOLD, TransformPlan, resolve_device
from ..timing import timed_transform
from ..types import ExchangeType, Scaling, TransformType
from ..utils.dtypes import as_interleaved, real_dtype, torch_real_dtype
from .exchange import (RANK_PRIMITIVES, RankComm, build_compact_schedule,
                       build_ragged_schedule, compact_exchange,
                       compose_unpack, dense, gather_planes, move_blocks,
                       pack_freq_to_blocks, pack_space_to_blocks,
                       ragged_exchange, rank_compact_move, rank_move_blocks,
                       rank_ragged_direction, rank_ragged_move,
                       rank_ragged_pack, rank_ragged_unpack,
                       unpack_blocks_to_grid, unpack_blocks_to_sticks)
from .mesh import Mesh, make_mesh
from .overlap import build_overlap_schedule

#: Environment default for the plan's ``overlap_chunks`` knob: split the
#: exchange into K destination-balanced chunks (:mod:`.overlap`); 1 is
#: the monolithic exchange.
OVERLAP_CHUNKS_ENV = "SPFFT_TPU_OVERLAP_CHUNKS"
#: The wire ladder: rung index == the ``wire_precision`` knob. Rung 0
#: ships the payload at transform precision; 1 / 2 cast it to float32 /
#: bfloat16 (the ``*_FLOAT`` exchanges take one rung down); 3 quantizes
#: it to int8 with a float32 absmax scale per (slot, quant row).
WIRE_RUNGS = ("full", "f32", "bf16", "int8")
WIRE_PRECISION_ENV = "SPFFT_TPU_WIRE_PRECISION"
WIRE_ERROR_BUDGET_ENV = "SPFFT_TPU_WIRE_ERROR_BUDGET"
#: ``"1"`` selects the exact-size op schedule for ``COMPACT_BUFFERED``
#: at S > 1 instead of the one-collective ragged schedule
COMPACT_PPERMUTE_ENV = "SPFFT_TPU_COMPACT_PPERMUTE"
#: the torch dtype each rung casts the planes to on the wire
_WIRE_DTYPES = {0: None, 1: torch.float32, 2: torch.bfloat16,
                3: torch.int8}


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
        t0 = time.perf_counter()
        dp = dist_plan
        self.exchange = ExchangeType(exchange)
        real_dtype(precision)
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
        #: this process's shards: L of them from global shard ``_lo``
        self._lo, self._L = mesh.shard_range.start, mesh.local_shards
        self._local_plans = dp.shard_plans[self._lo:self._lo + self._L]
        #: the process group's view, None for S shards on one device
        self._comm = None if mesh.process_group is None else RankComm(
            mesh.process_group, mesh.num_processes, mesh.rank, self._L)
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
        if self._fused_reason is not None:
            for stage in ("dist_fused_decompress_zdft",
                          "dist_fused_zdft_compress"):
                obs.record_plan_fallback(stage, self._fused_reason)
        #: the executables (JAX's jit cache keys) whose seams have passed
        self._seam_keys = fused_kernel.SeamKeys()
        self._r2c = dp.hermitian
        self._init_split_x()
        self._select_exchange(overlap_chunks)
        self._check_backend()
        self._resolve_wire_rung(wire_precision, wire_error_budget)
        self._build_tables()
        self._init_device_tables()
        self._init_exchange_tables()
        # comm-size-1 collapse (reference grid_internal.cpp:182): one
        # shard in one process
        self._local1 = None
        #: ``fn`` -> its wrapper for the delegate, held weakly where ``fn``
        #: can be, and strongly where not (a builtin)
        self._local1_fns = weakref.WeakKeyDictionary()
        self._local1_builtin_fns = {}
        if dp.num_shards == 1 and mesh.num_processes == 1 \
                and dp.shard_plans[0].num_values < PAIR_IO_THRESHOLD:
            self._local1 = TransformPlan(dp.shard_plans[0],
                                         precision=precision,
                                         device=self.device,
                                         fused=self._fused)
        dt = time.perf_counter() - t0
        obs.record_plan_build(self, dt, t0)
        obs.record_exchange_plan(self, dt, t0)

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

    # -- the exchange mechanism and the wire ladder --------------------------
    def _select_exchange(self, overlap_chunks) -> None:
        """The JAX package's selection (``dist.py:221-320``):
        ``overlap_chunks`` clamped to ``[1, min(max_sticks,
        max_planes)]`` (1 on one shard); ``COMPACT_BUFFERED`` at S > 1
        the ragged schedule (K chunks of it where K > 1), or with
        ``SPFFT_TPU_COMPACT_PPERMUTE=1`` the op schedule (K chunks of
        it), at S = 1 always the op schedule; every other exchange the
        padded blocks, K > 1 chunked by rows; ``UNBUFFERED`` moves them
        by the ring. R2C plans build every schedule over the trimmed
        stick half; split-x plans over the occupied window."""
        dp = self.dist_plan
        if overlap_chunks is None:
            env = os.environ.get(OVERLAP_CHUNKS_ENV)
            overlap_chunks = int(env) if env \
                else int(global_config().overlap_chunks)
        if int(overlap_chunks) < 1:
            raise InvalidParameterError(
                f"overlap_chunks must be >= 1, got {overlap_chunks}")
        k = min(int(overlap_chunks), dp.max_sticks, dp.max_planes)
        if dp.num_shards == 1:
            k = 1  # one shard: no collective to chunk
        #: the exchange's chunks after clamping
        self.overlap_chunks = k
        self._compact = self._ragged = self._overlap = None
        ppermute = os.environ.get(COMPACT_PPERMUTE_ENV) == "1"
        xw = self._split_x
        if self.exchange.compact:
            if dp.num_shards > 1 and not ppermute:
                if k > 1:
                    self._overlap = build_overlap_schedule(
                        dp, k, "ragged", x_window=xw)
                else:
                    self._ragged = build_ragged_schedule(dp, x_window=xw)
            elif k > 1 and dp.num_shards > 1:
                self._overlap = build_overlap_schedule(dp, k, "compact",
                                                       x_window=xw)
            else:
                self._compact = build_compact_schedule(dp, x_window=xw)
        elif k > 1:
            self._overlap = build_overlap_schedule(dp, k, "block")
        self._ring = self.exchange == ExchangeType.UNBUFFERED

    def _base_kind(self) -> str:
        if self._ragged is not None:
            return "ragged"
        if self._compact is not None:
            return "compact"
        if self._overlap is not None and self._overlap.kind != "block":
            return self._overlap.kind
        return "ring" if self._ring else "block"

    #: the names of the mechanisms over the ranks of a process group
    RANK_KINDS = {"block": "all_to_all", "ragged": "all_to_all_v",
                  "ring": "p2p_ring", "compact": "p2p_ops"}

    @property
    def exchange_kind(self) -> str:
        """The mechanism the plan runs: on one device ``"block"`` (the
        transposing copy), ``"ring"``, ``"ragged"`` or ``"compact"``; over
        the ranks of a process group ``"all_to_all"``, ``"p2p_ring"``,
        ``"all_to_all_v"`` or ``"p2p_ops"``; with ``overlap_chunks`` K > 1
        its name and ``"xK"``."""
        kind = self._base_kind()
        if self._comm is not None:
            kind = self.RANK_KINDS[kind]
        return kind if self.overlap_chunks <= 1 \
            else f"{kind}x{self.overlap_chunks}"

    def _check_backend(self) -> None:
        """Refuse, at construction, an exchange whose collective the
        group's backend refuses on the plan's device: NCCL moves CUDA
        tensors only, and gloo's point-to-point sends read a CUDA tensor's
        device memory as host memory (the process aborts), so the ring and
        the op schedule between ranks on CUDA tensors need NCCL. Nothing
        is moved to the host behind the caller's back."""
        m = self.mesh
        if self._comm is None or self.dist_plan.num_shards == 1:
            return
        kind = self.RANK_KINDS[self._base_kind()]
        prim = RANK_PRIMITIVES[kind]
        backend = m.backend
        if backend == "nccl" and self.device.type != "cuda":
            raise DistributedError(
                f"the nccl backend refuses {prim} on {self.device} tensors "
                f"(exchange {kind}): NCCL moves CUDA tensors only")
        if backend == "gloo" and self.device.type == "cuda" \
                and prim == "batch_isend_irecv" and m.num_processes > 1:
            raise DistributedError(
                f"the gloo backend refuses {prim} on CUDA tensors (exchange "
                f"{kind}): its point-to-point transport cannot read device "
                f"memory; use nccl, a CPU mesh, or an all_to_all exchange "
                f"(BUFFERED, or COMPACT_BUFFERED's ragged schedule)")

    def _resolve_wire_rung(self, wire_precision, wire_error_budget) -> None:
        """The JAX package's rung resolution (``dist.py:460-542``): walk
        DOWN from the requested rung, declining int8 on the exact-count
        layouts (``"exact_count_layout"``: no room for its scales) and any
        rung whose measured probe error (:meth:`_probe_wire_error`)
        exceeds the budget (``"over_budget"``), until one fits; rung 0
        always does. The ``*_FLOAT`` exchanges request rung 1 (double) or
        2 (single). Sets ``wire_rung``, ``wire_rung_name``,
        ``wire_rung_requested``, ``wire_error_budget``,
        ``wire_probe_error`` and ``wire_declines`` (``(rung name,
        reason)`` pairs, the record of every decline). A firing
        ``exchange.quantize`` seam declines int8 with
        ``"fault_injected"``; each decline counts in
        ``spfft_wire_rung_declined_total{reason}`` with a ``wire.decline``
        event, and the outcome is a ``wire.resolve`` event."""
        if wire_precision is None:
            env = os.environ.get(WIRE_PRECISION_ENV)
            wire_precision = int(env) if env \
                else int(global_config().wire_precision)
        if wire_error_budget is None:
            env = os.environ.get(WIRE_ERROR_BUDGET_ENV)
            wire_error_budget = float(env) if env \
                else float(global_config().wire_error_budget)
        requested = int(wire_precision)
        if not 0 <= requested < len(WIRE_RUNGS):
            raise InvalidParameterError(
                f"wire_precision must be in [0, {len(WIRE_RUNGS) - 1}], "
                f"got {requested}")
        if float(wire_error_budget) <= 0:
            raise InvalidParameterError(
                f"wire_error_budget must be > 0, got {wire_error_budget}")
        if requested == 0 and self.exchange.float_wire:
            requested = 1 if self.precision == "double" else 2
        int8_ok = (self._compact is None and self._ragged is None
                   and (self._overlap is None
                        or self._overlap.kind == "block"))
        self.wire_rung_requested = requested
        self.wire_error_budget = float(wire_error_budget)
        declines = []
        rung = requested
        probe_err = 0.0
        while rung > 0:
            if rung == 3 and not int8_ok:
                reason = "exact_count_layout"
            else:
                try:
                    probe_err = self._probe_wire_error(rung)
                except faults.InjectedFault:
                    reason = "fault_injected"
                else:
                    if probe_err <= self.wire_error_budget:
                        break
                    reason = "over_budget"
            declines.append((WIRE_RUNGS[rung], reason))
            obs.GLOBAL_COUNTERS.inc("spfft_wire_rung_declined_total",
                                    reason=reason)
            obs.record_event("wire.decline", rung=WIRE_RUNGS[rung],
                             reason=reason)
            rung -= 1
        if rung == 0:
            probe_err = 0.0
        obs.record_event("wire.resolve", requested=WIRE_RUNGS[requested],
                         resolved=WIRE_RUNGS[rung],
                         probe_error=float(probe_err))
        self.wire_rung = rung
        self.wire_rung_name = WIRE_RUNGS[rung]
        self.wire_probe_error = float(probe_err)
        self.wire_declines = tuple(declines)
        self._wire = _WIRE_DTYPES[rung]

    def _probe_wire_error(self, rung: int) -> float:
        """The JAX package's probe (``dist.py:544-572``): the rel-l2
        round-trip error of ``rung`` on seeded gaussian stick rows with
        10^±6 magnitudes per row, against the payload at the plan's real
        type; the int8 rung's scale computation consults the
        ``exchange.quantize`` fault seam. The int8 twin is the JAX package's numpy one; bfloat16 is
        torch's conversion, which rounds float64 through float32 as the
        JAX package's does (a test holds the two equal)."""
        rng = np.random.default_rng(0x51F8)
        dp = self.dist_plan
        rows = int(min(max(dp.max_sticks, 1), 64))
        cols = int(min(max(dp.dim_z, 1), 64))
        mags = 10.0 ** rng.uniform(-6.0, 6.0, size=(rows, 1, 1))
        il = rng.standard_normal((rows, cols, 2)) * mags
        ref = il.astype(self._np_real).astype(np.float64)
        if rung == 3:
            faults.check_site("exchange.quantize")
            absmax = np.max(np.abs(ref), axis=(1, 2), keepdims=True)
            scale = np.where(absmax > 0, absmax / 127.0, 1.0)
            q = np.clip(np.rint(ref / scale), -127, 127).astype(np.int8)
            back = q.astype(np.float64) * scale
        else:
            wdt = torch.float32 if rung == 1 else torch.bfloat16
            back = torch.from_numpy(ref).to(wdt).to(torch.float64).numpy()
        denom = float(np.linalg.norm(ref))
        return float(np.linalg.norm(back - ref) / denom) if denom else 0.0

    def _init_exchange_tables(self) -> None:
        """The exact-count schedules' tables on the plan's device (int32,
        stacked ``(S, n)``, the JAX package's sentinels) and each op's
        shard pairs as index tensors; every tensor also in
        ``self._xtables`` (:meth:`estimated_device_bytes`)."""
        dev = self.device
        self._xtables = []

        def i32(a):
            t = torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                device=dev)
            self._xtables.append(t)
            return t

        def perms(ops, reverse):
            out = []
            for k, _, pairs in ops:
                if k == 0 or not pairs:
                    out.append(None)
                    continue
                src, dst = zip(*((d, j) if reverse else (j, d)
                                 for j, d in pairs))
                out.append(tuple(torch.tensor(x, device=dev)
                                 for x in (src, dst)))
            return out

        self._t_x = None
        if self._comm is not None:
            self._t_x = self._rank_tables(i32)
        elif self._ragged is not None:
            r = self._ragged
            self._t_x = {n: i32(getattr(r, n)) for n in (
                "bwd_pack", "fwd_pack", "emu_bwd", "emu_fwd", "bwd_unpack",
                "fwd_unpack")}
        elif self._compact is not None:
            c = self._compact
            self._t_x = {
                "bwd_pack": [i32(t) for t in c.bwd_pack],
                "fwd_pack": [i32(t) for t in c.fwd_pack],
                "bwd_unpack": i32(c.bwd_unpack),
                "fwd_unpack": i32(c.fwd_unpack),
                "bwd_perms": perms(c.ops, False),
                "fwd_perms": perms(c.ops, True)}
        elif self._overlap is not None and self._overlap.kind != "block":
            ov = self._overlap
            chunks = []
            for ch in ov.chunks:
                if ov.kind == "ragged":
                    chunks.append({n: i32(getattr(ch, n)) for n in (
                        "bwd_pack", "fwd_pack", "emu_bwd", "emu_fwd")})
                else:
                    chunks.append({
                        "bwd_pack": [i32(t) for t in ch.bwd_pack],
                        "fwd_pack": [i32(t) for t in ch.fwd_pack],
                        "bwd_perms": perms(ch.bwd_ops, False),
                        "fwd_perms": perms(ch.fwd_ops, False)})
            self._t_x = {"chunks": chunks,
                         "bwd_unpack": i32(ov.bwd_unpack),
                         "fwd_unpack": i32(ov.fwd_unpack)}

    def _rank_tables(self, i32) -> Optional[dict]:
        """The exact-count schedules' tables on this rank: the ragged
        schedule's composed send and unpack tables and split sizes
        (:class:`~.exchange.RankRagged`), the op schedule's pack and
        unpack rows of this rank's shards and each op's shard pairs in the
        direction of the move; per chunk with K > 1. None for the padded
        blocks."""
        dp = self.dist_plan
        lo, hi = self._lo, self._lo + self._L
        comm = self._comm
        grid_n = dp.max_planes * dp.dim_y * self._xf_eff

        def ragged(r, n_stick, n_grid):
            """Both directions of one ragged table set ``r``."""
            out = {}
            for d, offs, pack, n in (("bwd", r.bwd_offsets, r.bwd_pack,
                                      n_stick),
                                     ("fwd", r.fwd_offsets, r.fwd_pack,
                                      n_grid)):
                rr = rank_ragged_direction(offs[1], offs[0], offs[2], pack,
                                           r.recv_cap, n, comm.size,
                                           comm.rank)
                out[d] = (rr, i32(rr.send))
            return out

        def pairs(ops, reverse):
            return [None if k == 0 or not prs else
                    tuple((d, j) if reverse else (j, d) for j, d in prs)
                    for k, _, prs in ops]

        def rows(tables):
            return [i32(t[lo:hi]) for t in tables]

        if self._ragged is not None:
            t = ragged(self._ragged, dp.max_sticks * dp.dim_z, grid_n)
            for d in ("bwd", "fwd"):
                unpack = getattr(self._ragged, d + "_unpack")[lo:hi]
                t[d + "_unpack"] = i32(compose_unpack(
                    unpack, [t[d][0]], [self._ragged.recv_cap]))
            return t
        if self._compact is not None:
            c = self._compact
            return {"bwd_pack": rows(c.bwd_pack),
                    "fwd_pack": rows(c.fwd_pack),
                    "bwd_unpack": i32(c.bwd_unpack[lo:hi]),
                    "fwd_unpack": i32(c.fwd_unpack[lo:hi]),
                    "bwd_pairs": pairs(c.ops, False),
                    "fwd_pairs": pairs(c.ops, True)}
        ov = self._overlap
        if ov is None or ov.kind == "block":
            return None
        chunks = []
        for ch in ov.chunks:
            if ov.kind == "ragged":
                chunks.append(ragged(
                    ch, (ch.stick_hi - ch.stick_lo) * dp.dim_z,
                    (ch.plane_hi - ch.plane_lo) * dp.dim_y * self._xf_eff))
            else:
                chunks.append({"bwd_pack": rows(ch.bwd_pack),
                               "fwd_pack": rows(ch.fwd_pack),
                               "bwd_pairs": pairs(ch.bwd_ops, False),
                               "fwd_pairs": pairs(ch.fwd_ops, False)})
        t = {"chunks": chunks}
        for d in ("bwd", "fwd"):
            unpack = getattr(ov, d + "_unpack")[lo:hi]
            if ov.kind == "ragged":
                unpack = compose_unpack(
                    unpack, [c[d][0] for c in chunks],
                    [ch.recv_cap for ch in ov.chunks])
            t[d + "_unpack"] = i32(unpack)
        return t

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

        lo, hi = self._lo, self._lo + self._L
        self._t_slot_src = idx(self._slot_src[lo:hi], np.int32)
        # the fused compress reads a CSR by stick, the gather the slots
        self._t_csr = [tuple(idx(a, np.int32) for a in
                             fused_kernel.compress_csr(
                                 p.value_indices, dp.max_sticks, dp.dim_z))
                       for p in self._local_plans] if self._fused else []
        # the gather's (fused=False): value_indices stacked (S,
        # max_values), padded with max_sticks * dim_z, the extent of a
        # shard's stick rows (read as 0, as slot_src's sentinel
        # max_values is), its rows 16 bytes apart (whole index loads)
        self._t_vi = None
        if not self._fused:
            mv = dp.max_values
            vi = np.full((self._L, -(-mv // 4) * 4),
                         dp.max_sticks * dp.dim_z, np.int32)
            vi[:, :mv] = self._vi[lo:hi]
            self._t_vi = idx(vi, np.int32)[:, :mv]
        # each shard's (0,0) stick, -1 where another shard owns it
        self._zero_sticks = [int(np.argmax(row)) if self._r2c and row.any()
                             else -1 for row in self._onehot[lo:hi]]
        self._t_zmap = idx(self._zmap)
        self._t_col_inv = idx(self._col_inv)
        self._t_cols = idx(self._cols_flat)
        self._t_z_src = idx(self._z_src)
        # folded values are stored conjugated: ±1 on the imaginary lane
        self._t_conj = (torch.as_tensor(self._conj_mult[lo:hi, None],
                                        device=dev)
                        if self._has_conj else None)

        rdt = self.real_dtype

        def c2c(n, sign, **window):
            return dft.device_c2c(n, sign, device=dev, dtype=rdt, **window)

        gs = 1.0 / float(self.global_size)
        # the fused z kernels' form of dim_z, as the local plan's
        zf = fused_kernel.z_mats_form(dp.dim_z) if self._fused else None
        self._mats = {
            "z_b": c2c(dp.dim_z, dft.BACKWARD, form=zf),
            "z_f": c2c(dp.dim_z, dft.FORWARD, form=zf),
            "z_fs": c2c(dp.dim_z, dft.FORWARD, scale=gs, form=zf),
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
        shape = (b, self._L, dp.max_sticks, dp.dim_z)
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

    def _flat(self, planes: tuple) -> tuple:
        """A planar pair ``(B, S, ...)`` as ``(B, S, n)`` views (the
        gather kernel's source: sticks or a plane grid, flattened)."""
        return tuple(t.reshape(t.shape[0], t.shape[1], -1) for t in planes)

    def _shaped(self, planes: tuple, forward: bool) -> tuple:
        """The unpacked ``(B, S, n)`` pair as sticks ``(B, S,
        max_sticks, dim_z)`` (``forward``) or the plane grid ``(B, S,
        max_planes, dim_y, x)``."""
        dp = self.dist_plan
        tail = (dp.max_sticks, dp.dim_z) if forward \
            else (dp.max_planes, dp.dim_y, self._xf_eff)
        return tuple(t.view(tuple(t.shape[:2]) + tail) for t in planes)

    def _pack_blocks(self, planes: tuple, forward: bool) -> tuple:
        dp = self.dist_plan
        if forward:
            return tuple(pack_space_to_blocks(t, self._t_cols,
                                              dp.num_shards, dp.max_sticks)
                         for t in planes)
        return tuple(pack_freq_to_blocks(t, self._t_zmap) for t in planes)

    def _unpack_blocks(self, planes: tuple, forward: bool) -> tuple:
        dp = self.dist_plan
        if forward:
            return tuple(unpack_blocks_to_sticks(t, self._t_z_src)
                         for t in planes)
        return tuple(unpack_blocks_to_grid(t, self._t_col_inv, dp.dim_y,
                                           self._xf_eff) for t in planes)

    def _move_start(self, planes: tuple, forward: bool):
        """The padded blocks' move over ranks, issued: a
        :class:`~.exchange.Pending` of the received blocks."""
        return rank_move_blocks(planes, self._wire, 2 if forward else 1,
                                self.real_dtype, self._comm, ring=self._ring)

    def _move_blocks(self, planes: tuple, forward: bool) -> tuple:
        """The padded blocks' exchange on the plan's wire: int8 rows are
        sticks backward (quant axis 1), planes forward (2). On one shard
        there is no collective, and no wire (as in the JAX package)."""
        if self.dist_plan.num_shards == 1:
            return planes
        if self._comm is not None:
            return self._move_start(planes, forward).wait()
        return move_blocks(planes, self._wire, 2 if forward else 1,
                           self.real_dtype, ring=self._ring)

    def _exact_move(self, packed, tables: dict, forward: bool) -> tuple:
        """One exact-count move on one device: the ragged emulation
        gather, or the op schedule's moves."""
        d = "fwd" if forward else "bwd"
        if "emu_" + d in tables:
            return ragged_exchange(packed, tables["emu_" + d], self._wire,
                                   self.real_dtype)
        return compact_exchange(packed, tables[d + "_perms"], self._wire,
                                self.real_dtype)

    def _rank_move(self, packed, tables: dict, forward: bool, tag0: int = 0):
        """One exact-count move over ranks, issued (a
        :class:`~.exchange.Pending`): the ragged send buffer's
        ``all_to_all_single``, or the op schedule's
        ``batch_isend_irecv`` per op."""
        d = "fwd" if forward else "bwd"
        if d in tables:
            return rank_ragged_move(packed, tables[d][0], self._wire,
                                    self.real_dtype, self._comm)
        return rank_compact_move(packed, tables[d + "_pairs"], self._wire,
                                 self.real_dtype, self._comm, tag0)

    def _exact_pack(self, planes: tuple, tables: dict, forward: bool):
        """The pack gathers of an exact-count schedule: one table (the
        ragged send buffer; over ranks, in rank order, interleaved) or
        one per op."""
        d = "fwd" if forward else "bwd"
        flat = self._flat(planes)
        if d in tables:
            return rank_ragged_pack(flat, tables[d][1])
        pack = tables[d + "_pack"]
        if isinstance(pack, list):
            return [gather_planes(flat, t) for t in pack]
        return gather_planes(flat, pack)

    def _exact_unpack(self, recv, table, forward: bool) -> tuple:
        """The unpack gather of an exact-count schedule: over ranks'
        ragged received buffer ``(n, B, 2)``, or the stacked planar
        receive buffers."""
        if isinstance(recv, torch.Tensor):
            return self._shaped(rank_ragged_unpack(recv, table), forward)
        return self._shaped(gather_planes(recv, table), forward)

    def _exchange_steps(self, forward: bool = False) -> tuple:
        """The exchange of one direction as named steps, ``(name,
        function)`` pairs, each function taking the previous one's output
        (the first the planar pair, the last returning it): backward,
        sticks ``(B, L, max_sticks, dim_z)`` -> plane grid ``(B, L,
        max_planes, dim_y, x)``; forward, the reverse (L = S on one
        device). The padded blocks: ``pack``, ``transpose`` (``ring`` for
        ``UNBUFFERED``; the wire's casts or int8 kernels inside), or over
        ranks the collective's kind (``all_to_all``, ``p2p_ring``),
        ``unpack``; the exact-count schedules: ``pack`` (gather kernel),
        ``ragged`` (the emulated collective, a gather kernel launch) or
        ``ppermute`` (the op moves), over ranks ``all_to_all_v`` or
        ``p2p_ops``, ``unpack`` (gather kernel); K > 1 chunks: ``chunks``
        (each chunk's pack and move, issued in chunk order) and
        ``unpack`` (one, late)."""
        if self._overlap is not None:
            return self._chunk_steps(forward)
        if self._t_x is not None:
            t = self._t_x
            unpack = t["fwd_unpack" if forward else "bwd_unpack"]
            if self._comm is not None:
                move = ("all_to_all_v" if self._ragged is not None
                        else "p2p_ops",
                        lambda b: self._rank_move(b, t, forward).wait())
            else:
                move = ("ragged" if self._ragged is not None else "ppermute",
                        lambda b: self._exact_move(b, t, forward))
            return (("pack", lambda p: self._exact_pack(p, t, forward)),
                    move,
                    ("unpack", lambda p: self._exact_unpack(p, unpack,
                                                            forward)))
        if self._comm is not None:
            name = self.RANK_KINDS["ring" if self._ring else "block"]
        else:
            name = "ring" if self._ring else "transpose"
        return (("pack", lambda p: self._pack_blocks(p, forward)),
                (name, lambda b: self._move_blocks(b, forward)),
                ("unpack", lambda b: self._unpack_blocks(b, forward)))

    def _chunk_steps(self, forward: bool) -> tuple:
        """The K-chunk exchange (:mod:`.overlap`): each chunk's rows
        (sticks backward, planes forward) packed and moved, in chunk
        order (over ranks each chunk's collective issued asynchronously,
        so that on NCCL chunk c moves while chunk c + 1 packs); then the
        received chunks waited for, joined and unpacked once."""
        ov = self._overlap
        bounds = ov.plane_bounds() if forward else ov.stick_bounds()
        # over ranks each chunk's move is issued and waited for in unpack
        ranks = self._comm is not None

        def chunks(planes):
            recvs = []
            for c, (lo, hi) in enumerate(bounds):
                part = tuple(t[:, :, lo:hi] for t in planes)
                if ov.kind == "block":
                    blocks = self._pack_blocks(part, forward)
                    recvs.append(self._move_start(blocks, forward) if ranks
                                 else self._move_blocks(blocks, forward))
                else:
                    tables = self._t_x["chunks"][c]
                    packed = self._exact_pack(part, tables, forward)
                    recvs.append(
                        self._rank_move(packed, tables, forward, c << 24)
                        if ranks
                        else self._exact_move(packed, tables, forward))
            return recvs

        def unpack(recvs):
            if ranks:
                recvs = [r.wait() for r in recvs]
            t = self._t_x["fwd_unpack" if forward else "bwd_unpack"] \
                if self._t_x is not None else None
            if ov.kind == "block":
                # chunk blocks are stick rows (backward) / plane columns
                # (forward) of the monolithic (S, max_sticks, max_planes)
                axis = -1 if forward else -2
                return self._unpack_blocks(tuple(
                    torch.cat([r[i] for r in recvs], dim=axis)
                    for i in range(2)), forward)
            if isinstance(recvs[0], torch.Tensor):
                return self._exact_unpack(torch.cat(recvs, dim=0), t,
                                          forward)
            recv = tuple(torch.cat([r[i] for r in recvs], dim=-1)
                         for i in range(2))
            return self._exact_unpack(recv, t, forward)

        return (("chunks", chunks), ("unpack", unpack))

    def _exchange(self, planes: tuple, forward: bool = False) -> tuple:
        """Sticks -> plane grid (backward) or plane grid -> sticks
        (``forward``), the planar pair through :meth:`_exchange_steps`."""
        for _, step in self._exchange_steps(forward):
            planes = step(planes)
        return tuple(planes)

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
        grid = (b, self._L, dp.max_planes, dp.dim_y, self._xf_eff)
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
        shape = (self._L, b, dp.max_values, 2)
        if self._fused:
            out = torch.zeros(shape, dtype=self.real_dtype,
                              device=self.device)
            for r, p in enumerate(self._local_plans):
                out[r, :, :p.num_values] = fused_kernel.zdft_compress(
                    dense(sr[:, r]), dense(si[:, r]), z,
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
            return dense(space.transpose(0, 1))
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
            return dense(t)
        return dense(t[..., 0]), dense(t[..., 1])

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

    def _wire_elem_bytes(self) -> int:
        """Bytes of one complex element on the wire: the plan's (8 single,
        16 double), or two of the wire rung's type (float32 8, bfloat16 4,
        int8 2; the int8 scales are :meth:`_wire_scale_bytes`)."""
        if self._wire is not None:
            return 2 * self._wire.itemsize
        return 2 * self.real_dtype.itemsize

    def _wire_scale_bytes(self, forward: bool, busiest: bool = False) -> int:
        """The int8 rung's scale bytes for ONE exchange: one float32 per
        (destination slot, quant row), rows sticks backward and planes
        forward, so the total is the same at every K; 0 on every other
        rung."""
        if self._wire != torch.int8:
            return 0
        dp = self.dist_plan
        rows = dp.max_planes if forward else dp.max_sticks
        links = ((dp.num_shards - 1) if busiest
                 else dp.num_shards * (dp.num_shards - 1))
        return links * rows * 4

    def exchange_wire_bytes(self, forward: bool = False) -> int:
        """Total off-shard bytes of ONE exchange, summed over shards, as
        the JAX package counts them: the padded layouts ship ``S * (S -
        1) * max_sticks * max_planes`` elements (plus the int8 scales)
        whatever the distribution; the exact-count schedules their
        per-pair counts (the op schedule its bucket sizes; K chunks
        conserve the total)."""
        dp = self.dist_plan
        elem = self._wire_elem_bytes()
        if self._overlap is not None and self._overlap.kind != "block":
            return self._overlap.wire_elements() * elem
        if self._ragged is not None:
            return self._ragged.wire_elements() * elem
        if self._compact is not None:
            return self._compact.wire_elements() * elem
        return (dp.num_shards * (dp.num_shards - 1) * dp.max_sticks
                * dp.max_planes * elem + self._wire_scale_bytes(forward))

    def exchange_busiest_link_bytes(self, forward: bool = False) -> int:
        """Max over shards of max(sent, received) off-shard bytes of ONE
        exchange, as the JAX package counts them."""
        dp = self.dist_plan
        elem = self._wire_elem_bytes()
        if self._overlap is not None and self._overlap.kind != "block":
            return self._overlap.busiest_link_elements() * elem
        if self._ragged is not None:
            return self._ragged.busiest_link_elements() * elem
        if self._compact is not None:
            return self._compact.busiest_link_elements() * elem
        return ((dp.num_shards - 1) * dp.max_sticks * dp.max_planes * elem
                + self._wire_scale_bytes(forward, busiest=True))

    def estimated_device_bytes(self) -> int:
        """Bytes of the tables and matrices the plan keeps on its device
        for its lifetime, the exchange schedules' tables included."""
        return sum(t.numel() * t.element_size()
                   for t in self._device_tables() + self._xtables)

    # -- data movement helpers -----------------------------------------------
    def shard_values(self, values_per_shard: Sequence) -> torch.Tensor:
        """Per-shard value arrays -> the padded ``(L, max_values, 2)``
        tensor of the plan's real type on its device: one array for each
        of this process's L shards (all S on one device)."""
        dp = self.dist_plan
        if len(values_per_shard) != self._L:
            raise InvalidParameterError(
                f"one value array per shard of this process required "
                f"({self._L}), got {len(values_per_shard)}")
        out = np.zeros((self._L, dp.max_values, 2), self._np_real)
        for r, v in enumerate(values_per_shard):
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            il = as_interleaved(v, self.precision)
            n = self._local_plans[r].num_values
            if il.shape != (n, 2):
                raise InvalidParameterError(
                    f"shard {self._lo + r}: expected {n} values, got "
                    f"{il.shape[:-1]}")
            out[r, :il.shape[0]] = il
        return torch.as_tensor(out, device=self.device)

    def unshard_values(self, values) -> list:
        """Padded ``(L, max_values, 2)`` values -> per-shard numpy complex
        arrays (this process's shards)."""
        arr = np.asarray(values.detach().cpu() if isinstance(
            values, torch.Tensor) else values)
        return [arr[r, :p.num_values, 0] + 1j * arr[r, :p.num_values, 1]
                for r, p in enumerate(self._local_plans)]

    def _slab_shape(self) -> tuple:
        dp = self.dist_plan
        shape = (dp.max_planes, dp.dim_y, dp.dim_x)
        return shape if self._r2c else shape + (2,)

    def shard_space(self, slabs: Sequence) -> torch.Tensor:
        """Per-shard space-domain slabs -> the padded ``(L, max_planes,
        dim_y, dim_x[, 2])`` tensor of the plan's real type on its
        device: one slab for each of this process's L shards."""
        dp = self.dist_plan
        if len(slabs) != self._L:
            raise InvalidParameterError(
                f"one slab per shard of this process required "
                f"({self._L}), got {len(slabs)}")
        out = np.zeros((self._L,) + self._slab_shape(), self._np_real)
        for r, slab in enumerate(slabs):
            if isinstance(slab, torch.Tensor):
                slab = slab.detach().cpu().numpy()
            n = dp.num_planes[self._lo + r]
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
        for r in range(self._L):
            slab = arr[r, :dp.num_planes[self._lo + r]]
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
            return self._tensor(values, (self._L, dp.max_values, 2),
                                "stacked values")
        return self.shard_values(values)

    def _space(self, space) -> torch.Tensor:
        if isinstance(space, torch.Tensor):
            if self._r2c and space.is_complex():
                raise InvalidParameterError(
                    "expected a real space-domain slab, got a complex one")
            return self._tensor(space, (self._L,) + self._slab_shape(),
                                "stacked space")
        return self.shard_space(space)

    # -- the exchange's fault seams ---------------------------------------------
    def _seam(self, forward: bool) -> None:
        """Consult the ``exchange.*`` sites one direction's traced body
        reaches in the JAX package, in its order: the pack, the collective
        and (for the backward) the unpack; with K > 1 chunks, each chunk's
        chunk and pack checks, then the backward's unpack."""
        if self._overlap is not None:
            for _ in range(self._overlap.num_chunks):
                faults.check_site("exchange.chunk")
                faults.check_site("exchange.pack")
        else:
            faults.check_site("exchange.pack")
            faults.check_site("exchange.collective")
        if not forward:
            faults.check_site("exchange.unpack")

    def _seams(self, key, directions) -> None:
        """Consult the exchange's seams on the first call of the executable
        ``key`` (per compile in the JAX package, where they fire at trace
        time): each direction's sites in order (:meth:`_seam`), ``key``
        recorded once they all passed."""
        if key in self._seam_keys:
            return
        for forward in directions:
            self._seam(forward)
        self._seam_keys.add(key)

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
                self._seams(("backward",), (False,))
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
                self._seams(("forward", scaling), (True,))
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
            v = self._tensor(values_batch, (self._L, values_batch.shape[1],
                                            dp.max_values, 2),
                             "stacked values batch")
        else:
            v = self.shard_values_batch(values_batch)
        with timed_transform("backward_batched") as box:
            if self._local1 is not None:
                box.value = self._local1.backward_batched(v[0])[None]
            else:
                self._seams(("backward_batched", v.shape[1]), (False,))
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
            sp = self._tensor(space_batch, (self._L, space_batch.shape[1])
                              + self._slab_shape(), "stacked space batch")
        else:
            if len(space_batch) == 0:
                raise InvalidParameterError("a batch needs at least one row")
            sp = torch.stack([self._space(s) for s in space_batch], dim=1)
        with timed_transform("forward_batched") as box:
            if self._local1 is not None:
                box.value = self._local1.forward_batched(sp[0], scaling)[None]
            else:
                self._seams(("forward_batched", scaling, sp.shape[1]),
                            (True,))
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
        sees ``(1, ...)``, the delegate hands it the bare slab. Cached per
        ``fn``, as the JAX package's, so the delegate's executable keys
        stay stable; the wrapper reaches ``fn`` through a weak reference,
        so the cache does not keep a dropped ``fn`` alive."""
        if fn is None:
            return None
        try:
            cache, ref = self._local1_fns, weakref.ref(fn)
        except TypeError:  # a builtin: no weak reference, lives on
            cache, ref = self._local1_builtin_fns, lambda: fn
        w = cache.get(fn)
        if w is None:
            def w(s, *a):
                return ref()(s[None], *a)[0]
            cache[fn] = w
        return w

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
                self._seams(("pair", fn, scaling), (False, True))
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
                self._seams(("iterate", fn, scaling, int(steps)),
                            (False, True))
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
    PyTorch versions. ``triplets_per_shard`` and ``planes_per_shard``
    are every shard's; on a mesh over the ranks of a process group each
    rank passes all of them and the ranks' plans are cross-checked
    (:func:`~.multihost.validate_consistent`; each rank passing only its
    own shards' triplets is
    :func:`~.multihost.build_distributed_plan_multihost`)."""
    dist = build_distributed_plan(transform_type, dim_x, dim_y, dim_z,
                                  triplets_per_shard, planes_per_shard)
    if isinstance(mesh, Mesh) and mesh.num_processes > 1:
        from .multihost import validate_consistent
        validate_consistent(dist, process_group=mesh.process_group)
    return DistributedTransformPlan(
        dist, mesh=mesh, precision=precision, exchange=exchange,
        overlap_chunks=overlap_chunks, wire_precision=wire_precision,
        wire_error_budget=wire_error_budget, device=device, fused=fused)
