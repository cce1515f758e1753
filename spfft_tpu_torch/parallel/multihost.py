"""One process per GPU: the plan-time side (counterpart of
``spfft_tpu.parallel.multihost``, over ``torch.distributed``).

The reference's multi-node story is MPI: every rank calls the collective
Grid and Transform constructors, which cross-check their parameters with
an ``MPI_Allreduce`` so that a rank passing different dims fails fast
with ``MPIParameterMismatchError`` (reference:
src/spfft/grid_internal.cpp:148-167), and exchange every rank's z-stick
list so that all ranks hold the full distribution plan (reference:
src/compression/indices.hpp:58-102, src/parameters/parameters.cpp:
81-109). Here one Python process runs per GPU under ``torch.distributed``
and this module keeps the JAX package's three plan-time behaviours:

* :func:`initialize` — process-group bring-up;
* :func:`validate_consistent` — mismatch detection through an
  allgathered digest of the plan's global parameters
  (:func:`plan_fingerprint`, byte for byte the JAX package's);
* :func:`build_distributed_plan_multihost` — each process contributes the
  triplet lists and plane counts of the shards it owns, and a
  process-level allgather makes the global plan identical everywhere.

The collectives go through an injectable ``(allgather, process_count,
process_index)`` triple, so the protocol is testable in one process; by
default it is built from ``torch.distributed.all_gather`` on the live
group. With one process everything is local.
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Optional, Sequence

import numpy as np

from ..errors import DistributedError, ParameterMismatchError
from ..types import TransformType
from .dist import DistributedIndexPlan, build_distributed_plan


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Bring up the ``torch.distributed`` process group (the counterpart
    of ``MPI_Init`` and the communicator, reference:
    src/mpi_util/mpi_init_handle.hpp:39-59). ``coordinator_address``
    ``"host:port"`` is rank 0's store (``tcp://host:port``);
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK`` of the environment (what ``torchrun`` sets). The backend is
    ``"nccl"`` where CUDA is available, else ``"gloo"``, unless
    ``backend`` names one; with NCCL this process's current CUDA device
    becomes ``cuda:{LOCAL_RANK or process_id % device_count}``. Does
    nothing without an address, or when the group is already up.
    Failures raise :class:`~spfft_tpu_torch.errors.DistributedError`."""
    if coordinator_address is None:
        return  # single-process mode
    import torch
    import torch.distributed as dist
    if not dist.is_available():
        raise DistributedError("torch.distributed is not available in this "
                               "build of torch")
    if dist.is_initialized():
        return
    try:
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    except (KeyError, ValueError) as exc:
        raise DistributedError(
            f"num_processes / process_id not given and WORLD_SIZE / RANK "
            f"not set: {exc}") from exc
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=float(timeout_s))}
    try:
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    except Exception as exc:  # noqa: BLE001 - surfaced typed
        raise DistributedError(
            f"torch.distributed initialization failed ({backend}, "
            f"{coordinator_address}, {num_processes} processes, rank "
            f"{process_id}): {exc}") from exc


def plan_fingerprint(dist_plan: DistributedIndexPlan) -> bytes:
    """A 16-byte digest of everything that must agree across processes:
    dims, transform type, per-shard plane counts/offsets and the full
    per-shard stick tables (the fields of the reference's allgathered
    ``TransposeParameter`` struct plus its exchanged stick lists,
    parameters.cpp:81-109); the JAX package's digest byte for byte."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([dist_plan.dim_x, dist_plan.dim_y, dist_plan.dim_z,
                         int(dist_plan.transform_type is TransformType.R2C)],
                        np.int64).tobytes())
    h.update(np.asarray(dist_plan.num_planes, np.int64).tobytes())
    h.update(np.asarray(dist_plan.plane_offsets, np.int64).tobytes())
    for sp in dist_plan.shard_plans:
        h.update(b"|")
        h.update(np.ascontiguousarray(sp.stick_keys, np.int64).tobytes())
        h.update(np.ascontiguousarray(sp.value_indices, np.int64).tobytes())
    return h.digest()


def _live_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _check_digests(digests: np.ndarray, local: bytes,
                   process_index: Optional[int] = None) -> None:
    """Compare per-process digests (rows of a (P, 16) uint8 array); raise
    naming the mismatching processes."""
    if process_index is None:
        process_index = _live_rank()
    rows = np.asarray(digests, np.uint8).reshape(-1, len(local))
    local_row = np.frombuffer(local, np.uint8)
    bad = [p for p in range(rows.shape[0])
           if not np.array_equal(rows[p], local_row)]
    if bad:
        raise ParameterMismatchError(
            "distributed plan parameters differ across processes: "
            f"process(es) {bad} disagree with process {process_index} "
            "(all hosts must construct the plan with identical dims, "
            "transform type, plane split and stick sets)")


def _default_collective(process_group=None):
    """(allgather, process_count, process_index) from the live
    ``torch.distributed`` group: ``allgather(x)`` stacks every process's
    numpy array ``x`` (one shape everywhere) along a new first axis,
    through ``all_gather`` on the group's device (the current CUDA device
    for NCCL, the host for gloo)."""
    import torch
    import torch.distributed as dist
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(process_group) == "nccl"
              else torch.device("cpu"))
    size = dist.get_world_size(process_group)

    def allgather(x):
        a = np.array(x)  # a writable copy
        t = torch.from_numpy(a.reshape(-1)).to(device)
        outs = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(outs, t, group=process_group)
        return np.stack([o.cpu().numpy().reshape(a.shape) for o in outs])

    return allgather, size, dist.get_rank(process_group)


def _resolve_collective(collective, process_group=None):
    """An injected collective triple wins; otherwise the live process group
    (queried only when it has several processes, so single-process callers
    never touch it)."""
    if collective is not None:
        return collective
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size(process_group) > 1:
        return _default_collective(process_group)
    return (None, 1, 0)


def validate_consistent(dist_plan: DistributedIndexPlan, *,
                        collective=None, process_group=None) -> None:
    """Cross-process parameter-mismatch detection (reference:
    grid_internal.cpp:148-167 allreduce check). Collective: every process
    must call it with its locally-built plan; raises
    ``ParameterMismatchError`` on any process whose plan differs.

    ``collective`` is an injectable ``(allgather, process_count,
    process_index)`` triple (default: the live ``torch.distributed``
    group, ``process_group`` or the world) so the multi-process logic is
    unit-testable without a real cluster."""
    allgather, process_count, process_index = _resolve_collective(
        collective, process_group)
    if process_count == 1:
        return
    local = plan_fingerprint(dist_plan)
    gathered = allgather(np.frombuffer(local, np.uint8))
    _check_digests(gathered, local, process_index)


def _pad_gather_triplets(triplets: Sequence[np.ndarray], max_rows: int):
    """Stack variable-length (n_i, 3) triplet arrays into a fixed
    (len, max_rows, 4) block whose 4th column is a validity flag — the
    fixed-shape layout a process-level allgather needs."""
    out = np.zeros((len(triplets), max_rows, 4), np.int64)
    for i, t in enumerate(triplets):
        t = np.asarray(t, np.int64).reshape(-1, 3)
        out[i, :len(t), :3] = t
        out[i, :len(t), 3] = 1
    return out


def build_distributed_plan_multihost(
        transform_type: TransformType, dim_x: int, dim_y: int, dim_z: int,
        local_triplets: Sequence[np.ndarray],
        local_planes: Sequence[int],
        shards_per_process: Optional[int] = None, *,
        collective=None, process_group=None) -> DistributedIndexPlan:
    """Build the global distribution plan when each process only knows its
    own shards' sparse indices.

    ``local_triplets[i]`` / ``local_planes[i]`` describe the i-th shard
    owned by *this* process (rank r owns the shards ``[r * L, (r + 1) *
    L)``, :func:`~spfft_tpu_torch.parallel.mesh.make_mesh`); every
    process must own the same number of shards (``shards_per_process``,
    defaulting to ``len(local_triplets)``, checked across processes
    before any data-shaped collective). The stick lists are exchanged
    with one process-level allgather, mirroring the reference's P2P
    stick-list exchange (indices.hpp:58-102), and the identical global
    plan is built and validated on every process.

    ``collective`` / ``process_group`` as in :func:`validate_consistent`.
    """
    if shards_per_process is None:
        shards_per_process = len(local_triplets)
    if shards_per_process < 1:
        raise ParameterMismatchError(
            "shards_per_process must be >= 1: every process must own at "
            "least one shard (an empty shard is a valid owner of zero "
            "sticks/planes, a shardless process is not)")
    if len(local_triplets) != shards_per_process \
            or len(local_planes) != shards_per_process:
        raise ParameterMismatchError(
            f"expected {shards_per_process} local shards, got "
            f"{len(local_triplets)} triplet lists / {len(local_planes)} "
            "plane counts")
    allgather, process_count, process_index = _resolve_collective(
        collective, process_group)
    if process_count == 1:
        return build_distributed_plan(transform_type, dim_x, dim_y, dim_z,
                                      local_triplets, local_planes)
    # Fail fast on unequal shard counts BEFORE any shaped collective: a
    # (2,) vs (3,) allgather mismatch would hang or die opaquely.
    all_nshards = np.asarray(
        allgather(np.int64(shards_per_process))).reshape(-1)
    if not (all_nshards == shards_per_process).all():
        raise ParameterMismatchError(
            "shards_per_process differs across processes: "
            f"{all_nshards.tolist()}")
    # Cross-check the scalar constructor parameters BEFORE building anything
    # (the reference's first allreduce, grid_internal.cpp:148-167): a dim
    # mismatch must raise on EVERY process in the same collective round —
    # discovering it later through a local sum(planes) != dim_z failure
    # would leave the agreeing processes hanging in the next collective.
    params = np.asarray([dim_x, dim_y, dim_z,
                         int(TransformType(transform_type) is
                             TransformType.R2C)], np.int64)
    all_params = np.asarray(allgather(params)).reshape(-1, 4)
    if not (all_params == params).all():
        bad = [p for p in range(all_params.shape[0])
               if not np.array_equal(all_params[p], params)]
        raise ParameterMismatchError(
            "transform parameters differ across processes: process(es) "
            f"{bad} disagree with process {process_index} on "
            "(dim_x, dim_y, dim_z, transform_type): "
            f"{all_params.tolist()}")
    counts = np.asarray([len(np.asarray(t).reshape(-1, 3))
                         for t in local_triplets], np.int64)
    all_counts = allgather(counts)
    max_rows = max(1, int(np.asarray(all_counts).max()))
    block = _pad_gather_triplets(local_triplets, max_rows)
    all_blocks = allgather(block)
    all_planes = allgather(np.asarray(local_planes, np.int64))
    all_blocks = np.asarray(all_blocks).reshape(-1, max_rows, 4)
    all_planes = np.asarray(all_planes).reshape(-1)
    triplets_per_shard = [b[b[:, 3] == 1][:, :3] for b in all_blocks]
    plan = build_distributed_plan(transform_type, dim_x, dim_y, dim_z,
                                  triplets_per_shard, list(all_planes))
    validate_consistent(
        plan, collective=(allgather, process_count, process_index))
    return plan
