"""The shard mesh (counterpart of ``spfft_tpu.parallel.mesh``).

The JAX package's distributed plan is single-controller SPMD over a 1-D
``jax.sharding.Mesh``: one program, one device per shard. The port has
two layouts of the same S shards, in the JAX package's stacked layouts
(a leading shard axis):

* without a process group, all S shards in one process on ONE device,
  the exchange between them a copy on that device;
* over a ``torch.distributed`` process group of P ranks, one process per
  GPU: rank r holds the L = S / P shards ``[r * L, (r + 1) * L)`` on its
  own device, and the exchange is a collective of the group (NCCL between
  cards; gloo also runs it on CPU tensors, and on CUDA tensors through
  the host where it can, :mod:`.exchange`).

A :class:`Mesh` names S, the device, the axis name and, over ranks, the
group, its size and this process's rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..errors import DistributedError, InvalidParameterError
from ..plan import resolve_device

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shards: on one device, or spread over the ranks of
    ``process_group`` (``num_processes`` ranks, this one ``rank``, each
    holding ``num_shards // num_processes`` of them on ``device``)."""

    num_shards: int
    device: torch.device
    axis_name: str = SHARD_AXIS
    process_group: Optional[Any] = None
    num_processes: int = 1
    rank: int = 0

    @property
    def local_shards(self) -> int:
        """L: the shards this process holds."""
        return self.num_shards // self.num_processes

    @property
    def shard_range(self) -> range:
        """The global indices of this process's shards."""
        lo = self.rank * self.local_shards
        return range(lo, lo + self.local_shards)

    @property
    def backend(self) -> Optional[str]:
        """The group's backend (``"nccl"``, ``"gloo"``), None without
        one."""
        if self.process_group is None:
            return None
        import torch.distributed as dist
        return str(dist.get_backend(self.process_group))


def make_mesh(num_shards: int, device=None, process_group=None,
              axis_name: str = SHARD_AXIS) -> Mesh:
    """A mesh of ``num_shards`` shards.

    Without ``process_group``: every shard on ``device``, the current CUDA
    device by default, ``"cpu"`` for the plain PyTorch versions (a
    sequence of several distinct devices raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError`: several
    devices are several processes).

    With ``process_group`` (a ``torch.distributed`` group, or
    ``torch.distributed.group.WORLD``) of P ranks: this rank r holds the
    shards ``[r * L, (r + 1) * L)``, L = S / P (S must divide by P, the
    JAX package's equal ``shards_per_process``), on ``device``, by
    default ``cuda:{r % torch.cuda.device_count()}``."""
    if isinstance(num_shards, bool) or not isinstance(num_shards, int) \
            or num_shards < 1:
        raise InvalidParameterError(
            f"num_shards must be an int >= 1, got {num_shards!r}")
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) > 1:
            raise InvalidParameterError(
                "a mesh over several devices in one process is not in this "
                "slice of spfft_tpu_torch; multi-GPU runs one process per "
                "device: make_mesh(num_shards, device, process_group=...) "
                "in each")
        device = devices.pop() if devices else None
    if process_group is None:
        return Mesh(num_shards, resolve_device(device), axis_name)
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise DistributedError(
            "process_group given but torch.distributed is not initialized "
            "(initialize_multihost first)")
    size = dist.get_world_size(process_group)
    rank = dist.get_rank(process_group)
    if num_shards % size:
        raise InvalidParameterError(
            f"{num_shards} shards do not divide over {size} processes: "
            f"every process holds the same number of shards")
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(num_shards, resolve_device(device), axis_name,
                process_group, size, rank)
