"""The shard mesh (counterpart of ``spfft_tpu.parallel.mesh``).

The JAX package's distributed plan is single-controller SPMD over a 1-D
``jax.sharding.Mesh``: one program, one device per shard. This slice of
the port holds all S shards in one process on ONE device, in the JAX
package's stacked layouts (a leading shard axis), and runs the exchange
between them as a block transpose on that device. A :class:`Mesh` names
S, that device and the axis name. One process per GPU with
``torch.distributed`` (the counterpart of ``parallel/multihost.py``) is
the multi-GPU slice's, so a mesh over several devices raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..errors import InvalidParameterError
from ..plan import _not_in_slice, resolve_device

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shards on one device."""

    num_shards: int
    device: torch.device
    axis_name: str = SHARD_AXIS


def make_mesh(num_shards: int, device=None,
              axis_name: str = SHARD_AXIS) -> Mesh:
    """A mesh of ``num_shards`` shards on ``device``: the current CUDA
    device by default, ``"cpu"`` for the plain PyTorch versions. A
    sequence of several distinct devices raises
    :class:`~spfft_tpu_torch.errors.InvalidParameterError` (the
    multi-GPU slice adds it)."""
    if isinstance(num_shards, bool) or not isinstance(num_shards, int) \
            or num_shards < 1:
        raise InvalidParameterError(
            f"num_shards must be an int >= 1, got {num_shards!r}")
    if isinstance(device, (list, tuple)):
        devices = {resolve_device(d) for d in device}
        if len(devices) > 1:
            raise _not_in_slice("a mesh over several devices", "multi-GPU")
        device: Optional[torch.device] = devices.pop() if devices else None
    return Mesh(num_shards, resolve_device(device), axis_name)
