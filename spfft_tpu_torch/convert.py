"""Carry a plan's state across from the JAX package.

The SpFFT counterpart of a model's weights is the index plan: the
per-value slot map and the stick keys decide every table a plan builds.
:func:`index_plan_from_arrays` takes the fields of a
``spfft_tpu.indexing.IndexPlan`` as plain numpy arrays and ints (for
example ``dataclasses.asdict(jax_index_plan)``) and returns this
package's :class:`~spfft_tpu_torch.indexing.IndexPlan`, so that both
packages can be handed the same plan. Nothing of the JAX package is
imported: an enum field is read through its ``value``.
:func:`distributed_plan_from_arrays` does the same for a distributed
plan: one such mapping per shard (the fields of each of a JAX
``DistributedIndexPlan``'s ``shard_plans``) and the slab heights.
"""

from __future__ import annotations

import numpy as np

from .errors import InvalidParameterError
from .indexing import IndexPlan
from .parallel.dist import DistributedTransformPlan, distributed_index_plan
from .plan import TransformPlan
from .types import TransformType

_FIELDS = ("transform_type", "dim_x", "dim_y", "dim_z", "centered",
           "value_indices", "stick_keys")


def index_plan_from_arrays(fields) -> IndexPlan:
    """Build an :class:`IndexPlan` from a mapping of its fields
    (``transform_type`` as a value like ``"c2c"`` or an enum with that
    value, ``dim_x``/``dim_y``/``dim_z``, ``centered``,
    ``value_indices``, ``stick_keys``, optional ``value_conj``), checking
    that the tables fit the dimensions."""
    missing = [k for k in _FIELDS if k not in fields]
    if missing:
        raise InvalidParameterError(f"index plan fields missing: {missing}")
    tt = fields["transform_type"]
    tt = TransformType(getattr(tt, "value", tt))
    dx, dy, dz = (int(fields[k]) for k in ("dim_x", "dim_y", "dim_z"))
    vi = np.ascontiguousarray(fields["value_indices"], np.int32)
    keys = np.ascontiguousarray(fields["stick_keys"], np.int32)
    conj = fields.get("value_conj")
    if vi.ndim != 1 or keys.ndim != 1:
        raise InvalidParameterError("value_indices and stick_keys must be 1-D")
    x_freq = dx // 2 + 1 if tt == TransformType.R2C else dx
    if keys.size and (np.any(np.diff(keys.astype(np.int64)) <= 0)
                      or keys[0] < 0 or keys[-1] >= x_freq * dy):
        raise InvalidParameterError(
            "stick_keys must be strictly ascending keys x*dim_y + y of "
            "the frequency plane")
    if vi.size and (vi.min() < 0 or vi.max() >= keys.size * dz):
        raise InvalidParameterError(
            "value_indices must address the stick slots stick * dim_z + z")
    if conj is not None:
        conj = np.asarray(conj, bool)
        if conj.shape != vi.shape or tt != TransformType.R2C:
            raise InvalidParameterError(
                "value_conj must be a per-value mask of an R2C plan")
    return IndexPlan(transform_type=tt, dim_x=dx, dim_y=dy, dim_z=dz,
                     centered=bool(fields["centered"]), value_indices=vi,
                     stick_keys=keys, value_conj=conj)


def plan_from_arrays(fields, device=None, fused: bool = True,
                     **plan_kwargs) -> TransformPlan:
    """A :class:`~spfft_tpu_torch.plan.TransformPlan` on ``device`` from
    an index plan's fields (see :func:`index_plan_from_arrays`), on the
    fused route or, with ``fused=False``, the two-kernel one;
    ``plan_kwargs`` as in ``TransformPlan``."""
    return TransformPlan(index_plan_from_arrays(fields), device=device,
                         fused=fused, **plan_kwargs)


def distributed_plan_from_arrays(shard_fields, planes, device=None,
                                 fused: bool = True, **plan_kwargs
                                 ) -> DistributedTransformPlan:
    """A :class:`~spfft_tpu_torch.parallel.DistributedTransformPlan` from
    one index plan's fields per shard (see :func:`index_plan_from_arrays`)
    and the slab heights ``planes``, validated as
    ``make_distributed_plan`` validates its own (plane sum, stick
    duplicates, stick total); ``plan_kwargs`` as in the plan."""
    dist = distributed_index_plan(
        [index_plan_from_arrays(f) for f in shard_fields], planes)
    return DistributedTransformPlan(dist, device=device, fused=fused,
                                    **plan_kwargs)
