"""Execution of several independent transforms at once (counterpart of
``spfft_tpu.multi``).

The reference's ``multi_transform_forward/backward`` interleaves the
phases of N transforms by hand (reference:
include/spfft/multi_transform.hpp,
src/spfft/multi_transform_internal.hpp:47-145). Here kernels are queued
asynchronously on the current CUDA stream, so N transforms dispatched
one after another already run back to back on the card. When every
transform shares one plan and the batch is in the regime where it pays
(:func:`fusion_eligible`), the batch runs as ONE batched execution
(``TransformPlan.backward_batched`` / ``forward_batched``: one launch of
each kernel per direction) instead of N.

The reference forbids transforms sharing a Grid in one batch because
they share scratch buffers (multi_transform_internal.hpp:52-59); plans
here own no scratch, so any mix of transforms is legal.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .errors import InvalidParameterError
from .grid import Transform
from .plan import TransformPlan
from .timing import suppressed, timed_transform
from .types import Scaling


def _check(transforms: Sequence[Transform], args: Sequence, what: str):
    if len(args) != len(transforms):
        raise InvalidParameterError(
            f"got {len(transforms)} transforms but {len(args)} {what}")


#: Batching gate on the TOTAL batch work, B * grid elements: a batch over
#: one plan runs as one batched execution while B * dim_x * dim_y *
#: dim_z is at most this. Set from chip_smoke.py's batched-versus-looped
#: sweep on an NVIDIA H100 80GB HBM3 (power limit 700.00 W; PERF.md
#: gives the times): at 128^3 and 256^3, B in {2, 4, 8}, C2C
#: and R2C, the batched pair took less time per band than B single pairs
#: in all 12 cells, up to the largest measured, 256^3 B = 8
#: (134,217,728). Past it nothing was measured and the batch's
#: intermediates keep growing with B, so larger batches run one
#: transform at a time. The gate counts elements whatever the
#: precision: in double, chip_smoke.py's batched pair at 256^3, B = 4,
#: took 3.9997 ms per band against 4.3987 for one pair (C2C) and 1.5600
#: against 1.7400 (R2C) on the same card. Long-axis plans pass the same
#: gate, with no knob of their own: a 768^3 grid (452,984,832 points) is
#: above it for any B >= 1, so its batches run one transform at a time.
FUSED_BATCH_MAX_GRID = 134_217_728


def planned_batch_size(batch_size: int, cap: int) -> int:
    """The planned-batch power-of-two ladder (the cuFFT idiom): the
    smallest power of two >= ``batch_size``, capped at ``cap``, so that a
    caller batching by buckets meets a bounded set of batch shapes."""
    p = 2
    while p < batch_size and p < cap:
        p *= 2
    return min(p, cap)


def fusion_eligible(plan, batch_size: int) -> bool:
    """The shared batching gate: does a batch of ``batch_size``
    transforms over ``plan`` run as one batched execution? True for a
    local plan with ``batch_size >= 2`` and ``batch_size *
    plan.global_size <= FUSED_BATCH_MAX_GRID``."""
    if batch_size < 2 or not isinstance(plan, TransformPlan):
        return False
    return batch_size * plan.global_size <= FUSED_BATCH_MAX_GRID


def _shared_plan(transforms: Sequence[Transform]):
    """The plan every transform wraps (clones share their plan) when the
    batch passes :func:`fusion_eligible`, else None (one transform at a
    time)."""
    if len(transforms) < 2:
        return None
    plan = transforms[0].plan
    if any(t.plan is not plan for t in transforms[1:]):
        return None
    return plan if fusion_eligible(plan, len(transforms)) else None


def multi_transform_backward(transforms: Sequence[Transform],
                             values_batch: Sequence):
    """Backward-execute N independent transforms (reference:
    multi_transform.hpp:56-66). Returns the list of space-domain
    results, each also stored as its transform's space-domain data."""
    _check(transforms, values_batch, "value arrays")
    # per-transform timing would wait between transforms; time the batch
    # as one scope instead
    with timed_transform("multi_backward") as box:
        with suppressed():
            plan = _shared_plan(transforms)
            if plan is not None:
                stacked = plan.backward_batched(values_batch)
                box.value = list(stacked.unbind(0))
                for t, s in zip(transforms, box.value):
                    t.set_space_domain_data(s)
            else:
                box.value = [t.backward(v)
                             for t, v in zip(transforms, values_batch)]
    return box.value


def multi_transform_forward(transforms: Sequence[Transform],
                            space_batch: Optional[Sequence] = None,
                            scalings: Optional[Sequence[Scaling]] = None):
    """Forward-execute N independent transforms (reference:
    multi_transform.hpp:37-53). ``space_batch`` defaults to each
    transform's stored space-domain data; ``scalings`` defaults to
    NONE."""
    if space_batch is None:
        space_batch = [None] * len(transforms)
    if scalings is None:
        scalings = [Scaling.NONE] * len(transforms)
    _check(transforms, space_batch, "space arrays")
    _check(transforms, scalings, "scalings")
    with timed_transform("multi_forward") as box:
        with suppressed():
            plan = _shared_plan(transforms)
            fused = plan is not None \
                and all(s is not None for s in space_batch) \
                and len(set(Scaling(s) for s in scalings)) == 1
            if fused:
                stacked = plan.forward_batched(space_batch,
                                               Scaling(scalings[0]))
                box.value = list(stacked.unbind(0))
                for t, s in zip(transforms, space_batch):
                    t.set_space_domain_data(s)
            else:
                box.value = [t.forward(s, sc)
                             for t, s, sc in zip(transforms, space_batch,
                                                 scalings)]
    return box.value
