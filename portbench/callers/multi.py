"""The batched caller: one call is ``multi_transform_backward`` over a
``Transform`` and its clones, each band's space slab times V(r), and
``multi_transform_forward`` with FULL scaling, as SpFFT's
``multi_transform_*`` are called over clones of one transform."""

import spfft_tpu_torch as sp
from spfft_tpu_torch import multi


def handles(batch: int) -> int:
    """The ``Transform`` handles a call takes: the plan and its clones."""
    return batch


def call(c, group: list) -> list:
    """One call over the bands ``group`` through the harness's
    ``Caller`` ``c``; returns each band's output values."""
    vals = [c.values[b] for b in group]
    spaces = c.inside("backward", lambda: multi.multi_transform_backward(
        c.transforms, vals))
    c.apply(spaces)
    return c.inside("forward", lambda: multi.multi_transform_forward(
        c.transforms, spaces, [sp.Scaling.FULL] * len(group)))
