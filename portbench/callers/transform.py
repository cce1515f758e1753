"""The per-band caller: one call is, for each band of its group,
``Transform.backward``, the space slab times V(r), and
``Transform.forward`` with FULL scaling, as a loop over bands calls
SpFFT's ``Transform``."""

import spfft_tpu_torch as sp


def handles(batch: int) -> int:
    """The ``Transform`` handles a call takes: one."""
    return 1


def call(c, group: list) -> list:
    """One call over the bands ``group`` through the harness's
    ``Caller`` ``c``; returns each band's output values."""
    tr, outs = c.transforms[0], []
    for b in group:
        space = c.inside("backward", lambda: tr.backward(c.values[b]))
        c.apply([space])
        outs.append(c.inside("forward",
                             lambda: tr.forward(space, sp.Scaling.FULL)))
    return outs
