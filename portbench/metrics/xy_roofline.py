"""The plane stages' share of their roofline, in %: the least time of
the xy stage's bytes and operations a pair (``counts.pair_counts``: the
sticks and the slab each direction) over the device time a pair of the
program's plane kernels (``xy`` in ``kernels/stages.json``). Nothing
when the trace holds no such kernel."""


def read(r):
    t = r.summary.seconds(stage="xy") if r.summary else 0.0
    if t <= 0 or r.pairs_traced <= 0:
        return None
    return 100.0 * r.bound("xy") / (t / r.pairs_traced)
