"""The z stage's share of its roofline, in %: the least time of the z
stage's bytes and operations a pair (``counts.pair_counts``) over the
device time a pair of the program's z-stage kernels (``z`` in
``kernels/stages.json``: the fused gather + z FFT kernels, the gather of
the two-kernel route). Nothing when the trace holds no such kernel."""


def read(r):
    t = r.summary.seconds(stage="z") if r.summary else 0.0
    if t <= 0 or r.pairs_traced <= 0:
        return None
    return 100.0 * r.bound("z") / (t / r.pairs_traced)
