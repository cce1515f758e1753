"""The whole pair's share of its roofline, in %: the least time of a
pair's values in, slab out, slab in and values out, each once, and its
FFT operations (``counts.pair_counts``), over the device time a pair of
everything launched inside the calls into the program. It reads the same
work whatever implements it."""

from portbench.trace import port_spans


def read(r):
    t = r.summary.seconds(spans=port_spans()) if r.summary else 0.0
    if t <= 0 or r.pairs_traced <= 0:
        return None
    return 100.0 * r.bound("pair") / (t / r.pairs_traced)
