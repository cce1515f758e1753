"""Device operations (kernels, copies, memsets) launched inside the calls
into the program, a pair, from the profiler's trace."""

from portbench.trace import port_spans


def read(r):
    if not r.summary or r.pairs_traced <= 0:
        return None
    n = r.summary.count(port_spans())
    return n / r.pairs_traced if n else None
