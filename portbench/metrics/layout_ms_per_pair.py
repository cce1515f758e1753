"""Device ms a pair of the operations launched inside the calls into the
program that are not the program's own CUDA kernels: torch's placement,
stacking and public-layout copies. The benchmark's V(r) multiply sits in
a span of its own and is not counted. Nothing without a traced device
operation."""

from portbench.trace import PORT_SPANS


def read(r):
    if not r.summary or not r.summary.ops or r.pairs_traced <= 0:
        return None
    return r.summary.seconds(stage="torch", spans=PORT_SPANS) * 1e3 \
        / r.pairs_traced
