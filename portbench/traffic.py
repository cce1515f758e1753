"""The one generator of traffic: a mix is a JSON file of parameters,
``portbench/traffic/<name>.json``, read by :class:`Traffic`.

Parameters (every key is required):

- ``api``: the caller, ``portbench/callers/<api>.py``, which makes one
  call over a group of bands: backward, each band's space slab times
  V(r), forward with FULL scaling (``multi``: ``multi_transform_*`` over
  a ``Transform`` and its clones; ``transform``: ``Transform.backward`` /
  ``forward`` band by band);
- ``batch``: bands in one call; call k takes bands k*batch ..
  k*batch+batch-1 modulo the resident bands, the same work whatever the
  seed;
- ``warmup_calls``: calls made in set-up, before the window;
- ``trace_calls``: calls traced after the window in a ``--trace 1`` run.

A call ends in the caller's ``torch.cuda.synchronize()``: a closed loop
with one caller.
"""

from __future__ import annotations

KEYS = ("api", "batch", "warmup_calls", "trace_calls")


class Traffic:
    """A traffic mix's parameters and its schedule of band groups."""

    def __init__(self, params: dict, bands: int):
        missing = [k for k in KEYS if k not in params]
        if missing:
            raise ValueError(f"traffic lacks {missing}")
        self.api = params["api"]
        self.batch = int(params["batch"])
        self.warmup_calls = int(params["warmup_calls"])
        self.trace_calls = int(params["trace_calls"])
        if self.warmup_calls < 1:
            raise ValueError("a traffic warms up with one call or more")
        if not 1 <= self.batch <= bands or bands % self.batch:
            raise ValueError(f"batch {self.batch} does not divide the "
                             f"{bands} resident bands")
        self.groups_per_pass = bands // self.batch

    def group(self, call: int) -> list:
        """The bands of call ``call``."""
        g = call % self.groups_per_pass
        return list(range(g * self.batch, (g + 1) * self.batch))
