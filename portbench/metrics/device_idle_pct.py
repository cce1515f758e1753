"""The share of the traced window's wall time in which no device
operation runs, in %: 100 * (1 - busy / window), both from the
profiler's trace (the window from the first span's start to the last
span's end)."""


def read(r):
    if not r.summary or r.summary.window_us <= 0 or r.summary.busy_us <= 0:
        return None
    return 100.0 * (1.0 - r.summary.busy_us / r.summary.window_us)
