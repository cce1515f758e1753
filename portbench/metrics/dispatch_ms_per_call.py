"""Host-clock ms a call spends inside the calls into the program
(backward and forward), before the caller synchronizes: the program's
checks, launches and torch's dispatch, while the card works. The mean
over every call of the measured window, which the profiler does not
slow."""


def read(r):
    if not r.dispatch_s:
        return None
    return sum(r.dispatch_s) / len(r.dispatch_s) * 1e3
