"""The share of the traced episode's wall time in which no operation ran
on the card: 100 * (1 - busy / window), busy the union of the profiler's
kernel, copy and fill intervals.  The profiler's own cost on the host is
in it."""


def read(r):
    if r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
