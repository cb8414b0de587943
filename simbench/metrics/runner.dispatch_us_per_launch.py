"""Host dispatch microseconds per device operation: the ``round`` spans'
dispatch time (host time less the time inside CUDA API calls) over the
device operations launched inside them.  From the traced
run's spans pass (``simbench/stages.py``)."""

from simbench import stages


def read(r):
    s = stages.of(r)
    if s is None or s.round.launches <= 0:
        return None
    return s.round.dispatch_ms * 1e3 / s.round.launches
