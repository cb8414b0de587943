"""Host milliseconds a round inside CUDA API calls within
the program's ``round`` spans (the recorder's own event calls apart): each
launch's cost plus any wait on a full launch queue or on a copy.  From the
traced run's spans pass (``simbench/stages.py``)."""

from simbench import stages


def read(r):
    s = stages.of(r)
    if s is None or s.rounds <= 0 or s.round.runtime_calls <= 0:
        return None
    return s.round.runtime_ms / s.rounds
