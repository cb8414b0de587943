"""Host dispatch milliseconds a round in the program's ``step`` stage
spans (``proto.step``): their host time less the time inside CUDA API
calls.  From the traced run's spans pass
(``simbench/stages.py``)."""

from simbench import stages


def read(r):
    s = stages.of(r)
    f = None if s is None else s.stages.get("step")
    if f is None or s.rounds <= 0 or f.launches <= 0:
        return None
    return f.dispatch_ms / s.rounds
