"""Host milliseconds a round inside the program's ``round`` spans less the
time inside CUDA API calls there: what Python and ATen
dispatch take a round.  From the traced run's spans pass
(``simbench/stages.py``): the first episode again with the round loop's
own spans, under the profiler's device activity."""

from simbench import stages


def read(r):
    s = stages.of(r)
    if s is None or s.rounds <= 0 or s.round.launches <= 0:
        return None
    return s.round.dispatch_ms / s.rounds
