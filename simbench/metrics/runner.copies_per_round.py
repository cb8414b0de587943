"""Copies between host and device (the profiler's ``Memcpy HtoD`` and
``Memcpy DtoH`` operations) launched inside the program's ``round`` spans,
a round: the round loop's sync sites as counted events.  0 where a round
makes none.  From the traced run's spans pass (``simbench/stages.py``)."""

from simbench import stages


def read(r):
    s = stages.of(r)
    if s is None or s.rounds <= 0 or s.round.launches <= 0:
        return None
    return s.round.copies / s.rounds
