"""Device milliseconds per round of the operations launched inside the
safety oracles (``proto.invariants``; the in-round spot-check runs inside
the step), in the traced run's layer pass."""


def read(r):
    us = r.ranges.get("invariants", 0.0)
    if us <= 0 or r.rounds <= 0:
        return None
    return us / 1e3 / r.rounds
