"""Device milliseconds per round of the operations launched inside the
protocol's transition (``proto.step``: every handler, and epaxos's
execution block with its closure kernel), in the traced run's layer
pass."""


def read(r):
    us = r.ranges.get("protocol_step", 0.0)
    if us <= 0 or r.rounds <= 0:
        return None
    return us / 1e3 / r.rounds
