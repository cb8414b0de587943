"""Device milliseconds per round of the operations launched inside the
fault schedule and its draws (``lanes.fault_state_refresh``,
``mailbox.draw_edge_faults``: the threefry hash emulated in int64), in
the traced run's layer pass."""


def read(r):
    us = r.ranges.get("faults", 0.0)
    if us <= 0 or r.rounds <= 0:
        return None
    return us / 1e3 / r.rounds
