"""The 90th percentile (nearest rank) of every round's device-clock time
in the window, a new episode's set-up counted in its first round: what a
user waits on per lock-step round, stalls included."""

import math


def read(w):
    if not w.round_ms:
        return None
    ordered = sorted(w.round_ms)
    return ordered[max(math.ceil(0.9 * len(ordered)), 1) - 1]
