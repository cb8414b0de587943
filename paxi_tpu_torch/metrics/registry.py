"""The host registry's histogram layout (the port's copy of the bounds and
scheme of the JAX package's ``metrics/registry.py``).

One fixed bucket layout for every histogram: log-spaced bounds, 6
buckets a decade from 1 µs to 1000 s, plus an overflow bucket.  A shared
layout is what makes merging exact, so a sim histogram converted by
``lathist.to_host_snapshot`` merges with the host runtime's snapshots;
changing it breaks that (the snapshot carries the scheme's name).
"""

from __future__ import annotations

from typing import Tuple

HIST_SCHEME = "log6:1e-6:54"
HIST_BOUNDS: Tuple[float, ...] = tuple(
    1e-6 * 10.0 ** ((i + 1) / 6.0) for i in range(54))
