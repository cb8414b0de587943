"""Compile a Scenario into the sim's schedule planes (the port's copy of
the JAX package's ``scenarios/schedule.py``).

Pure functions of ``(scenario, t, shapes)`` that the exchange layer
(``sim/mailbox.py``, ``sim/lanes.py``) folds into its fault draws.  They
are deterministic in the step index ``t``, and draw nothing beyond the
jitter (which reuses the delay key the scenario-free path splits), so the
runner can record the materialized planes and a pinned replay can
substitute them bit for bit.

``delay_base(scn, n)`` is the static (src, dst) plane of per-edge
latencies from the zone matrix; ``forced_crash(scn, t, n, device)`` is
the (n,) comms-dead overlay from churn, zone outages and reconfiguration
epochs, OR-ed into the crash plane every step.
"""

from __future__ import annotations

import numpy as np
import torch

from paxi_tpu_torch.scenarios.spec import Scenario, zone_of

# the overlay travels to the device as the bits of one int64 scalar, so a
# step builds it with no host-to-device copy (which would wait for the card)
_MAX_OVERLAY_REPLICAS = 62


def delay_base(scn: Scenario, n: int) -> np.ndarray:
    """(n, n) int32 per-edge latency plane from the zone matrix (all
    ones when the scenario has no zone latencies)."""
    if scn.zones is None:
        return np.ones((n, n), np.int32)
    zmap = zone_of(n, scn.n_zones)
    m = np.asarray(scn.zones.matrix, np.int32)
    zi = np.asarray(zmap)
    return m[zi[:, None], zi[None, :]].astype(np.int32)


def zone_mask(scn: Scenario, zone: int, n: int) -> np.ndarray:
    """(n,) bool membership mask for ``zone``."""
    return np.asarray([z == zone for z in zone_of(n, scn.n_zones)])


def forced_dead(scn: Scenario, t: int, n: int) -> list:
    """The comms-dead overlay at step ``t`` as a list of n bools.  Python's
    ``//`` and ``%`` floor like the reference's integer arrays, which
    matters for ``t - start < 0`` (the refresh asks for ``t - 1 = -1`` at
    step 0)."""
    dead = [False] * n
    c = scn.churn
    if c is not None:
        k = max(t - c.start, 0) // c.period
        phase = (t - c.start) % c.period
        if t >= c.start and phase < c.kill_for:
            dead[(c.first + k * c.stride) % n] = True
    for o in scn.outages:
        if o.t0 <= t < o.t1:
            zm = zone_mask(scn, o.zone, n)
            dead = [d or bool(z) for d, z in zip(dead, zm)]
    if scn.reconfig is not None and scn.reconfig.epochs:
        eps = scn.reconfig.epochs
        for i, (t0, live) in enumerate(eps):
            t1 = eps[i + 1][0] if i + 1 < len(eps) else None
            if t >= t0 and (t1 is None or t < t1):
                dead = [d or r not in live for r, d in enumerate(dead)]
    return dead


def forced_crash(scn: Scenario, t: int, n: int, device) -> torch.Tensor:
    """(n,) bool comms-dead overlay at step ``t`` on ``device``: churn +
    outages + reconfig, deterministic in ``t``; the caller ORs it into the
    crash plane every step."""
    if n > _MAX_OVERLAY_REPLICAS:
        raise ValueError(f"forced_crash: {n} replicas, at most "
                         f"{_MAX_OVERLAY_REPLICAS}")
    bits = sum(1 << r for r, d in enumerate(forced_dead(scn, t, n)) if d)
    ridx = torch.arange(n, dtype=torch.int64, device=device)
    return (torch.bitwise_right_shift(torch.full_like(ridx, bits), ridx)
            & 1) != 0


def crashed_plane(scn: Scenario, n: int, n_steps: int) -> np.ndarray:
    """(T, n) bool materialization of the overlay over a horizon."""
    return np.asarray([forced_dead(scn, t, n) for t in range(n_steps)],
                      dtype=bool).reshape(n_steps, n)


# ---- switchnet sequencer-churn schedule ---------------------------------

def switch_down_at(start: int, period: int, down_for: int, t: int) -> bool:
    """Is the switch's sequencer down at step ``t``?  ``period=0`` is a
    single failover window [start, start + down_for)."""
    if start < 0 or down_for < 1 or t < start:
        return False
    phase = (t - start) % period if period else (t - start)
    return phase < down_for


def switch_session_at(start: int, period: int, down_for: int,
                      t: int) -> int:
    """Ordered-multicast session epoch at step ``t``: bumps at each
    down-window END (the failover completing on the standby)."""
    if start < 0 or down_for < 1 or t < start + down_for:
        return 0
    if not period:
        return 1
    return 1 + (t - start - down_for) // period
