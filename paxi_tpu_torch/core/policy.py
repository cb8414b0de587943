"""Object-stealing policies for WPaxos.

Reference: paxi policy.go — a ``Policy`` interface that tracks per-key
access hits by zone and decides when ownership should move; the
implementations select on ``Config.Policy`` + ``Config.Threshold``:
``consecutive`` fires after N consecutive hits from the same zone,
``majority`` (EMA-style) fires when a zone's share of recent hits
crosses a ratio threshold within a time window.

Used from the requester side here: each replica records *its own* demand
for keys it does not own; when the policy fires the replica launches a
phase-1 steal (wpaxos/host.py).  The sim kernel's ``hits`` counters
(wpaxos/sim.py) are the vectorized form of the same surface.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class Policy:
    """Per-key decision: feed zone hits, fire when ownership should move."""

    def hit(self, zone: int, now: Optional[float] = None) -> Optional[int]:
        """Record an access from ``zone``; return the zone that should own
        the object now, or None to leave ownership alone."""
        raise NotImplementedError


class ConsecutivePolicy(Policy):
    """policy.go's 'consecutive': N back-to-back hits from one zone."""

    def __init__(self, threshold: float):
        self.threshold = max(int(threshold), 1)
        self.zone = -1
        self.count = 0

    def hit(self, zone: int, now: Optional[float] = None) -> Optional[int]:
        if zone == self.zone:
            self.count += 1
        else:
            self.zone = zone
            self.count = 1
        if self.count >= self.threshold:
            self.count = 0
            return zone
        return None


class MajorityPolicy(Policy):
    """policy.go's 'majority': a zone holding > threshold share of the
    hits inside a sliding time window (EMA-flavored bookkeeping)."""

    def __init__(self, threshold: float, interval_s: float = 1.0):
        # threshold given as a count (paxi uses ints) acts as a minimum
        # hit count; given as a ratio <= 1 it acts as a share
        self.threshold = threshold
        self.interval = interval_s
        self.hits: Dict[int, int] = {}
        self.t0 = None

    def hit(self, zone: int, now: Optional[float] = None) -> Optional[int]:
        now = time.time() if now is None else now
        if self.t0 is None:
            self.t0 = now
        self.hits[zone] = self.hits.get(zone, 0) + 1
        if now - self.t0 < self.interval:
            return None
        total = sum(self.hits.values())
        best = max(self.hits, key=self.hits.get)
        share = self.hits[best] / total
        need = self.threshold if self.threshold <= 1 else 0.5
        min_hits = self.threshold if self.threshold > 1 else 1
        self.hits.clear()
        self.t0 = now
        if share > need and total >= min_hits:
            return best
        return None


def new_policy(name: str, threshold: float) -> Policy:
    """Reference: policy.go's factory keyed by Config.Policy."""
    if name == "consecutive":
        return ConsecutivePolicy(threshold)
    if name in ("majority", "ema"):
        return MajorityPolicy(threshold)
    raise KeyError(f"unknown policy {name!r}; have consecutive, majority")
