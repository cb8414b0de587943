"""Versioned key-range -> consensus-group mapping (the routing table).

Paxi's multi-leader layouts partition the key space statically per
deployment; the compartmentalization papers scale aggregate throughput
by adding independent instances of the bottleneck role behind such a
partition.  ``ShardMap`` is that partition as a VALUE: an immutable
list of contiguous ranges over a fixed key-space modulus, stamped with
a monotonically increasing ``version``.  Mutation (``move_range`` —
the control-plane half of wpaxos-style key stealing; data migration is
a follow-up) returns a NEW map with ``version + 1``; the router swaps
the reference under its lock (shard/router.py), so every routing
decision reads one consistent snapshot and a mid-pipeline bump is
detectable by epoch comparison (the stale-epoch reroute path).

Keys outside ``[0, span)`` fold in by modulo, so the unbounded int key
surface of the KV API routes deterministically.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

DEFAULT_SPAN = 1 << 20

# one in-flight range handoff: [lo, hi) moving from group ``src`` to
# group ``dst`` while ``src`` still OWNS the range (double-write
# window; shard/migrate.py)
Migration = Tuple[int, int, int, int]      # (lo, hi, src, dst)


@dataclass(frozen=True)
class ShardMap:
    """``starts[i]`` begins the i-th range (``starts[0] == 0``); range
    i covers ``[starts[i], starts[i+1])`` (the last runs to ``span``)
    and is owned by ``groups[i]``.  ``migrations`` lists the in-flight
    handoffs: ownership (and reads) stay with ``src``, but routers
    duplicate writes in the range to ``dst`` — the double-write window
    between a migration's fence and its cutover."""

    version: int
    span: int
    starts: Tuple[int, ...]
    groups: Tuple[int, ...]
    migrations: Tuple[Migration, ...] = ()

    @staticmethod
    def static(n_groups: int, span: int = DEFAULT_SPAN) -> "ShardMap":
        """The Paxi-style static layout: ``n_groups`` equal ranges."""
        if n_groups < 1 or span < n_groups:
            raise ValueError(f"bad shard layout: {n_groups} groups "
                             f"over span {span}")
        starts = tuple((span * g) // n_groups for g in range(n_groups))
        return ShardMap(version=1, span=span, starts=starts,
                        groups=tuple(range(n_groups)))

    @property
    def n_groups(self) -> int:
        return max(self.groups) + 1

    def group_of(self, key: int) -> int:
        """The owning group of ``key`` (modulo-folded into the span)."""
        k = int(key) % self.span
        return self.groups[bisect.bisect_right(self.starts, k) - 1]

    def ranges_of(self, group: int) -> List[Tuple[int, int]]:
        """The [lo, hi) ranges a group owns (diagnostics/migration)."""
        out = []
        for i, g in enumerate(self.groups):
            if g == group:
                hi = self.starts[i + 1] if i + 1 < len(self.starts) \
                    else self.span
                out.append((self.starts[i], hi))
        return out

    def move_range(self, lo: int, hi: int, group: int) -> "ShardMap":
        """A new map (version + 1) with ``[lo, hi)`` owned by
        ``group`` — the key-stealing control-plane primitive."""
        if not (0 <= lo < hi <= self.span):
            raise ValueError(f"bad range [{lo}, {hi}) over span "
                             f"{self.span}")
        if group < 0:
            raise ValueError(f"bad group {group}")
        points = sorted({*self.starts, lo, hi} - {self.span})
        starts: List[int] = []
        groups: List[int] = []
        for p in points:
            g = group if lo <= p < hi else self.group_of(p)
            if groups and groups[-1] == g:
                continue          # coalesce adjacent equal ranges
            starts.append(p)
            groups.append(g)
        return ShardMap(version=self.version + 1, span=self.span,
                        starts=tuple(starts), groups=tuple(groups),
                        migrations=self.migrations)

    # ---- live-migration control plane (shard/migrate.py) ---------------
    def migration_of(self, key: int) -> Optional[Migration]:
        """The in-flight handoff covering ``key`` (modulo-folded), or
        None — the router's double-write test, so it belongs to the
        fenced-read proof surface like ``group_of``."""
        k = int(key) % self.span
        for m in self.migrations:
            if m[0] <= k < m[1]:
                return m
        return None

    def with_migration(self, lo: int, hi: int, dst: int) -> "ShardMap":
        """A new map (version + 1) opening the double-write window for
        ``[lo, hi)`` toward ``dst``.  Ownership does NOT change — that
        is ``complete_migration`` — but routers seeing this map
        duplicate the range's writes to both groups."""
        if not (0 <= lo < hi <= self.span):
            raise ValueError(f"bad range [{lo}, {hi}) over span "
                             f"{self.span}")
        src = self.group_of(lo)
        if any(self.group_of(k) != src
               for k in self.starts if lo < k < hi):
            raise ValueError(f"range [{lo}, {hi}) spans several owner "
                             f"groups")
        if src == dst:
            raise ValueError(f"range [{lo}, {hi}) already owned by "
                             f"group {dst}")
        if any(m[0] < hi and lo < m[1] for m in self.migrations):
            raise ValueError(f"range [{lo}, {hi}) overlaps an "
                             f"in-flight migration")
        return replace(self, version=self.version + 1,
                       migrations=self.migrations + ((lo, hi, src,
                                                      dst),))

    def complete_migration(self, lo: int, hi: int) -> "ShardMap":
        """Cutover: a new map (version + 1) with ``[lo, hi)`` owned by
        its migration's ``dst`` and the window closed."""
        mig = next((m for m in self.migrations
                    if (m[0], m[1]) == (lo, hi)), None)
        if mig is None:
            raise ValueError(f"no in-flight migration for [{lo}, {hi})")
        rest = tuple(m for m in self.migrations if m is not mig)
        return replace(self.move_range(lo, hi, mig[3]),
                       migrations=rest)

    # ---- (de)serialization (the /shardmap wire form) -------------------
    def to_json(self) -> dict:
        d = {"version": self.version, "span": self.span,
             "starts": list(self.starts), "groups": list(self.groups)}
        if self.migrations:
            d["migrations"] = [list(m) for m in self.migrations]
        return d

    @staticmethod
    def from_json(d) -> "ShardMap":
        if isinstance(d, (str, bytes)):
            d = json.loads(d)
        m = ShardMap(version=int(d["version"]), span=int(d["span"]),
                     starts=tuple(int(s) for s in d["starts"]),
                     groups=tuple(int(g) for g in d["groups"]),
                     migrations=tuple(
                         tuple(int(x) for x in mg)
                         for mg in d.get("migrations", [])))
        m.validate()
        return m

    def validate(self) -> None:
        if not self.starts or self.starts[0] != 0 \
                or list(self.starts) != sorted(set(self.starts)) \
                or len(self.starts) != len(self.groups) \
                or self.starts[-1] >= self.span \
                or any(g < 0 for g in self.groups):
            raise ValueError(f"inconsistent ShardMap: {self.to_json()}")
        for lo, hi, src, dst in self.migrations:
            if not (0 <= lo < hi <= self.span) or src == dst \
                    or dst < 0 or self.group_of(lo) != src \
                    or any(self.group_of(k) != src
                           for k in self.starts if lo < k < hi):
                raise ValueError(
                    f"inconsistent migration ({lo}, {hi}, {src}, "
                    f"{dst}) in ShardMap: {self.to_json()}")
