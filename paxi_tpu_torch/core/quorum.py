"""Quorum bookkeeping.

Reference: paxi quorum.go — ``Quorum{size, acks, zones}`` with ``ACK(id)``,
``Majority()``, fast quorum (ceil(3N/4), EPaxos), zone quorums
(``ZoneMajority``) and flexible grid quorums (Q1 rows x Q2 columns,
WPaxos).  This host-side class mirrors that surface; the sim runtime's
equivalent is a bit-packed int32 ack mask per quorum site (see the
protocol kernels, e.g. protocols/paxos/sim.py ``p1_acks``/``log_acks``)
— Quorum.ACK lifts to a bitwise-or, Majority() to a population-count
compare.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Set

from paxi_tpu_torch.core.ident import ID


class Quorum:
    def __init__(self, ids: Iterable[ID]):
        self.ids = [ID(i) for i in ids]
        self.n = len(self.ids)
        self.acks: Set[ID] = set()
        self.zone_counts: Dict[int, int] = {}
        self._zone_sizes: Dict[int, int] = {}
        for i in self.ids:
            self._zone_sizes[i.zone] = self._zone_sizes.get(i.zone, 0) + 1

    # ---- recording ----------------------------------------------------
    def ack(self, id: ID) -> None:
        """Reference: quorum.go Quorum.ACK [driver]."""
        id = ID(id)
        if id not in self.acks:
            self.acks.add(id)
            self.zone_counts[id.zone] = self.zone_counts.get(id.zone, 0) + 1

    def nack(self, id: ID) -> None:
        id = ID(id)
        if id in self.acks:
            self.acks.discard(id)
            self.zone_counts[id.zone] -= 1

    def reset(self) -> None:
        self.acks.clear()
        self.zone_counts.clear()

    # ---- predicates ---------------------------------------------------
    def size(self) -> int:
        return len(self.acks)

    def majority(self) -> bool:
        return len(self.acks) > self.n // 2

    def fast_quorum(self) -> bool:
        """EPaxos fast path: ceil(3N/4) acks."""
        return len(self.acks) >= math.ceil(3 * self.n / 4)

    def all(self) -> bool:
        return len(self.acks) == self.n

    def zone_majority(self, zone: int) -> bool:
        """Majority within one zone."""
        zs = self._zone_sizes.get(zone, 0)
        return zs > 0 and self.zone_counts.get(zone, 0) > zs // 2

    def grid_q1(self, q1: int) -> bool:
        """WPaxos flexible grid phase-1: a zone-majority in each of >= q1
        zones (a 'row' of the grid)."""
        good = sum(1 for z in self._zone_sizes if self.zone_majority(z))
        return good >= q1

    def grid_q2(self, q2: int) -> bool:
        """WPaxos flexible grid phase-2: a zone-majority in each of >= q2
        zones, with q1 + q2 > #zones guaranteeing intersection."""
        return self.grid_q1(q2)

    # ---- BPaxos rectangular grid (protocols/bpaxos) -------------------
    # The id list (sorted acceptor ids) is read as a row-major
    # rows x cols grid: id index i sits at (i // cols, i % cols).  The
    # write quorum is ONE FULL ROW, the read quorum ONE FULL COLUMN —
    # any row and any column of the same grid share exactly one cell,
    # so every read/write pair intersects structurally (paxi-lint's
    # PXQ rowcol proof checks both sites derive the grid from the same
    # ``cols``, and that the predicates demand complete lines).  This
    # is also the *thrifty* grid: a proposer messages exactly the
    # quorum, never the whole acceptor set.
    def grid_row(self, cols: int) -> bool:
        """BPaxos write/accept quorum: every member of >= 1 grid row."""
        rows = [self.ids[i:i + cols] for i in range(0, self.n, cols)]
        return any(all(m in self.acks for m in row) for row in rows)

    def grid_col(self, cols: int) -> bool:
        """BPaxos read/recovery quorum: every member of >= 1 column."""
        return any(all(m in self.acks for m in self.ids[c::cols])
                   for c in range(cols))


def majority_size(n: int) -> int:
    return n // 2 + 1


def fast_quorum_size(n: int) -> int:
    return math.ceil(3 * n / 4)
