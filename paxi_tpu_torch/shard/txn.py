"""Cross-shard transactions: 2PC with per-group Paxos as the
participant log.

A transaction whose ops span several consensus groups cannot ride one
group's log (the single-command Transaction surface only totally
orders within a group).  This coordinator runs classic presumed-abort
two-phase commit where EVERY durable 2PC state transition is an
ordered command in some group's log (core/command.pack_tpc records,
interpreted by ``Database._execute_tpc``):

1. **prepare** fan-out — one prepare record per participant group,
   carrying that group's ops.  The record replicates through the
   group's batch-per-slot pipeline like any client write; its
   execution stages the ops and votes (NO on a staged-key conflict
   with another in-flight txn).
2. **decide** — the commit/abort decision is made durable as a decide
   record in the txn's HOME group (lowest participating group id).
   ``Database`` applies the FIRST decide record for a txid and replies
   with the winner, so the decision point is one totally-ordered log
   entry: whoever's decide record sorts first in the home log — the
   live coordinator's or a recovery's — IS the outcome, and the loser
   learns it from its own record's reply.
3. **commit/abort** fan-out — participants apply or drop their stage.

**Coordinator recovery** (the mid-2PC kill path): a recovering party
first waits out ``lease_s`` — the same leader-lease bound that fences
``cfg.leader_reads`` (a live coordinator whose decide is in flight
reaches its home leader within the lease envelope) — then writes
``decide(abort)`` to the home group.  First-wins turns the race into
log order: if the dead coordinator's decide(commit) landed, recovery's
abort LOSES and recovery completes the commit fan-out; otherwise abort
wins and recovery aborts the stragglers.  Either way every group
converges on one outcome — the atomicity the fabric-replayed
coordinator-kill tests pin (``SHARD_ROUTER_CASES``).

Scope note: staged 2PC state rides each replica's ordered log AND the
P1b auxiliary snapshot (``Database.aux_snapshot`` / ``restore_aux``,
carried in the paxos P1b seam) — a leader elected across a frontier
jump restores in-doubt stages, decides, and migration windows from
the ahead acker instead of dropping them, so an election between
prepare and decide no longer loses staged ops (the fabric-replayed
election regression test pins this); elections
without frontier jumps still re-propose the records like any
uncommitted slot.

The coordinator is transport-agnostic: ``submit(group, key, record)``
— ``record`` a plain ``{"kind", "txid", "ops"?, "outcome"?}`` dict —
returns an awaitable resolving to ``(ok, payload)``; each transport
encodes the record ONCE in its own wire form.  The shard router backs
it with POST /tpc over dedicated group connections; the fabric tests
back it with ``pack_tpc`` + direct ``handle_client_request``
injection.
"""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paxi_tpu_torch.core.command import unpack_values

_txn_counter = itertools.count(1)

# ops for one group: [(key, value)] — empty value = read
GroupOps = List[Tuple[int, bytes]]


class CoordinatorKilled(Exception):
    """Test hook: the coordinator 'crashed' at a scripted 2PC point
    (hunt/cases.py SHARD_ROUTER_CASES); carries what the recovery
    needs to take over."""

    def __init__(self, txid: str, parts: Dict[int, GroupOps],
                 point: str):
        super().__init__(f"coordinator killed {point} ({txid})")
        self.txid = txid
        self.parts = parts
        self.point = point


@dataclass
class TxnOutcome:
    txid: str
    committed: bool
    # per-group prepare-point previous values, in each group's op
    # order (only meaningful on commit)
    values: Dict[int, List[bytes]] = field(default_factory=dict)
    err: str = ""


class ShardCoordinator:
    """Drives 2PC rounds over an injected submit transport."""

    # outcome fan-out retries before giving up on a participant (the
    # decide record is already durable by then, so a straggler is an
    # availability problem recover() can finish, never an atomicity one)
    FINISH_RETRIES = 3

    def __init__(self, submit, lease_s: float = 0.2,
                 metrics=None, tag: str = "c", spans=None):
        self._submit = submit
        self.lease_s = lease_s
        self._tag = tag
        # obs.SpanCollector (or None): a traced transaction opens one
        # span per 2PC record, and the record's child context rides
        # rec["trace"] to the participant — the cross-shard stitch
        self._spans = spans
        reg = metrics
        self._m = {
            k: (reg.counter(f"paxi_tpc_{k}_total") if reg is not None
                else None)
            for k in ("txns", "committed", "aborted", "recovered",
                      "fanout_incomplete")}

    def _count(self, k: str) -> None:
        c = self._m[k]
        if c is not None:
            c.inc()

    def new_txid(self) -> str:
        return f"2pc-{self._tag}-{next(_txn_counter)}"

    @staticmethod
    def home_of(parts: Dict[int, GroupOps]) -> int:
        return min(parts)

    async def _record(self, group: int, key: int, kind: str, txid: str,
                      ops: Optional[GroupOps] = None,
                      outcome: str = "",
                      trace=None) -> Tuple[bool, bytes]:
        rec: dict = {"kind": kind, "txid": txid}
        if ops is not None:
            rec["ops"] = ops
        if outcome:
            rec["outcome"] = outcome
        sp = None
        if self._spans is not None and trace is not None:
            sp = self._spans.start(kind, trace, group=str(group),
                                   txid=txid)
            if sp is not None:
                rec["trace"] = sp.child().encode()
        try:
            return await self._submit(group, key, rec)
        finally:
            if self._spans is not None:
                self._spans.finish(sp)

    async def run_txn(self, parts: Dict[int, GroupOps],
                      txid: Optional[str] = None,
                      crash_at: Optional[str] = None,
                      trace=None) -> TxnOutcome:
        """One 2PC round over ``parts`` (group -> its ops).

        ``crash_at`` (tests only): ``"mid_prepare"`` dies with only
        the home group's prepare sent, ``"after_prepare"`` after all
        prepares, ``"after_decide"`` after the decide record,
        ``"mid_commit"`` after the home group's outcome record."""
        if not parts:
            return TxnOutcome("", False, err="empty transaction")
        txid = txid or self.new_txid()
        self._count("txns")
        home = self.home_of(parts)
        groups = sorted(parts)
        if crash_at == "mid_prepare":
            await self._record(home, parts[home][0][0], "prepare",
                               txid, ops=parts[home], trace=trace)
            raise CoordinatorKilled(txid, parts, crash_at)
        votes = await asyncio.gather(*[
            self._record(g, parts[g][0][0], "prepare", txid,
                         ops=parts[g], trace=trace) for g in groups])
        yes = all(ok and payload.startswith(b"yes:")
                  for ok, payload in votes)
        if crash_at == "after_prepare":
            raise CoordinatorKilled(txid, parts, crash_at)
        outcome = await self._decide(parts, txid, "c" if yes else "a",
                                     trace=trace)
        if crash_at == "after_decide":
            raise CoordinatorKilled(txid, parts, crash_at)
        stragglers = await self._finish(parts, txid, outcome,
                                        crash_at=crash_at, trace=trace)
        if outcome != "c":
            self._count("aborted")
            return TxnOutcome(txid, False, err="aborted (conflict)"
                              if not yes else "aborted (decided)")
        self._count("committed")
        values = {g: unpack_values(votes[i][1][len(b"yes:"):])
                  for i, g in enumerate(groups)}
        # the decide record made the outcome durable, so the txn IS
        # committed even if a participant's outcome record could not
        # be delivered — surface the gap (a recover() pass or the
        # group's own log healing finishes it) instead of hiding it
        err = (f"commit fan-out incomplete: groups {stragglers} "
               f"unreachable (recover() completes them)"
               if stragglers else "")
        return TxnOutcome(txid, True, values=values, err=err)

    async def _decide(self, parts: Dict[int, GroupOps], txid: str,
                      want: str, trace=None) -> str:
        """Write the decide record to the home group; the reply is the
        WINNING outcome (first decide in the home log wins)."""
        home = self.home_of(parts)
        ok, payload = await self._record(home, parts[home][0][0],
                                         "decide", txid, outcome=want,
                                         trace=trace)
        if not ok:
            raise IOError(f"2pc decide({txid}) unreachable: "
                          f"{payload!r}")
        return payload.decode() or "a"

    async def _finish(self, parts: Dict[int, GroupOps], txid: str,
                      outcome: str,
                      crash_at: Optional[str] = None,
                      trace=None) -> List[int]:
        """Fan the outcome record to every participant, retrying each
        failed delivery ``FINISH_RETRIES`` times.  Returns the groups
        still unreached (counted; the caller reports them — the
        outcome itself is already durable in the home log)."""
        kind = "commit" if outcome == "c" else "abort"
        home = self.home_of(parts)
        if crash_at == "mid_commit":
            await self._record(home, parts[home][0][0], kind, txid,
                               trace=trace)
            raise CoordinatorKilled(txid, parts, crash_at)
        left = sorted(parts)
        for _ in range(1 + self.FINISH_RETRIES):
            if not left:
                break
            results = await asyncio.gather(*[
                self._record(g, parts[g][0][0], kind, txid, trace=trace)
                for g in left])
            left = [g for g, (ok, _) in zip(left, results) if not ok]
        if left:
            self._count("fanout_incomplete")
        return left

    async def recover(self, txid: str,
                      parts: Dict[int, GroupOps],
                      trace=None) -> str:
        """Take over an in-doubt txn after a coordinator death: fence
        out the (possibly still live) coordinator's decide window,
        force a decide(abort) — first-wins reports the truth — and
        drive every participant to the winning outcome.  Returns the
        outcome ("c"/"a")."""
        fence = self.lease_s
        if fence > 0:
            await asyncio.sleep(fence)
        outcome = await self._decide(parts, txid, "a", trace=trace)
        await self._finish(parts, txid, outcome, trace=trace)
        self._count("recovered")
        self._count("committed" if outcome == "c" else "aborted")
        return outcome


def partition_ops(shard_map, ops: List[Tuple[int, bytes]]
                  ) -> Dict[int, GroupOps]:
    """Split a transaction's ops by owning group under one map
    snapshot, preserving each group's op order."""
    parts: Dict[int, GroupOps] = {}
    for k, v in ops:
        parts.setdefault(shard_map.group_of(k), []).append((int(k), v))
    return parts


def atomic_check(reads_by_group: Dict[int, List[Tuple[bytes, bytes]]]
                 ) -> bool:
    """The 2PC atomicity oracle: given each group's (expected txn
    value, observed value) pairs for one txid, every op observed the
    txn's write or none did."""
    applied = [obs == want
               for pairs in reads_by_group.values()
               for want, obs in pairs]
    return all(applied) or not any(applied)
