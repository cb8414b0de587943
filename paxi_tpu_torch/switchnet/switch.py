"""Host half of the in-fabric consensus tier: a programmable-switch
acceptor + NOPaxos-style ordered-multicast sequencer the virtual-clock
fabric (host/fabric.py) interposes on the wire.

"Paxos Made Switch-y" / "Network Hardware-Accelerated Consensus"
(PAPERS.md) move acceptor and sequencer logic into the network data
plane; here the data plane IS the fabric's ``submit`` path, so the
tier sees every send mid-flight, exactly where a P4 switch would:

- frames whose class declares ``switchnet_role = "p1a"`` raise the
  switch's ballot promise and trigger a ``SwitchSnap`` register read
  back to the candidate (recovery MUST consult the registers — the
  PXQ505 obligation);
- frames with ``switchnet_role = "p2a"`` are VOTED on in flight
  (bounded ballot/value register file, ``Paxos made switch-y``'s
  acceptor) and STAMPED with a monotone (session, sequence) pair
  (NOPaxos's ordered multicast) — the ``SwitchVote`` injected back to
  the sender arrives after one fabric delivery, which is the
  commit-path round the tier removes;
- everything else passes through untouched.

State is the same bounded register file the sim kernel threads through
its scan carry (switchnet/plane.py — one contract, two runtimes):
``W = sw_window`` slots of (vballot, value, seq) plus the scalar
promise and sequence counter.  Eviction is execution-gated via
``note_execute`` (the replicas report their frontiers on frames they
send; the tier keeps the min), overflow falls back to the replica
majority path, and sequencer churn (down windows + session bumps,
from a Scenario's ``SwitchChurn``) pauses voting/stamping while the
registers and the promise persist.

Determinism: the tier is a pure state machine over the fabric's
submission order — no RNG, no wall clock — so two replays of one
schedule produce byte-identical stamp logs (``stamp_log``), which is
the fabric-level ordered-multicast determinism contract the tests
pin.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.scenarios.schedule import (switch_down_at,
                                         switch_session_at)

NO_CMD: Any = None   # empty value register (host frames carry batches)
NO_SEQ = -1


@register_message
@dataclass
class SwitchVote:
    """The switch's in-network acceptance of one (ballot, slot) frame,
    injected back to the frame's sender: the leader commits on it
    after ONE fabric delivery.  Carries the ordered-multicast stamp so
    the leader learns its frames' sequence numbers (gap-agreement
    lookups, P3 stamps)."""

    ballot: int
    slot: int
    sess: int = 0
    seq: int = NO_SEQ


@register_message
@dataclass
class SwitchSnap:
    """Register read for recovery, injected back to a phase-1
    candidate: the switch's promise plus every occupied register as
    ``slot -> [vballot, frame payload, seq]``."""

    ballot: int
    base: int = 0
    regs: Dict[int, list] = field(default_factory=dict)


@dataclass
class _Reg:
    vbal: int = 0
    vcmd: Any = NO_CMD
    seq: int = NO_SEQ


class SwitchAcceptor:
    """The bounded acceptor register file (one consensus group)."""

    def __init__(self, window: int):
        self.window = int(window)
        self.bal = 0                      # ballot promise
        self.base = 0                     # abs slot of register 0
        self.regs: List[_Reg] = [_Reg() for _ in range(self.window)]
        self.overflows = 0

    def promise(self, ballot: int) -> None:
        self.bal = max(self.bal, int(ballot))

    def reg_at(self, slot: int) -> Optional[_Reg]:
        rel = slot - self.base
        return self.regs[rel] if 0 <= rel < self.window else None

    def vote(self, ballot: int, slot: int, cmd) -> Optional[_Reg]:
        """Vote on a frame in flight: register (ballot, value) when
        ``ballot`` meets the promise and the slot is in the file.
        Returns the register (the vote) or None (stale ballot, or
        overflow -> the replica fall-back path)."""
        if ballot < self.bal:
            return None
        r = self.reg_at(slot)
        if r is None:
            self.overflows += 1
            return None
        self.bal = ballot
        if ballot >= r.vbal:
            if ballot > r.vbal:
                r.seq = NO_SEQ     # a higher ballot re-stamps
            r.vbal, r.vcmd = ballot, cmd
        return r

    def evict(self, min_execute: int) -> None:
        """Execution-gated eviction: recycle registers only below the
        slowest replica's execute frontier (plane.py contract)."""
        adv = min_execute - self.base
        if adv <= 0:
            return
        if adv >= self.window:
            self.regs = [_Reg() for _ in range(self.window)]
        else:
            self.regs = self.regs[adv:] + [_Reg() for _ in range(adv)]
        self.base = min_execute

    def snapshot(self) -> Dict[int, list]:
        return {self.base + i: [r.vbal, r.vcmd, r.seq]
                for i, r in enumerate(self.regs) if r.vbal > 0}


class Sequencer:
    """Monotone ordered-multicast stamping; the session epoch comes
    from the churn schedule (failover = the standby taking over)."""

    def __init__(self):
        self.next_seq = 0

    def stamp(self, reg: _Reg) -> int:
        """Assign the frame's sequence number, once per registered
        (ballot, slot): a retransmit keeps its original stamp."""
        if reg.seq == NO_SEQ:
            reg.seq = self.next_seq
            self.next_seq += 1
        return reg.seq


class SwitchTier:
    """The fabric interposition: acceptor + sequencer + churn schedule.

    ``churn`` is a Scenario ``SwitchChurn`` (or None for an always-up
    switch).  Install with ``fabric.install_switch(tier)``; the fabric
    calls ``on_send`` for every submission and delivers the returned
    ``(dst, msg)`` injections one logical step out (exactly the sim's
    one-delivery vote visibility)."""

    def __init__(self, window: int = 16, churn=None,
                 n_replicas: Optional[int] = None):
        self.acceptor = SwitchAcceptor(window)
        self.seqr = Sequencer()
        self.churn = churn
        # eviction is min-over-ALL-frontiers: until every replica has
        # gossiped at least once, a partial min could overestimate and
        # evict a register whose slot a silent laggard still needs
        self.n_replicas = n_replicas
        self._exec: Dict[str, int] = {}
        # one register read per (candidate, ballot): a P1a broadcast
        # submits the same frame once per destination edge
        self._snapped: Dict[str, int] = {}
        self.stats = {"votes": 0, "stamps": 0, "snaps": 0,
                      "passed_down": 0}
        # (step, sess, seq, ballot, slot) per stamp — the determinism
        # contract's witness (byte-identical across replays)
        self.stamp_log: List[Tuple[int, int, int, int, int]] = []

    # ---- churn schedule --------------------------------------------------
    def down(self, step: int) -> bool:
        c = self.churn
        return c is not None and switch_down_at(c.start, c.period,
                                                c.down_for, step)

    def session(self, step: int) -> int:
        c = self.churn
        if c is None:
            return 0
        return switch_session_at(c.start, c.period, c.down_for, step)

    # ---- execution-frontier gossip --------------------------------------
    def note_execute(self, src: str, execute: int) -> None:
        self._exec[src] = max(self._exec.get(src, 0), int(execute))
        if self.n_replicas is not None and \
                len(self._exec) < self.n_replicas:
            return
        self.acceptor.evict(min(self._exec.values()))

    # ---- the data plane --------------------------------------------------
    def on_send(self, step: int, src: str, dst: str,
                msg: Any) -> List[Tuple[str, Any]]:
        """One frame passing the switch.  May stamp ``msg`` in place
        (all broadcast copies share the object, so the stamp is
        frame-wide) and returns injections to deliver next step."""
        role = getattr(type(msg), "switchnet_role", None)
        if role is None:
            return []
        ex = getattr(msg, "execute", None)
        if ex is not None:
            self.note_execute(src, ex)
        if role == "p1a":
            self.acceptor.promise(msg.ballot)
            if self._snapped.get(src, -1) >= msg.ballot:
                return []   # same election's other broadcast copies
            self._snapped[src] = msg.ballot
            self.stats["snaps"] += 1
            return [(src, SwitchSnap(self.acceptor.bal,
                                     self.acceptor.base,
                                     self.acceptor.snapshot()))]
        if role != "p2a":
            return []
        if self.down(step):
            self.stats["passed_down"] += 1
            return []
        reg = self.acceptor.vote(msg.ballot, msg.slot,
                                 getattr(msg, "cmds", None))
        if reg is None or reg.vbal != msg.ballot:
            return []   # stale ballot or overflow: pass through unvoted
        first = reg.seq == NO_SEQ
        seq = self.seqr.stamp(reg)
        sess = self.session(step)
        msg.sess, msg.seq = sess, seq
        if not first:
            return []   # a retransmit: stamped, but vote already sent
        self.stats["votes"] += 1
        self.stats["stamps"] += 1
        self.stamp_log.append((step, sess, seq, msg.ballot, msg.slot))
        return [(src, SwitchVote(msg.ballot, msg.slot, sess, seq))]
