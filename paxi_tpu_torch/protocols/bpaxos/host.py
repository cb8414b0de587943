"""Compartmentalized BPaxos replica for the host (deployment) runtime.

Reference: "Bipartisan Paxos" + "HT-Paxos" (PAPERS.md) — the same
protocol the sim kernel (sim.py) runs as masked array updates, in
event-driven form with **node-id role assignment** over the sorted
cluster ids:

- ids[0 .. n_proxies)                      -> proxy leaders
- ids[n_proxies .. n_proxies + rows*cols)  -> the acceptor grid
  (row-major: acceptor i sits at (i // cols, i % cols))
- the rest                                 -> replica executors

Proxy leaders own disjoint slot stripes (slot ``s`` belongs to proxy
``s % P``), so there is no global leader and no election: client
commands batch in a ``BatchBuffer`` (host/batch.py) and ONE grid round
decides the whole batch — a slot holds a command *list*, BP2a/BP3
carry it, and batch atomicity rides on slot atomicity (a BP2a reaches
an acceptor with the entire batch or not at all).

Quorums are the r x w grid (core/quorum.py ``grid_row``/``grid_col``):
a write needs ONE FULL ROW of acks, a recovery read ONE FULL COLUMN —
every row/column pair shares exactly one cell, which paxi-lint's PXQ
rowcol rule proves from both call sites.  Messaging is *thrifty*: a
proposal goes only to its target row, a recovery probe only to one
column.

Takeover recovery (gap strikes): a proxy that keeps learning commits
above a hole in the shared log (``_gap_strikes`` counts BP3s that land
while its execute frontier is stalled) runs classic per-slot Paxos
recovery at a fresh higher ballot — column read, adopt the
highest-ballot value (else NOOP = empty batch), row write.  Strike
thresholds stagger by stripe distance so the hole's owner retries
first; repeated strikes rotate the row/column so a crashed acceptor
is eventually avoided.  The ``noread`` twin module disables exactly
the column read (``RECOVERY_READS = False``) — the seeded bug the
hunt pipeline must reproduce.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paxi_tpu_torch.core.ballot import ballot, ballot_id
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.batch import BatchBuffer
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


def _wire_cmds(cmds: List[Command]) -> List[list]:
    return [[c.key, c.value, c.client_id, c.command_id] for c in cmds]


def _cmds_from_wire(wire) -> List[Command]:
    return [Command(int(k), v, cid, int(cmid)) for k, v, cid, cmid in wire]


def _idents(cmds: List[Command]) -> List[Tuple[str, int]]:
    return [(c.client_id, c.command_id) for c in cmds]


@register_message
@dataclass
class BP1a:
    """Recovery column-read probe for one slot."""

    ballot: int
    slot: int


@register_message
@dataclass
class BP1b:
    """An acceptor's promise + its accepted (ballot, batch) for the
    probed slot (vballot == 0: nothing accepted)."""

    ballot: int
    slot: int
    vballot: int
    cmds: list = field(default_factory=list)
    id: str = ""


@register_message
@dataclass
class BP2a:
    """One grid write round for one slot carrying a whole command
    batch ([] = NOOP filler from recovery)."""

    ballot: int
    slot: int
    cmds: list = field(default_factory=list)


@register_message
@dataclass
class BP2b:
    ballot: int
    slot: int
    id: str = ""


@register_message
@dataclass
class BP3:
    """Commit notification to the learner roles (proxies + replicas)."""

    ballot: int
    slot: int
    cmds: list = field(default_factory=list)


@dataclass
class Entry:
    """A learner/proposer log slot: the accepted batch with a parallel
    request list (requests[i] answers cmds[i]; None for commands whose
    client connection lives elsewhere)."""

    ballot: int
    cmds: List[Command] = field(default_factory=list)
    commit: bool = False
    requests: List[Optional[Request]] = field(default_factory=list)
    quorum: Optional[Quorum] = None
    timestamp: float = 0.0

    def live_requests(self) -> List[Request]:
        return [r for r in self.requests if r is not None]


@dataclass
class RecState:
    """The per-proxy takeover-recovery FSM (one slot at a time)."""

    slot: int
    ballot: int
    phase: int                   # 1 = column read, 2 = row write
    quorum: Quorum
    vballot: int = 0
    cmds: List[Command] = field(default_factory=list)
    attempt: int = 1
    strikes0: int = 0            # gap-strike count at start (restart gate)


class BPaxosReplica(Node):
    RECOVERY_READS = True        # the noread twin flips this

    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        ids = cfg.ids
        P, GR, GC = cfg.n_proxies, cfg.grid_rows, cfg.grid_cols
        A = GR * GC
        if len(ids) < P + A + 1:
            raise ValueError(
                f"bpaxos needs >= n_proxies + grid_rows*grid_cols + 1 "
                f"nodes (got {len(ids)}, need {P + A + 1})")
        self.gr, self.gc = GR, GC
        self.proxies = ids[:P]
        self.acceptors = ids[P:P + A]
        self.replicas = ids[P + A:]
        self.rank = ids.index(self.id)
        self.is_proxy = self.rank < P
        self.is_acceptor = P <= self.rank < P + A
        # proxy state: a fixed per-proxy ballot (no elections), the
        # next own-stripe slot, and the learner log
        self.bal0 = ballot(1, self.id)
        self.next_slot = self.rank
        self.log: Dict[int, Entry] = {}
        self.execute = 0
        # acceptor state: slot -> [promised ballot, accepted ballot,
        # accepted wire batch]
        self.acc: Dict[int, list] = {}
        # at-most-once session table (paxos host precedent)
        self.ctab: Dict[str, Tuple[int, bytes]] = {}
        self.safety_violations = 0   # sticky commit-divergence counter
        self.recovered = 0
        self._rec: Optional[RecState] = None
        self._rec_attempt = 0
        self._gap_at = -1
        self._gap_strikes = 0
        # wall-clock gap poller (real deployments only — wall timers
        # never fire under the virtual-clock fabric, where the
        # strike-based path keeps replays deterministic): fires
        # takeover recovery for a hole that outlives the poll interval
        # even when no further commits arrive to strike it
        self._gap_handle = None
        self._gap_armed_at = -1
        self._rec_polls = 0
        if self.is_proxy:
            self.batch = BatchBuffer(
                self._flush_batch, max_size=cfg.batch_size,
                max_wait=0.0 if self.socket.fabric is not None
                else cfg.batch_wait,
                metrics=self.metrics)
        self.register(Request, self.handle_request)
        if self.is_acceptor:
            self.register(BP1a, self.handle_bp1a)
            self.register(BP2a, self.handle_bp2a)
        else:
            self.register(BP3, self.handle_bp3)
        if self.is_proxy:
            self.register(BP1b, self.handle_bp1b)
            self.register(BP2b, self.handle_bp2b)

    # ---- grid membership ----------------------------------------------
    def _row(self, r: int) -> List[ID]:
        return self.acceptors[r * self.gc:(r + 1) * self.gc]

    def _col(self, c: int) -> List[ID]:
        return self.acceptors[c::self.gc]

    def _learners(self) -> List[ID]:
        return [i for i in self.proxies + self.replicas if i != self.id]

    # ---- client requests ----------------------------------------------
    def handle_request(self, req: Request) -> None:
        if self.is_proxy:
            self.batch.add(req)
        else:
            # key-stable proxy routing keeps fabric replays deterministic
            self.forward(self.proxies[req.command.key
                                      % len(self.proxies)], req)

    def _flush_batch(self, reqs: List[Request]) -> None:
        """BatchBuffer flush: ONE grid round for the whole batch, on my
        own slot stripe, messaged thriftily to the target row."""
        cmds = [r.command for r in reqs]
        slot = self.next_slot
        self.next_slot += len(self.proxies)
        q = Quorum(self.acceptors)
        self.log[slot] = Entry(self.bal0, cmds, requests=list(reqs),
                               quorum=q, timestamp=time.time())
        m = BP2a(self.bal0, slot, _wire_cmds(cmds))
        for a in self._row(slot % self.gr):
            self.socket.send(a, m)

    # ---- acceptors -----------------------------------------------------
    def handle_bp1a(self, m: BP1a) -> None:
        st = self.acc.setdefault(m.slot, [0, 0, []])
        if m.ballot >= st[0]:
            st[0] = m.ballot
            self.socket.send(ballot_id(m.ballot),
                             BP1b(m.ballot, m.slot, st[1], list(st[2]),
                                  str(self.id)))

    def handle_bp2a(self, m: BP2a) -> None:
        st = self.acc.setdefault(m.slot, [0, 0, []])
        if m.ballot >= st[0]:
            st[0] = st[1] = m.ballot
            st[2] = list(m.cmds)
            self.socket.send(ballot_id(m.ballot),
                             BP2b(m.ballot, m.slot, str(self.id)))
        # a superseded write gets no ack: the proposer's row can never
        # complete once any row member promised a higher ballot

    # ---- proxies: tallies ----------------------------------------------
    def handle_bp1b(self, m: BP1b) -> None:
        rec = self._rec
        if (rec is None or rec.phase != 1 or m.slot != rec.slot
                or m.ballot != rec.ballot):
            return
        rec.quorum.ack(ID(m.id))
        if m.vballot > rec.vballot:
            rec.vballot = m.vballot
            rec.cmds = _cmds_from_wire(m.cmds)
        if rec.quorum.grid_col(self.gc):
            # ONE FULL COLUMN read: adopt the highest accepted batch
            # (it intersects every possibly-chosen row), else NOOP
            self._rec_write(rec.cmds if rec.vballot > 0 else [])

    def _rec_write(self, cmds: List[Command]) -> None:
        rec = self._rec
        rec.phase = 2
        rec.cmds = cmds
        rec.quorum = Quorum(self.acceptors)
        m = BP2a(rec.ballot, rec.slot, _wire_cmds(cmds))
        for a in self._row(rec.attempt % self.gr):
            self.socket.send(a, m)

    def handle_bp2b(self, m: BP2b) -> None:
        rec = self._rec
        if (rec is not None and rec.phase == 2 and m.slot == rec.slot
                and m.ballot == rec.ballot):
            rec.quorum.ack(ID(m.id))
            if rec.quorum.grid_row(self.gc):
                self._rec = None
                self.recovered += 1
                self._commit(rec.slot, rec.ballot, rec.cmds)
                # a dead stripe leaves a RUN of holes: once in repair
                # mode, chain straight onto the next one instead of
                # waiting out a fresh strike round per hole
                self._maybe_chain_recovery()
            return
        e = self.log.get(m.slot)
        if (e is not None and not e.commit and e.quorum is not None
                and m.ballot == e.ballot == self.bal0):
            e.quorum.ack(ID(m.id))
            if e.quorum.grid_row(self.gc):
                self._commit(m.slot, e.ballot, e.cmds)

    def _commit(self, slot: int, bal: int, cmds: List[Command]) -> None:
        m = BP3(bal, slot, _wire_cmds(cmds))
        for i in self._learners():
            self.socket.send(i, m)
        self._learn(slot, bal, cmds)
        # own commits strike too: a proxy whose peer died would
        # otherwise never notice the holes its own commits straddle
        self._gap_tick(slot)

    # ---- learners ------------------------------------------------------
    def handle_bp3(self, m: BP3) -> None:
        self._learn(m.slot, m.ballot, _cmds_from_wire(m.cmds))
        if self.is_proxy:
            self._skip_to(m.slot)
            self._gap_tick(m.slot)

    def _skip_to(self, s: int) -> None:
        """Mencius-style stripe skip: a peer's stripe advanced past my
        next own slot — NOOP-fill mine up to it so the shared log stays
        hole-free at idle proxies (execution, hence every client reply,
        needs the contiguous prefix)."""
        while self.next_slot < s:
            slot = self.next_slot
            self.next_slot += len(self.proxies)
            self.log[slot] = Entry(self.bal0, [], requests=[],
                                   quorum=Quorum(self.acceptors),
                                   timestamp=time.time())
            m = BP2a(self.bal0, slot, [])
            for a in self._row(slot % self.gr):
                self.socket.send(a, m)

    def _learn(self, slot: int, bal: int, cmds: List[Command]) -> None:
        e = self.log.get(slot)
        reqs: List[Optional[Request]] = []
        if e is not None:
            if _idents(e.cmds) == _idents(cmds):
                reqs = e.requests
            else:
                if e.commit:
                    # a committed slot changed identity: the safety
                    # violation the grid intersection exists to prevent
                    # (reproducible via the noread twin) — count it
                    # sticky so the hunt oracle sees it after the run
                    self.safety_violations += 1
                for req in e.live_requests():
                    # our batch lost the slot: re-propose it elsewhere
                    self.handle_client_request(req)
        self.log[slot] = Entry(bal, cmds, commit=True, requests=reqs)
        self._exec()
        self._arm_gap_timer()

    def _exec(self) -> None:
        while True:
            e = self.log.get(self.execute)
            if e is None or not e.commit:
                break
            reqs = e.requests
            if not reqs:
                if e.cmds:
                    self.db.apply_batch(e.cmds, self.ctab)
                self.execute += 1
                continue
            for i, cmd in enumerate(e.cmds):
                req = reqs[i] if i < len(reqs) else None
                last = (self.ctab.get(cmd.client_id)
                        if cmd.client_id else None)
                if last is not None and cmd.command_id <= last[0]:
                    value = last[1] if cmd.command_id == last[0] else b""
                else:
                    value = self.db.execute(cmd)
                    if cmd.client_id:
                        self.ctab[cmd.client_id] = (cmd.command_id, value)
                if req is not None:
                    req.reply(Reply(cmd, value=value))
            e.requests = []
            self.execute += 1
        if self.execute != self._gap_at:
            self._gap_at = self.execute
            self._gap_strikes = 0

    # ---- takeover recovery ---------------------------------------------
    def _gap_tick(self, slot: int) -> None:
        """A commit landed above a stalled frontier: strike.  Enough
        strikes (staggered so the hole's owner moves first) start —
        or restart, rotating the row/column — slot recovery."""
        if slot <= self.execute:
            return
        if self._gap_at != self.execute:
            self._gap_at = self.execute
            self._gap_strikes = 0
        self._gap_strikes += 1
        hole = self.execute
        e = self.log.get(hole)
        if e is not None and e.commit:
            return
        owner = hole % len(self.proxies)
        stag = (self.rank - owner) % len(self.proxies)
        need = 3 + 3 * stag
        if self._rec is None:
            if self._gap_strikes >= need:
                self._recover(hole)
        elif self._gap_strikes - self._rec.strikes0 >= 6:
            self._recover(self._rec.slot)   # stuck: rotate row/column

    def _maybe_chain_recovery(self) -> None:
        hole = self.execute
        e = self.log.get(hole)
        if (self._rec is None and (e is None or not e.commit)
                and any(s > hole and x.commit
                        for s, x in self.log.items())):
            self._recover(hole)

    def _gap_pending(self) -> bool:
        """Is execution stalled on a hole below known commits?"""
        e = self.log.get(self.execute)
        return (e is None or not e.commit) and \
            any(s > self.execute and x.commit
                for s, x in self.log.items())

    def _arm_gap_timer(self) -> None:
        if (not self.is_proxy or self.socket.fabric is not None
                or self._gap_handle is not None
                or not self._gap_pending()):
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        owner = self.execute % len(self.proxies)
        stag = (self.rank - owner) % len(self.proxies)
        self._gap_armed_at = self.execute
        self._gap_handle = loop.call_later(0.05 * (1 + stag),
                                           self._gap_poll)

    def _gap_poll(self) -> None:
        self._gap_handle = None
        if not self._gap_pending():
            self._rec_polls = 0
            return
        if self._rec is None:
            if self.execute == self._gap_armed_at:
                self._rec_polls = 0
                self._recover(self.execute)
        else:
            # an in-flight recovery outliving several polls is stuck on
            # a dead row/column member: restart (rotates both)
            self._rec_polls += 1
            if self._rec_polls >= 4:
                self._rec_polls = 0
                self._recover(self._rec.slot)
        self._arm_gap_timer()

    def _recover(self, slot: int) -> None:
        self._rec_attempt += 1
        rec = RecState(slot=slot,
                       ballot=ballot(1 + self._rec_attempt, self.id),
                       phase=1, quorum=Quorum(self.acceptors),
                       attempt=self._rec_attempt,
                       strikes0=self._gap_strikes)
        self._rec = rec
        if not self.RECOVERY_READS:
            # the seeded bug: blind NOOP write without the column read
            self._rec_write([])
            return
        m = BP1a(rec.ballot, slot)
        for a in self._col(rec.attempt % self.gc):
            self.socket.send(a, m)


def new_replica(id: ID, cfg: Config) -> BPaxosReplica:
    return BPaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  Wire-level identity: the sim kernel's
# five mailbox planes are exactly the host runtime's five message
# classes (the fabric's tick flushes make trace-driven batches fill 1,
# so the per-slot correspondence holds during replays).
TRACE_MSG_MAP = {
    "p1a": "BP1a", "p1b": "BP1b", "p2a": "BP2a", "p2b": "BP2b",
    "p3": "BP3",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal, no
# host analog.  Serves both `bpaxos` (sim.py PROTOCOL) and the
# `bpaxos_noread` twin (same state vocabulary).
SIM_STATE_MAP = {
    "abal":       "acc",        # promised ballot <-> acc[slot][0]
    "vbal":       "acc",        # accepted ballot <-> acc[slot][1]
    "vcmd":       "acc",        # accepted batch <-> acc[slot][2]
    "vbsz":       "acc",        # batch size <-> len(acc[slot][2])
    "committed":  "log",        # commit plane <-> Entry.commit
    "proposed":   "log",        # own-stripe in-flight <-> Entry existence
    "p2_acks":    "log",        # row-ack bitmask <-> Entry.quorum
    "next_slot":  "next_slot",
    "execute":    "execute",
    "kv":         "db",
    "cum_cmds":   "db",         # executed-command count <-> applied state
    "stuck":      "_gap_strikes",  # frontier-stall <-> gap strikes
    "rec_slot":   "_rec",       # the takeover FSM aggregate (RecState)
    "rec_bal":    "_rec",
    "rec_phase":  "_rec",
    "rec_acks":   "_rec",
    "rec_vbal":   "_rec",
    "rec_vcmd":   "_rec",
    "rec_vbsz":   "_rec",
    "rec_round":  "_rec_attempt",
    "recovered":  "recovered",
    "base":       "",   # ring-window base: the host log is an unbounded dict
    "rec_timer":  "",   # step-timer: host restarts are strike-driven
    # on-device observability — measurement planes, excluded
    # from the trace witness hash; the host twins are the registry's
    # live latency histograms and the post-hoc linearizability checker
    "m_prop_t":      "",
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
}


# ---- hunt-engine hooks (hunt/classify.py) -------------------------------
# Gap-strike takeover is evidence-driven: after the replayed schedule it
# takes several fault-free commits to strike the hole, run the recovery
# round and surface any divergence — the default 10-step tail ends
# before that converges (40 is what the bpaxos_noread control needs).
HUNT_TAIL_STEPS = 40


def HUNT_ORACLE(cluster) -> int:
    """Safety-violation count after a replay: sticky commit-divergence
    counters plus cross-node disagreement on committed batches (the
    host analog of the sim kernel's agreement + stability oracle)."""
    bad = 0
    seen: Dict[int, list] = {}
    for i in cluster.ids:
        r = cluster[i]
        bad += getattr(r, "safety_violations", 0)
        for s, e in getattr(r, "log", {}).items():
            if not e.commit:
                continue
            ident = _idents(e.cmds)
            if s in seen and seen[s] != ident:
                bad += 1
            seen.setdefault(s, ident)
    return bad
