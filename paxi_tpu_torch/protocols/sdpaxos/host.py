"""SDPaxos replica for the host (deployment) runtime.

Reference: the paxi lineage's sdpaxos/ package (SURVEY §2.2 "others" —
the SoCC'18 semi-decentralized protocol).  Command replication is
decentralized: the replica a request arrives at is that command's
leader and replicates the body from where it is (C-instance, majority
CAck quorum).  Ordering is centralized: an elected sequencer assigns
global O-log slots naming (owner, cidx) pairs and replicates them with
ordinary Multi-Paxos (OAccept/OAck/OCommit under a ballot, Seq1a/Seq1b
election with log merge).  A command executes once its O-slot is
committed AND its body is locally stored; execution follows O-log slot
order with at-most-once (owner, cidx) dedup — a minority-accepted pair
can be re-adopted at a second slot across a sequencer change, and the
dedup makes that harmless (the sim kernel avoids it structurally with
positional owner tokens; see sim.py).

O-log compaction: every replica gossips its execute frontier
(OFrontier); slots below the cluster-wide minimum (minus a small
margin) are GC'd everywhere, together with their ordered/committed/
executed bookkeeping, so election payloads and rescans are bounded by
the live window, not the cluster's lifetime.  The per-client ``ctab``
session table (bounded by client count) remains the at-most-once
backstop for any duplicate whose pair-level record was compacted away —
the same layering as paxos/host.py.  A permanently dead replica pins
the watermark (GC pauses, memory grows); the sim kernel's gossiped
watermark has the identical documented tradeoff.

The same protocol runs as a lane-major sim kernel in ``sim.py``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from paxi_tpu_torch.core.ballot import ballot_id, next_ballot
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


@register_message
@dataclass
class CAccept:
    """Owner -> all: replicate the body of my command #cidx."""

    owner: str
    cidx: int
    key: int
    value: bytes
    client_id: str = ""
    command_id: int = 0


@register_message
@dataclass
class CAck:
    """Acceptor -> owner: stored (owner, cidx)."""

    owner: str
    cidx: int
    id: str


@register_message
@dataclass
class OReq:
    """Owner -> all (idempotent, retried): order (owner, cidx)."""

    owner: str
    cidx: int


@register_message
@dataclass
class CFetch:
    """Staller -> all: re-send me the body of (owner, cidx) — pull-side
    healing for bodies the owner stopped pushing (already majority-
    chosen, or owner dead)."""

    owner: str
    cidx: int
    id: str


@register_message
@dataclass
class Seq1a:
    ballot: int


@register_message
@dataclass
class Seq1b:
    ballot: int
    id: str
    # slot -> [ballot, owner, cidx, committed]
    olog: Dict[int, list] = field(default_factory=dict)


@register_message
@dataclass
class OAccept:
    ballot: int
    slot: int
    owner: str
    cidx: int


@register_message
@dataclass
class OAck:
    ballot: int
    slot: int
    id: str


@register_message
@dataclass
class OCommit:
    ballot: int
    slot: int
    owner: str
    cidx: int


@register_message
@dataclass
class OFrontier:
    """Sequencer heartbeat: my execute frontier — laggards compare and
    fetch what they missed (the host analog of the sim kernel's P3
    frontier retransmit).  Broadcast by EVERY replica each watchdog
    tick: the collected frontiers also drive O-log GC (see module
    docstring).  Carries the ballot so a replica that missed the
    election itself learns the sequencer from the heartbeat."""

    ballot: int
    execute: int
    id: str


@register_message
@dataclass
class OFetch:
    """Laggard -> sequencer: re-send committed slots from ``slot``."""

    slot: int
    id: str


NOOP_PAIR = ("", -1)


@dataclass
class OEntry:
    ballot: int
    pair: Tuple[str, int]
    commit: bool = False
    quorum: Optional[Quorum] = None


class SDPaxosReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        # ---- C-plane: my own command stream -----------------------------
        self.cnext = 0
        self.cstore: Dict[Tuple[str, int], Command] = {}
        self.cquorum: Dict[int, Quorum] = {}       # my cidx -> CAck quorum
        self.creq: Dict[int, Request] = {}         # my cidx -> client req
        self.cchosen: Set[int] = set()             # my majority-stored cidxs
        # ---- O-log: sequencer-ordered (owner, cidx) pairs ---------------
        self.ballot = 0
        self.active = False
        self.olog: Dict[int, OEntry] = {}
        self.oslot = -1
        self.execute = 0
        self.ordered: Set[Tuple[str, int]] = set()  # pairs in the O-log
        self.committed: Set[Tuple[str, int]] = set()  # pairs commit-known
        self.executed: Set[Tuple[str, int]] = set()  # at-most-once dedup
        self.queue: list = []                      # pairs awaiting a slot
        self.queued: Set[Tuple[str, int]] = set()  # O(1) queue membership
        self.seq_quorum = Quorum(cfg.ids)
        self.seq1b_logs: Dict[ID, Dict[int, list]] = {}
        self.ctab: Dict[str, Tuple[int, bytes]] = {}
        self._stalled_pair: Optional[Tuple[str, int]] = None
        self._last_exec = 0
        self._stall_ticks = 0
        self.peer_front: Dict[ID, int] = {}   # OFrontier-gossiped frontiers
        self.gc_base = 0                      # slots below this are pruned
        self.GC_MARGIN = 128
        self.register(Request, self.handle_request)
        self.register(CAccept, self.handle_caccept)
        self.register(CAck, self.handle_cack)
        self.register(CFetch, self.handle_cfetch)
        self.register(OReq, self.handle_oreq)
        self.register(Seq1a, self.handle_seq1a)
        self.register(Seq1b, self.handle_seq1b)
        self.register(OAccept, self.handle_oaccept)
        self.register(OAck, self.handle_oack)
        self.register(OCommit, self.handle_ocommit)
        self.register(OFrontier, self.handle_ofrontier)
        self.register(OFetch, self.handle_ofetch)

    async def start(self) -> None:
        await super().start()
        self._tasks.append(asyncio.create_task(self._watchdog()))

    async def _watchdog(self) -> None:
        """Retry loop for both planes: un-chosen bodies are re-broadcast
        (CAccept is idempotent), chosen-but-unordered pairs re-request
        ordering (OReq is idempotent) — this is what makes command loss
        and sequencer loss heal without per-message bookkeeping."""
        try:
            while True:
                await asyncio.sleep(0.05)
                for cidx, req in list(self.creq.items()):
                    pair = (str(self.id), cidx)
                    if cidx not in self.cchosen:
                        self._bcast_caccept(cidx)
                    elif pair not in self.committed:
                        # retry until COMMITTED, not merely accepted: a
                        # tentatively-accepted pair can be displaced by
                        # a sequencer change and must be re-requested
                        self.socket.broadcast(OReq(*pair))
                        self.handle_oreq(OReq(*pair))
                # pull a body my execution is stalled on (the owner may
                # be done pushing it, or dead)
                if self._stalled_pair is not None:
                    self.socket.broadcast(
                        CFetch(*self._stalled_pair, str(self.id)))
                # no execution progress with work in flight: the
                # sequencer is gone or wedged — run for the ballot
                # (paxos host's stuck-frontier retry, lifted to the
                # O-log; ballot ordering resolves duels)
                self.socket.broadcast(
                    OFrontier(self.ballot, self.execute, str(self.id)))
                self._gc_olog()
                if self.creq and self.execute == self._last_exec:
                    self._stall_ticks += 1
                    if self._stall_ticks >= 4:
                        self._stall_ticks = 0
                        self.run_seq_phase1()
                else:
                    self._stall_ticks = 0
                self._last_exec = self.execute
        except asyncio.CancelledError:
            pass

    # ---- sequencer identity --------------------------------------------
    @property
    def sequencer(self) -> Optional[ID]:
        return ballot_id(self.ballot) if self.ballot else None

    def is_sequencer(self) -> bool:
        return self.active and self.sequencer == self.id

    # ---- client requests: I am this command's leader --------------------
    def handle_request(self, req: Request) -> None:
        cidx = self.cnext
        self.cnext += 1
        pair = (str(self.id), cidx)
        self.cstore[pair] = req.command
        self.creq[cidx] = req
        q = Quorum(self.cfg.ids)
        q.ack(self.id)
        self.cquorum[cidx] = q
        self._bcast_caccept(cidx)
        if q.majority():                    # single-replica cluster
            self._c_chosen(cidx)

    def _bcast_caccept(self, cidx: int) -> None:
        cmd = self.cstore[(str(self.id), cidx)]
        self.socket.broadcast(CAccept(str(self.id), cidx, cmd.key,
                                      cmd.value, cmd.client_id,
                                      cmd.command_id))

    def handle_caccept(self, m: CAccept) -> None:
        self.cstore[(m.owner, m.cidx)] = Command(
            m.key, m.value, m.client_id, m.command_id)
        self.socket.send(ID(m.owner), CAck(m.owner, m.cidx, str(self.id)))
        self._exec()                        # a stalled body may now be here

    def handle_cfetch(self, m: CFetch) -> None:
        cmd = self.cstore.get((m.owner, m.cidx))
        if cmd is not None:
            self.socket.send(ID(m.id), CAccept(
                m.owner, m.cidx, cmd.key, cmd.value, cmd.client_id,
                cmd.command_id))

    def handle_cack(self, m: CAck) -> None:
        q = self.cquorum.get(m.cidx)
        if q is None or m.cidx in self.cchosen:
            return
        q.ack(ID(m.id))
        if q.majority():
            self._c_chosen(m.cidx)

    def _c_chosen(self, cidx: int) -> None:
        """Body durable on a majority: request a global order slot."""
        self.cchosen.add(cidx)
        pair = (str(self.id), cidx)
        self.socket.broadcast(OReq(*pair))
        self.handle_oreq(OReq(*pair))
        if self.sequencer is None:
            self.run_seq_phase1()

    # ---- ordering requests ---------------------------------------------
    def handle_oreq(self, m: OReq) -> None:
        pair = (m.owner, m.cidx)
        if pair in self.committed or pair in self.ordered \
                or pair in self.queued:
            return
        self.queue.append(pair)
        self.queued.add(pair)
        self._drain_queue()

    def _drain_queue(self) -> None:
        if not self.is_sequencer():
            return
        queue, self.queue = self.queue, []
        self.queued.clear()
        for pair in queue:
            if pair not in self.ordered:
                self._propose_o(pair)

    def _unqueue(self, pair: Tuple[str, int]) -> None:
        """Drop a now-committed pair from a bystander's request queue —
        without this, non-sequencer queues grow with command history."""
        if pair in self.queued:
            self.queued.discard(pair)
            self.queue.remove(pair)

    def _propose_o(self, pair: Tuple[str, int],
                   at_slot: Optional[int] = None) -> None:
        if at_slot is None:
            self.oslot += 1
            slot = self.oslot
        else:
            slot = at_slot
            self.oslot = max(self.oslot, slot)
        q = Quorum(self.cfg.ids)
        q.ack(self.id)
        self.olog[slot] = OEntry(self.ballot, pair, quorum=q)
        self.ordered.add(pair)
        self.socket.broadcast(OAccept(self.ballot, slot, pair[0], pair[1]))
        if q.majority():
            self._commit_o(slot)

    # ---- sequencer election (Multi-Paxos phase-1 on the O-log) ----------
    def run_seq_phase1(self) -> None:
        self.ballot = next_ballot(self.ballot, self.id)
        self.active = False
        self.seq_quorum = Quorum(self.cfg.ids)
        self.seq_quorum.ack(self.id)
        self.seq1b_logs = {self.id: self._olog_payload()}
        self.socket.broadcast(Seq1a(self.ballot))

    def _olog_payload(self) -> Dict[int, list]:
        return {s: [e.ballot, e.pair[0], e.pair[1], e.commit]
                for s, e in self.olog.items()}

    def handle_seq1a(self, m: Seq1a) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
        self.socket.send(ballot_id(m.ballot),
                         Seq1b(self.ballot, str(self.id),
                               self._olog_payload()))

    def handle_seq1b(self, m: Seq1b) -> None:
        if m.ballot != self.ballot or self.active:
            if m.ballot > self.ballot:
                self.ballot = m.ballot
                self.active = False
            return
        self.seq_quorum.ack(ID(m.id))
        self.seq1b_logs[ID(m.id)] = m.olog
        if self.seq_quorum.majority() and ballot_id(self.ballot) == self.id:
            self._become_sequencer()

    def _become_sequencer(self) -> None:
        """Merge Seq1b O-logs (committed wins, else highest ballot),
        NOOP-fill holes, re-propose the window, rebuild the ordered
        set FROM THE POST-MERGE LOG — a stale tentative pair my old log
        held that the merge displaced must drop out of ``ordered`` so a
        retried OReq can re-enqueue it."""
        self.active = True
        merged: Dict[int, Tuple[int, Tuple[str, int], bool]] = {}
        top = self.oslot
        for log in self.seq1b_logs.values():
            for s_raw, (bal, owner, cidx, committed) in log.items():
                s = int(s_raw)
                top = max(top, s)
                pair = (owner, int(cidx))
                cur = merged.get(s)
                if committed:
                    merged[s] = (bal, pair, True)
                elif cur is None or (not cur[2] and bal > cur[0]):
                    merged[s] = (bal, pair, False)
        self.ordered = set(self.executed) | set(self.committed)
        # everything below every acker's GC base was executed cluster-
        # wide; scan only from the lowest slot any payload still carries
        low = max(min([self.execute] + list(merged.keys())), self.gc_base)
        for s in range(low, top + 1):
            bal, pair, committed = merged.get(s, (0, NOOP_PAIR, False))
            prev = self.olog.get(s)
            if prev is not None and prev.commit:
                self.ordered.add(prev.pair)
                self.committed.add(prev.pair)
                continue
            if committed:
                self.olog[s] = OEntry(bal, pair, commit=True)
                self.ordered.add(pair)
                self.committed.add(pair)
            else:
                self._propose_o(pair, at_slot=s)
        self.ordered.discard(NOOP_PAIR)
        self.committed.discard(NOOP_PAIR)
        self.oslot = max(self.oslot, top)
        self._exec()
        self._drain_queue()

    # ---- O-log phase 2 --------------------------------------------------
    def handle_oaccept(self, m: OAccept) -> None:
        if m.slot < self.gc_base:
            return      # GC'd: executed cluster-wide; never resurrect
        if m.ballot >= self.ballot:
            if m.ballot > self.ballot:
                self.ballot = m.ballot
                self.active = False
            e = self.olog.get(m.slot)
            if e is None or (not e.commit and m.ballot >= e.ballot):
                self.olog[m.slot] = OEntry(m.ballot, (m.owner, m.cidx))
                self.ordered.add((m.owner, m.cidx))
                self.ordered.discard(NOOP_PAIR)
            self.oslot = max(self.oslot, m.slot)
        self.socket.send(ballot_id(m.ballot),
                         OAck(self.ballot, m.slot, str(self.id)))

    def handle_oack(self, m: OAck) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
            return
        e = self.olog.get(m.slot)
        if (self.active and e is not None and not e.commit
                and m.ballot == self.ballot == e.ballot):
            e.quorum.ack(ID(m.id))
            if e.quorum.majority():
                self._commit_o(m.slot)

    def _commit_o(self, slot: int) -> None:
        e = self.olog[slot]
        e.commit = True
        if e.pair != NOOP_PAIR:
            self.committed.add(e.pair)
            self._unqueue(e.pair)
        self.socket.broadcast(OCommit(self.ballot, slot, e.pair[0],
                                      e.pair[1]))
        self._exec()

    def handle_ocommit(self, m: OCommit) -> None:
        if m.slot < self.gc_base:
            return      # GC'd: executed cluster-wide; never resurrect
        pair = (m.owner, m.cidx)
        self.olog[m.slot] = OEntry(m.ballot, pair, commit=True)
        if pair != NOOP_PAIR:
            self.ordered.add(pair)
            self.committed.add(pair)
            self._unqueue(pair)
        self.oslot = max(self.oslot, m.slot)
        self._exec()

    def handle_ofrontier(self, m: OFrontier) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
        self.peer_front[ID(m.id)] = max(
            self.peer_front.get(ID(m.id), 0), m.execute)
        if self.execute < m.execute:
            self.socket.send(ID(m.id), OFetch(self.execute, str(self.id)))

    def _gc_olog(self) -> None:
        """Prune O-log slots (and their pair bookkeeping) every replica
        has executed past; ``ctab`` keeps at-most-once for anything
        pruned.  Needs a frontier report from every peer — a silent
        (dead) peer pauses GC rather than risking a pruned slot someone
        still needs."""
        if len(self.peer_front) < len(self.cfg.ids) - 1:
            return
        w = min([self.execute] + list(self.peer_front.values()))
        new_base = w - self.GC_MARGIN
        if new_base <= self.gc_base:
            return
        for s in range(self.gc_base, new_base):
            e = self.olog.pop(s, None)
            if e is not None and e.pair != NOOP_PAIR:
                self.ordered.discard(e.pair)
                self.committed.discard(e.pair)
                self.executed.discard(e.pair)
                self._unqueue(e.pair)
                # the command BODIES dominate memory: a slot below the
                # watermark executed on every replica, so its body (and
                # my own C-quorum bookkeeping) can never be needed again
                self.cstore.pop(e.pair, None)
                if e.pair[0] == str(self.id):
                    self.cquorum.pop(e.pair[1], None)
                    self.cchosen.discard(e.pair[1])
        self.gc_base = new_base

    def handle_ofetch(self, m: OFetch) -> None:
        for s in range(m.slot, m.slot + 64):
            e = self.olog.get(s)
            if e is None or not e.commit:
                break
            self.socket.send(ID(m.id), OCommit(e.ballot, s, e.pair[0],
                                               e.pair[1]))

    # ---- execution: O-log order, body-gated, at-most-once ---------------
    def _exec(self) -> None:
        self._stalled_pair = None
        while True:
            e = self.olog.get(self.execute)
            if e is None or not e.commit:
                break
            pair = e.pair
            if pair != NOOP_PAIR and pair not in self.executed:
                cmd = self.cstore.get(pair)
                if cmd is None:
                    self._stalled_pair = pair
                    break               # body not here yet: stall, not skip
                last = (self.ctab.get(cmd.client_id)
                        if cmd.client_id else None)
                if last is not None and cmd.command_id <= last[0]:
                    value = last[1] if cmd.command_id == last[0] else b""
                else:
                    value = self.db.execute(cmd)
                    if cmd.client_id:
                        self.ctab[cmd.client_id] = (cmd.command_id, value)
                self.executed.add(pair)
                if pair[0] == str(self.id):
                    req = self.creq.pop(pair[1], None)
                    if req is not None:
                        req.reply(Reply(cmd, value=value))
            self.execute += 1


def new_replica(id: ID, cfg: Config) -> SDPaxosReplica:
    return SDPaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  ``cr`` is the command-body relay a
# holder sends a staller in answer to a ``cneed`` fetch — on the host
# that relay IS a (re)sent CAccept (handle_cfetch), so both the
# original broadcast plane and the relay plane project onto CAccept.
# The host's OFrontier/OFetch watchdog traffic has no sim plane (the
# lock-step kernel needs no liveness prodding) and is simply absent
# from the map.
TRACE_MSG_MAP = {
    "ca": "CAccept", "cack": "CAck", "cneed": "CFetch", "cr": "CAccept",
    "oreq": "OReq", "p1a": "Seq1a", "p1b": "Seq1b",
    "p2a": "OAccept", "p2b": "OAck", "p3": "OCommit",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    # C-plane (decentralized command replication)
    "c_next":     "cnext",       # my proposed command count
    "c_stored":   "cstore",      # per-owner stored commands
    "c_ack":      "cquorum",     # store acks <-> per-command Quorum
    "o_seen":     "cchosen",     # chosen (majority-stored) frontier
    "o_enq":      "queued",      # owner tokens handed to the sequencer
    "exec_c":     "executed",    # per-owner executed frontier
    # O-log (centralized ordering; shared ballot-ring planes)
    "p1_acks":    "seq_quorum",  # sequencer-election ack bitmask
    "log_bal":    "olog",        # O-log ring planes <-> OEntry fields
    "log_cmd":    "olog",
    "log_commit": "olog",
    "log_acks":   "olog",        # OAck bitmask <-> OEntry.quorum
    "next_slot":  "oslot",
    "kv":         "db",
    "base":       "",  # ring-window base: gc_base prunes the host dict
    "proposed":   "",  # own-ballot OAccept mask: implied by OEntry
    "timer":      "",  # election step-timer: host elections are wall-clock
    "stuck":      "",  # frontier-stall retry counter (kernel-only)
    # on-device observability — measurement planes, excluded
    # from the trace witness hash; the host twins are the registry's
    # live latency histograms and the post-hoc linearizability checker
    "m_prop_t":      "",
    "m_commit_dt":   "",   # pending deltas for the deferred flush
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
}
