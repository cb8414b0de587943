"""Multi-Paxos replica for the host (deployment) runtime.

Reference: paxi paxos/paxos.go + paxos/replica.go — a single stable
leader; phase-1 (P1a/P1b) ballot election with log recovery from P1b
payloads; per-slot phase-2 (P2a/P2b) under a majority quorum; P3 commit
broadcast; in-order execution against the Database; non-leaders Forward
requests to the ballot leader [driver: HandleP1a/P1b/P2a/P2b, Quorum.ACK].

This is the same protocol the sim kernel (sim.py) runs as masked
array updates; here it is the event-driven form for real deployments.

Batched commit path (HT-Paxos, PAPERS.md): the leader accumulates
client commands in a ``BatchBuffer`` (host/batch.py — size bound
``cfg.batch_size``, time bound ``cfg.batch_wait``; the default flushes
on the next event-loop tick) and ONE phase-2 round decides the whole
batch: a slot holds a *list* of commands, P2a/P3 carry the list, and
execution applies it in order with per-command at-most-once filtering
and per-command reply fan-out.  Batch atomicity rides on slot
atomicity — a P2a either reaches an acceptor with the entire batch or
not at all, so no fault schedule can commit a partial batch.  An empty
command list is the NOOP filler for recovered holes.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paxi_tpu_torch.core.ballot import ballot_id, next_ballot
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.batch import BatchBuffer
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node
from paxi_tpu_torch.obs import ctx_of


def _wire_cmds(cmds: List[Command]) -> List[list]:
    """Commands as wire-friendly lists (codec round-trips lists of
    [key, value, client_id, command_id] under both json and pickle)."""
    return [[c.key, c.value, c.client_id, c.command_id] for c in cmds]


def _cmds_from_wire(wire) -> List[Command]:
    return [Command(int(k), v, cid, int(cmid)) for k, v, cid, cmid in wire]


def _idents(cmds: List[Command]) -> List[Tuple[str, int]]:
    """A batch's identity: the (client_id, command_id) sequence — what
    decides whether a recovered/committed slot still carries the same
    client commands our pending replies are waiting on."""
    return [(c.client_id, c.command_id) for c in cmds]


@register_message
@dataclass
class P1a:
    ballot: int
    # candidate's execute frontier: ackers ship the KV snapshot only
    # when they are ahead of it, so steady-state elections (equal
    # frontiers) pay no O(DB) wire cost
    execute: int = 0


@register_message
@dataclass
class P1b:
    ballot: int
    id: str
    # slot -> [ballot, [[key, value, client_id, command_id], ...], committed]
    log: Dict[int, list] = field(default_factory=dict)
    # state transfer: the log payload omits slots below the sender's
    # execute frontier (log-compaction analog), so the frontier plus a
    # KV snapshot stands in for the executed prefix — without it a new
    # leader behind an all-executed quorum would NOOP-fill committed,
    # executed slots and diverge
    execute: int = 0
    snap: Dict[int, bytes] = field(default_factory=dict)
    # at-most-once session table riding the snapshot: client_id ->
    # [command_id, value] of its highest executed command, so a frontier
    # jump can never re-execute a command whose slot was compacted away
    ctab: Dict[str, list] = field(default_factory=dict)
    # non-KV replicated planes riding the same transfer
    # (db.aux_snapshot): staged/decided 2PC state and migration
    # windows — a frontier jump past an in-doubt txn's prepare (or a
    # migration begin) must carry the stage, not drop it
    aux: Dict = field(default_factory=dict)


@register_message
@dataclass
class P2a:
    """One phase-2 round for one slot — which now carries a whole
    command batch ([] = NOOP filler)."""

    ballot: int
    slot: int
    cmds: list = field(default_factory=list)


@register_message
@dataclass
class P2b:
    ballot: int
    slot: int
    id: str


@register_message
@dataclass
class P3:
    ballot: int
    slot: int
    cmds: list = field(default_factory=list)


@dataclass
class Entry:
    """Reference: paxos.go entry{ballot, command, commit, request,
    quorum, timestamp} — generalized to a command batch with a parallel
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


class PaxosReplica(Node):
    # message-class hooks: every wire frame is built and registered
    # through these, so a subclass can swap in extended frames (the
    # switchnet tier's sequencer-stamped classes in
    # protocols/switchpaxos/host.py) without re-implementing the
    # phase logic — Node dispatch is keyed on the exact type
    P1A_CLS = P1a
    P1B_CLS = P1b
    P2A_CLS = P2a
    P2B_CLS = P2b
    P3_CLS = P3

    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.ballot = 0
        self.active = False
        self._leader_ballot = 0          # leader-property memo (ballot)
        self._leader_cache: Optional[ID] = None
        self.log: Dict[int, Entry] = {}
        self.slot = -1          # highest slot used (next proposal = slot+1)
        self.execute = 0        # next slot to execute
        self.p1_quorum = Quorum(cfg.ids)
        self.p1b_logs: Dict[ID, Dict[int, list]] = {}
        # id -> (execute, snap, ctab, aux)
        self.p1b_meta: Dict[ID, tuple] = {}
        self.pending: list = []  # requests queued while electing
        # leader-reads barrier: proposal-frontier slot -> reads waiting
        # for every slot <= it to execute (cfg.leader_reads only)
        self._read_barrier: Dict[int, List[Request]] = {}
        # the leader lease that keeps those reads sound across
        # elections (cfg.lease_s):
        # - ``_lease_until``: serving side — barrier reads answer from
        #   local state only within ``lease_s`` of the START of the
        #   last quorum round (phase-1 win or phase-2 commit); past it
        #   the reads fall back to the log (always-safe path).
        # - ``_fence_until``: takeover side — a fresh leader defers its
        #   first proposals for ``lease_s`` after winning phase-1, so
        #   no write can commit while a deposed leader's lease (whose
        #   last renewal round necessarily STARTED before our promises
        #   arrived) may still be serving reads.
        # Every lease timestamp reads the RESOLVED clock
        # (``self.spans.now()``: fabric clock under replay, monotonic
        # perf_counter live) — a wall-clock read here would make lease
        # expiry depend on host wall time during a virtual-clock
        # replay, breaking byte-identical re-runs (PXR165).
        self._lease_until = 0.0
        self._fence_until = 0.0
        self._p1_start = 0.0
        self._fenced: list = []   # proposals stashed behind the fence
        # at-most-once filter (ADVICE r2 medium): client_id -> (highest
        # executed command_id, its value).  Clients issue command_ids
        # monotonically (host/client.py), so a re-proposal of an
        # already-executed command — e.g. one re-pended across a P1b
        # frontier jump whose true outcome was compacted away, or one
        # both committed under an old ballot and forwarded to the new
        # leader — is recognized and skipped deterministically at every
        # replica instead of mutating the DB twice.
        self.ctab: Dict[str, Tuple[int, bytes]] = {}
        # the batched commit path: leader-side request accumulation.
        # Wall timers never fire under the virtual-clock fabric, so a
        # fabric-driven replica is forced onto tick flushes to keep
        # trace replays deterministic.
        self.batch = BatchBuffer(
            self._flush_batch, max_size=cfg.batch_size,
            max_wait=0.0 if self.socket.fabric is not None
            else cfg.batch_wait,
            metrics=self.metrics, spans=self.spans)
        self.register(Request, self.handle_request)
        self.register(P1a, self.handle_p1a)
        self.register(P1b, self.handle_p1b)
        self.register(P2a, self.handle_p2a)
        self.register(P2b, self.handle_p2b)
        self.register(P3, self.handle_p3)

    # ---- leadership ----------------------------------------------------
    @property
    def leader(self) -> Optional[ID]:
        # memoized per ballot: ID construction parses/validates the
        # "zone.node" string, and this property is on the per-request
        # hot path (is_leader per client command)
        if not self.ballot:
            return None
        if self._leader_ballot != self.ballot:
            self._leader_ballot = self.ballot
            self._leader_cache = ballot_id(self.ballot)
        return self._leader_cache

    def is_leader(self) -> bool:
        return self.active and self.leader == self.id

    # ---- leader lease (cfg.leader_reads soundness) --------------------
    def _lease_enabled(self) -> bool:
        return self.cfg.leader_reads and self.cfg.lease_s > 0

    def _lease_ok(self) -> bool:
        """May barrier reads answer from local state right now?"""
        return not self._lease_enabled() \
            or self.spans.now() < self._lease_until

    def _renew_lease(self, round_start: float) -> None:
        """A quorum round that STARTED at ``round_start`` completed:
        a majority was reachable then, so no rival can have finished
        phase-1 before it — local state is authoritative until
        ``round_start + lease_s``."""
        if self._lease_enabled():
            self._lease_until = max(self._lease_until,
                                    round_start + self.cfg.lease_s)

    def run_phase1(self) -> None:
        """paxos.go P1a(): bump ballot, solicit promises."""
        self._p1_start = self.spans.now()
        self.ballot = next_ballot(self.ballot, self.id)
        self.active = False
        self.p1_quorum = Quorum(self.cfg.ids)
        self.p1_quorum.ack(self.id)
        self.p1b_logs = {self.id: self._log_payload()}
        # own db is local: no transfer needed
        self.p1b_meta = {self.id: (self.execute, {}, {}, {})}
        self.socket.broadcast(self.P1A_CLS(self.ballot, self.execute))

    def _log_payload(self) -> Dict[int, list]:
        return {s: [e.ballot, _wire_cmds(e.cmds), e.commit]
                for s, e in self.log.items() if s >= self.execute}

    # ---- client requests ----------------------------------------------
    def handle_request(self, req: Request) -> None:
        self._maybe_drain_fence()
        if self.is_leader():
            # the batched path: one phase-2 round will cover every
            # request that lands in this buffer before the flush bound
            self.batch.add(req)
        elif self.leader is not None and self.leader != self.id:
            self.forward(self.leader, req)
        else:
            self.pending.append(req)
            # start an election only if one of ours isn't already in
            # flight (reference guards with ballot.ID() != self.ID)
            if self.leader != self.id:
                self.run_phase1()

    def _flush_batch(self, reqs: List[Request]) -> None:
        """BatchBuffer flush: propose ONE slot for the whole batch —
        or, if leadership was lost between add and flush, route the
        requests like any other non-leader arrival.

        With ``cfg.leader_reads`` the batch's reads never enter the
        log: they wait at the current proposal frontier and execute
        against the leader's applied state once every earlier slot has
        executed (read-index semantics; module docstring caveat)."""
        if not self.is_leader():
            self.pending.extend(reqs)
            self._drain_pending()
            return
        if not self.cfg.leader_reads:
            self.propose(reqs)
            return
        writes = [r for r in reqs if r.command.value]
        reads = [r for r in reqs if not r.command.value]
        if writes:
            self.propose(writes)
        if reads:
            if not self._lease_ok():
                # lease expired: a newer leader may have committed
                # writes this snapshot misses — order the reads
                # through the log (the always-safe path)
                self.propose(reads)
                return
            barrier = self.slot
            if self.execute > barrier:
                db_get = self.db.get
                for r in reads:
                    r.reply(Reply(r.command,
                                  value=db_get(r.command.key) or b""))
            else:
                self._read_barrier.setdefault(barrier, []).extend(reads)

    def propose(self, reqs: Optional[List[Request]],
                cmds: Optional[List[Command]] = None,
                at_slot: Optional[int] = None) -> None:
        """paxos.go P2a(): assign a slot to the batch, self-ack,
        broadcast one P2a carrying every command.  Behind the takeover
        fence (see ``_fence_until``) proposals stash and drain when a
        deposed leader's lease can no longer be live."""
        self._maybe_drain_fence()
        if self._lease_enabled() and self.spans.now() < self._fence_until:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None   # no loop (sync caller): fence unenforceable
            if loop is not None:
                self._fenced.append((reqs, cmds, at_slot))
                if len(self._fenced) == 1 and self.socket.fabric is None:
                    # live: a wall timer releases the fence.  Under a
                    # fabric there are no wall timers (the delay below
                    # is in resolved-clock units, not seconds) — the
                    # fence drains on the next protocol activity past
                    # the bound instead, keeping replays byte-identical
                    loop.call_later(self._fence_until - self.spans.now(),
                                    self._drain_fence)
                return
        reqs = list(reqs) if reqs else []
        if cmds is None:
            cmds = [r.command for r in reqs]
        if len(reqs) < len(cmds):
            reqs = reqs + [None] * (len(cmds) - len(reqs))
        if at_slot is None:
            self.slot += 1
            slot = self.slot
        else:
            slot = at_slot
            self.slot = max(self.slot, slot)
        q = Quorum(self.cfg.ids)
        q.ack(self.id)
        self.log[slot] = Entry(self.ballot, cmds, requests=reqs, quorum=q,
                               timestamp=self.spans.now())
        # quorum spans for traced requests: opened per batch member at
        # P2a broadcast, closed as one group on majority (_commit).
        # Write-only span traffic — PXO13x pins that no span value ever
        # flows back into protocol state or decisions.
        for i, r in enumerate(reqs):
            self.spans.open(("q", slot, i), "quorum", ctx_of(r),
                            slot=str(slot))
        self.socket.broadcast(self._make_p2a(slot, cmds))
        if q.majority():  # single-replica cluster
            self._commit(slot)

    def _maybe_drain_fence(self) -> None:
        """Release the fence stash once the resolved clock passes the
        bound — the drain path that needs no wall timer (the only one
        available under a virtual-clock fabric)."""
        if self._fenced and self.spans.now() >= self._fence_until:
            self._drain_fence()

    def _drain_fence(self) -> None:
        """The takeover fence elapsed: release the stashed proposals
        (or, if leadership was lost meanwhile, route their requests
        like any other non-leader arrival)."""
        fenced, self._fenced = self._fenced, []
        if not self.is_leader():
            for reqs, _cmds, _slot in fenced:
                self.pending.extend(r for r in (reqs or [])
                                    if r is not None)
            self._drain_pending()
            return
        for args in fenced:
            self.propose(*args)

    # ---- phase 1 -------------------------------------------------------
    def handle_p1a(self, m: P1a) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
            self._repend_inflight()
        ahead = self.execute > m.execute and m.ballot >= self.ballot
        snap = self.db.snapshot() if ahead else {}
        ctab = ({c: [i, v] for c, (i, v) in self.ctab.items()}
                if ahead else {})  # stale candidates discard the P1b anyway
        aux = self.db.aux_snapshot() if ahead else {}
        self.socket.send(ballot_id(m.ballot),
                         self.P1B_CLS(self.ballot, str(self.id), self._log_payload(),
                             self.execute, snap, ctab, aux))

    def _repend_inflight(self) -> None:
        """Losing leadership: unflushed batch, barrier reads and
        uncommitted proposals carrying client requests go back to
        pending for forwarding to the new leader."""
        self._lease_until = 0.0   # known-deposed: stop serving reads now
        if self._fenced:
            # stashed proposals carry the old reign's slot assignments;
            # replaying them after a re-election would overwrite entries
            # committed in between — requeue the requests, drop the slots
            fenced, self._fenced = self._fenced, []
            for reqs, _cmds, _slot in fenced:
                self.pending.extend(r for r in (reqs or []) if r is not None)
        self.batch.drain()   # flush sees not-leader: routes to pending
        if self._read_barrier:
            for reads in self._read_barrier.values():
                self.pending.extend(reads)
            self._read_barrier = {}
        for e in self.log.values():
            if not e.commit and e.requests:
                self.pending.extend(e.live_requests())
                e.requests = []
        self._drain_pending()

    def handle_p1b(self, m: P1b) -> None:
        if m.ballot != self.ballot or self.active:
            if m.ballot > self.ballot:
                self.ballot = m.ballot
                self.active = False
            return
        self.p1_quorum.ack(ID(m.id))
        self.p1b_logs[ID(m.id)] = m.log
        self.p1b_meta[ID(m.id)] = (m.execute, m.snap, m.ctab, m.aux)
        if self._p1_complete():
            self._become_leader()

    def _p1_complete(self) -> bool:
        """Is my phase-1 round won and still mine?  Shared with the
        switchnet subclass, whose election can also complete from the
        register-read arrival (handle_switch_snap)."""
        return self.p1_quorum.majority() \
            and ballot_id(self.ballot) == self.id

    def _become_leader(self) -> None:
        """Merge P1b logs: per slot adopt the highest-ballot batch, keep
        committed values, fill holes with NOOP (empty batch); re-propose
        everything in the window (paxos.go HandleP1b recovery path)."""
        self.active = True
        self._renew_lease(self._p1_start)
        if self._lease_enabled():
            # any prior leader's lease renewal round started before our
            # promises arrived, so it expires no later than this fence
            self._fence_until = self.spans.now() + self.cfg.lease_s
        # state transfer first: an acker ahead of our execute frontier
        # has executed (hence committed) everything below it; adopt its
        # snapshot + frontier so the merge never NOOPs an executed slot
        front, snap, ctab, aux = max(self.p1b_meta.values(),
                                     key=lambda fs: fs[0],
                                     default=(0, {}, {}, {}))
        if front > self.execute:
            # adopt the acker's session table first: re-pended requests
            # whose command already executed in a compacted slot must be
            # filtered by _exec, not applied a second time
            for c, (i, v) in ctab.items():
                if c not in self.ctab or self.ctab[c][0] < int(i):
                    self.ctab[c] = (int(i), v)
            # entries the jump skips: uncommitted ones with requests go
            # back to pending (re-proposed in fresh slots); committed
            # ones were decided — acks for writes, the snapshot value
            # for reads (the closest to what in-order _exec would say)
            snap_n = {int(k): v for k, v in snap.items()}
            for s in range(self.execute, front):
                e = self.log.get(s)
                if e is None or not e.requests:
                    continue
                if e.commit:
                    for cmd, req in zip(e.cmds, e.requests):
                        if req is None:
                            continue
                        v = (snap_n.get(cmd.key, b"")
                             if cmd.is_read() else b"")
                        req.reply(Reply(cmd, value=v))
                else:
                    self.pending.extend(e.live_requests())
                e.requests = []
            self.db.restore(snap)
            # the aux planes travel WITH the frontier jump: staged 2PC
            # ops whose prepare slot was compacted away, and open
            # migration windows with their dirty sets
            self.db.restore_aux(aux)
            self.execute = front
            self.slot = max(self.slot, front - 1)
        merged: Dict[int, Tuple[int, list, bool]] = {}
        top = self.slot
        for log in self.p1b_logs.values():
            for s_raw, (bal, wire, committed) in log.items():
                s = int(s_raw)
                top = max(top, s)
                cur = merged.get(s)
                if committed:
                    merged[s] = (bal, wire, True)
                elif cur is None or (not cur[2] and bal > cur[0]):
                    merged[s] = (bal, wire, False)
        for s in range(self.execute, top + 1):
            bal, wire, committed = merged.get(s, (0, [], False))
            cmds = _cmds_from_wire(wire)
            prev = self.log.get(s)
            reqs = prev.requests if prev else []
            if prev is not None and prev.commit:
                continue
            if prev is not None and prev.live_requests() and \
                    _idents(prev.cmds) != _idents(cmds):
                # retry: the slot was taken by a different batch
                self.pending.extend(prev.live_requests())
                prev.requests = reqs = []
            if committed:
                self.log[s] = Entry(bal, cmds, commit=True, requests=reqs)
            else:
                self.propose(reqs, cmds=cmds, at_slot=s)
        self.slot = max(self.slot, top)
        self._exec()
        self._drain_pending()

    def _drain_pending(self) -> None:
        pending, self.pending = self.pending, []
        for req in pending:
            self.handle_request(req)

    # ---- phase 2 -------------------------------------------------------
    def handle_p2a(self, m: P2a) -> None:
        if m.ballot >= self.ballot:
            if m.ballot > self.ballot:
                self.ballot = m.ballot
                self.active = False
                self._repend_inflight()
            e = self.log.get(m.slot)
            if e is None or (not e.commit and m.ballot >= e.ballot):
                reqs = e.requests if e else []
                self.log[m.slot] = Entry(m.ballot, _cmds_from_wire(m.cmds),
                                         requests=reqs)
            self.slot = max(self.slot, m.slot)
        self.socket.send(ballot_id(m.ballot), self._make_p2b(m.slot))

    def _make_p2a(self, slot: int, cmds):
        """P2a factory — the switchnet subclass rides its frontier
        gossip on this frame (register-eviction input)."""
        return self.P2A_CLS(self.ballot, slot, _wire_cmds(cmds))

    def _make_p2b(self, slot: int):
        """P2b factory — the switchnet subclass rides its frontier
        gossip on this frame (register-eviction input)."""
        return self.P2B_CLS(self.ballot, slot, str(self.id))

    def handle_p2b(self, m: P2b) -> None:
        if m.ballot > self.ballot:  # rejected: someone has a newer ballot
            self.ballot = m.ballot
            self.active = False
            self._repend_inflight()
            return
        e = self.log.get(m.slot)
        if (self.active and e is not None and not e.commit
                and m.ballot == self.ballot == e.ballot):
            e.quorum.ack(ID(m.id))        # [driver: Quorum.ACK]
            if e.quorum.majority():
                self._commit(m.slot)

    def _commit(self, slot: int) -> None:
        e = self.log[slot]
        e.commit = True
        self.spans.close_group(("q", slot))
        self._renew_lease(e.timestamp)   # quorum round started then
        self.socket.broadcast(self.P3_CLS(self.ballot, slot, _wire_cmds(e.cmds)))
        self._exec()

    # ---- commit + execution -------------------------------------------
    def handle_p3(self, m: P3) -> None:
        cmds = _cmds_from_wire(m.cmds)
        e = self.log.get(m.slot)
        reqs = e.requests if e else []
        if e is not None and e.live_requests() and \
                _idents(e.cmds) != _idents(cmds):
            # a different batch committed in our slot: retry the
            # clients' requests elsewhere (reference HandleP3 retry path)
            self.pending.extend(e.live_requests())
            e.requests = reqs = []
        self.log[m.slot] = Entry(m.ballot, cmds, commit=True, requests=reqs)
        self.slot = max(self.slot, m.slot)
        self._exec()
        self._drain_pending()

    def _exec(self) -> None:
        """paxos.go exec(): apply the committed prefix in slot order —
        now batch-at-a-time: every command of a committed slot applies
        in batch order with per-client at-most-once filtering (see
        self.ctab) and its reply fans out to the waiting client."""
        while True:
            e = self.log.get(self.execute)
            if e is None or not e.commit:
                break
            reqs = e.requests
            if not reqs:
                # no client connections waiting on this batch (the
                # common case at followers): one-lock tight loop
                if e.cmds:
                    self.db.apply_batch(e.cmds, self.ctab)
                self.execute += 1
                continue
            for i, cmd in enumerate(e.cmds):
                req = reqs[i] if i < len(reqs) else None
                if cmd.key >= 0:
                    last = (self.ctab.get(cmd.client_id)
                            if cmd.client_id else None)
                    if last is not None and cmd.command_id <= last[0]:
                        # duplicate of an already-executed command:
                        # reply with the recorded outcome, never re-apply
                        value = last[1] if cmd.command_id == last[0] else b""
                    else:
                        self.spans.open(("x", self.execute, i), "exec",
                                        ctx_of(req))
                        value = self.db.execute(cmd)
                        self.spans.close(("x", self.execute, i))
                        if cmd.client_id:
                            self.ctab[cmd.client_id] = (cmd.command_id,
                                                        value)
                    if req is not None:
                        self.spans.open(("w", self.execute, i),
                                        "writeback", ctx_of(req))
                        req.reply(Reply(cmd, value=value))
                        self.spans.close(("w", self.execute, i))
                elif req is not None:
                    req.reply(Reply(cmd, err="noop"))
            e.requests = []
            self.execute += 1
        if self._read_barrier:
            self._answer_barrier_reads()

    def _answer_barrier_reads(self) -> None:
        """Leader reads whose barrier slot has fully executed read the
        applied state now (every write they must observe is in) — if
        the lease still vouches for it; otherwise they go through the
        log like writes."""
        done = [s for s in self._read_barrier if s < self.execute]
        db_get = self.db.get
        for s in done:
            reads = self._read_barrier.pop(s)
            if not self._lease_ok():
                self.propose(reads)
                continue
            for r in reads:
                r.reply(Reply(r.command,
                              value=db_get(r.command.key) or b""))


def new_replica(id: ID, cfg: Config) -> PaxosReplica:
    return PaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  Unlike wankeeper's map this one is a
# wire-level identity: the sim kernel's five mailbox planes are exactly
# the host runtime's five message classes, so a minimized sim witness
# ("the run where THIS P2a vanished") projects onto deterministic
# Socket.drop_next directives with no schedule homomorphism caveats.
# (The host P2a now carries a batch; with the fabric's tick flushes a
# trace-driven workload issues one command per round, so batch fill is
# 1 and the per-slot correspondence holds during replays.)
TRACE_MSG_MAP = {
    "p1a": "P1a", "p1b": "P1b", "p2a": "P2a", "p2b": "P2b", "p3": "P3",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal, no host
# analog.  Serves both `paxos` (sim.py) and `paxos_pg` (sim_pg.py) —
# the two kernels share one state vocabulary.
SIM_STATE_MAP = {
    "p1_acks":    "p1_quorum",  # phase-1 ack bitmask <-> Quorum
    "log_bal":    "log",        # accepted-ballot plane <-> Entry.ballot
    "log_cmd":    "log",        # command plane <-> Entry.cmds
    "log_commit": "log",        # commit plane <-> Entry.commit
    "log_acks":   "log",        # per-slot P2b bitmask <-> Entry.quorum
    "next_slot":  "slot",
    "kv":         "db",         # executed state <-> Database
    "base":       "",   # ring-window base: the host log is an unbounded dict
    "proposed":   "",   # own-ballot P2a mask: implied by Entry existence
    "timer":      "",   # election step-timer: host elections are wall-clock
    "stuck":      "",   # go-back-N retry counter (kernel-only)
    # on-device observability — measurement planes, excluded
    # from the trace witness hash; the host twins are the registry's
    # live latency histograms and the post-hoc linearizability checker
    "m_prop_t":      "",
    "m_commit_dt":   "",   # pending deltas for the deferred flush
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
}
