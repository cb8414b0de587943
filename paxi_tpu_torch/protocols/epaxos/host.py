"""EPaxos replica for the host (deployment) runtime.

Reference: paxi epaxos/ [driver] — leaderless: the replica receiving a
command becomes its *command leader* in its own instance space
``(replica, instance)``; PreAccept computes conflict attributes
(seq, deps) which acceptors merge from their conflict maps; identical
replies from a fast quorum (ceil(3N/4)) commit on the fast path,
otherwise Accept (majority) fixes the merged attributes, then Commit;
execution topologically orders the committed dependency graph by
strongly-connected components (Tarjan, epaxos exec.go) with seq as the
tiebreak.  Deps use the standard max-interfering-instance-per-replica
vector form.

Recovery (epaxos Prepare/PrepareReply, explicit-prepare): a watchdog
scans for instances stuck uncommitted past ``recovery_timeout`` —
either blocking local execution as deps of committed instances, or
carrying an unanswered client request — and runs Prepare at a higher
ballot.  On a majority of PrepareReplies the recoverer finishes the
instance: seen-committed => re-Commit; seen-accepted => Accept the
highest-ballot attrs; seen-preaccepted => Accept the identical-attr
group only when it has >= floor(N/2) members excluding the owner's own
reply (the fast-quorum-intersection bound — any surviving fast-path
commit leaves that many identical non-owner replies in every prepare
majority); below that threshold the attrs may be missing interfering
commands committed on a disjoint slow-path quorum, so recovery
restarts phase 1 instead (re-PreAccept at the recovery ballot,
recomputing the dep union over a live majority) before Accepting;
seen-nowhere => commit a NOOP to unblock the hole.

Liveness fallback (slow path): the command leader schedules an Accept
round once a MAJORITY of PreAcceptReplies is in but the fast quorum
has not materialized within ``accept_fallback`` seconds — without it,
one dead replica out of N=3 (or two of N=5) wedges every command even
though a live majority exists.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from paxi_tpu_torch.core.ballot import next_ballot
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import fast_quorum_size, majority_size
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

NONE, PREACCEPTED, ACCEPTED, COMMITTED, EXECUTED = 0, 1, 2, 3, 4

NOOP_KEY = -1


@register_message
@dataclass
class PreAccept:
    owner: str
    inst: int
    key: int
    value: bytes
    seq: int
    deps: Dict[str, int]
    client_id: str = ""
    command_id: int = 0
    ballot: int = 0       # >0 when a recoverer restarts phase 1
    src: str = ""         # who runs the round (defaults to owner)


@register_message
@dataclass
class PreAcceptReply:
    owner: str
    inst: int
    seq: int
    deps: Dict[str, int]
    id: str
    ballot: int = 0       # echoes the round's ballot (0 = owner's)


@register_message
@dataclass
class Accept:
    owner: str
    inst: int
    key: int
    value: bytes
    seq: int
    deps: Dict[str, int]
    client_id: str = ""
    command_id: int = 0
    ballot: int = 0       # >0 when a recoverer drives the round
    src: str = ""         # who runs the round (defaults to owner)


@register_message
@dataclass
class AcceptReply:
    owner: str
    inst: int
    id: str
    ballot: int = 0


@register_message
@dataclass
class Prepare:
    """Recovery phase-1: claim instance (owner, inst) at a new ballot."""

    owner: str
    inst: int
    ballot: int
    src: str


@register_message
@dataclass
class PrepareReply:
    owner: str
    inst: int
    ballot: int           # the replier's promised ballot after this msg
    status: int           # NONE/PREACCEPTED/ACCEPTED/COMMITTED/EXECUTED
    accepted_ballot: int
    key: int
    value: bytes
    seq: int
    deps: Dict[str, int]
    id: str
    client_id: str = ""
    command_id: int = 0


@register_message
@dataclass
class Commit:
    owner: str
    inst: int
    key: int
    value: bytes
    seq: int
    deps: Dict[str, int]
    client_id: str = ""
    command_id: int = 0


@dataclass
class Instance:
    command: Command
    seq: int
    deps: Dict[ID, int]
    status: int = PREACCEPTED
    request: Optional[Request] = None
    # leader-side tallies: distinct acker sets, so retransmit-induced
    # duplicate replies can never fake a quorum
    acked: set = field(default_factory=set)
    accept_acked: set = field(default_factory=set)
    changed: bool = False
    # recovery state
    ballot: int = 0            # promised ballot (0 = owner's implicit)
    accepted_ballot: int = 0   # ballot the current attrs were taken at
    born: float = field(default_factory=time.monotonic)
    fallback_armed: bool = False


@dataclass
class _Recovery:
    """Recoverer-side tally for one Prepare round over (owner, inst)."""

    ballot: int
    replies: Dict[ID, PrepareReply] = field(default_factory=dict)
    phase: int = 1             # 1 = prepare, 3 = re-preaccept, 2 = accept
    # distinct acker sets, so retransmit-induced duplicate replies can
    # never fake a quorum (same rationale as Instance.accept_acked)
    accept_acked: set = field(default_factory=set)
    decided: bool = False
    born: float = field(default_factory=time.monotonic)
    # re-preaccept (restarted phase 1) attribute union
    cmd: Optional[Command] = None
    seq: int = 0
    deps: Dict[ID, int] = field(default_factory=dict)
    pre_acked: set = field(default_factory=set)


class EPaxosReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.insts: Dict[ID, Dict[int, Instance]] = {i: {} for i in cfg.ids}
        self.next_inst = 0
        # conflict map: key -> owner -> latest interfering instance
        self.conflicts: Dict[int, Dict[ID, int]] = {}
        self.n = cfg.n
        self.fast = fast_quorum_size(cfg.n)
        self.maj = majority_size(cfg.n)
        self.fast_commits = 0
        self.slow_commits = 0
        self.recoveries: Dict[Tuple[ID, int], _Recovery] = {}
        # every instance not yet EXECUTED: the watchdog and the executor
        # walk this set instead of the full (ever-growing) instance log
        self._live: set = set()
        self.recovery_timeout = 0.5    # uncommitted-instance age trigger
        self.recovery_interval = 0.15  # watchdog period
        self.accept_fallback = 0.15    # majority-but-no-fast-quorum timer
        self.register(Request, self.handle_request)
        self.register(PreAccept, self.handle_preaccept)
        self.register(PreAcceptReply, self.handle_preaccept_reply)
        self.register(Accept, self.handle_accept)
        self.register(AcceptReply, self.handle_accept_reply)
        self.register(Commit, self.handle_commit)
        self.register(Prepare, self.handle_prepare)
        self.register(PrepareReply, self.handle_prepare_reply)

    async def start(self) -> None:
        await super().start()
        self._tasks.append(asyncio.create_task(self._recovery_watchdog()))

    # ---- attribute computation (exec.go conflict map) -------------------
    def _attrs(self, key: int, excl: Tuple[ID, int]) -> Tuple[int, Dict[ID, int]]:
        deps: Dict[ID, int] = {}
        seq = 0
        for owner, j in self.conflicts.get(key, {}).items():
            if (owner, j) == excl:
                j -= 1
                if j < 0:
                    continue
            deps[owner] = j
            e = self.insts[owner].get(j)
            if e is not None:
                seq = max(seq, e.seq)
        return seq + 1, deps

    def _record(self, owner: ID, inst: int, e: Instance) -> None:
        self.insts[owner][inst] = e
        if e.status < EXECUTED:
            self._live.add((owner, inst))
        k = e.command.key
        if k == NOOP_KEY:
            return                 # NOOPs never interfere
        cur = self.conflicts.setdefault(k, {})
        cur[owner] = max(cur.get(owner, -1), inst)

    # ---- command leader path --------------------------------------------
    def handle_request(self, req: Request) -> None:
        inst = self.next_inst
        self.next_inst += 1
        cmd = req.command
        seq, deps = self._attrs(cmd.key, (self.id, inst))
        e = Instance(cmd, seq, dict(deps), request=req)
        e.acked.add(self.id)
        self._record(self.id, inst, e)
        self.socket.broadcast(PreAccept(
            str(self.id), inst, cmd.key, cmd.value, seq,
            {str(k): v for k, v in deps.items()},
            cmd.client_id, cmd.command_id))
        self._leader_check(inst, e)   # single-node cluster commits at once

    def handle_preaccept(self, m: PreAccept) -> None:
        owner = ID(m.owner)
        cmd = Command(m.key, m.value, m.client_id, m.command_id)
        mseq, mdeps = self._attrs(m.key, (owner, m.inst))
        seq = max(m.seq, mseq)
        deps = {ID(k): v for k, v in m.deps.items()}
        for k, v in mdeps.items():
            deps[k] = max(deps.get(k, -1), v)
        prev = self.insts[owner].get(m.inst)
        if prev is not None and m.ballot < prev.ballot:
            return    # promised a higher-ballot recoverer; sender is stale
        if prev is None or prev.status < ACCEPTED:
            self._record(owner, m.inst,
                         Instance(cmd, seq, dict(deps), ballot=m.ballot,
                                  request=prev.request if prev else None))
        self.socket.send(ID(m.src) if m.src else owner, PreAcceptReply(
            m.owner, m.inst, seq, {str(k): v for k, v in deps.items()},
            str(self.id), m.ballot))

    def handle_preaccept_reply(self, m: PreAcceptReply) -> None:
        if m.ballot > 0:
            # reply to a recoverer's restarted phase 1 (see _repreaccept)
            owner = ID(m.owner)
            r = self.recoveries.get((owner, m.inst))
            if r is not None and r.phase == 3 and m.ballot == r.ballot:
                self._recovery_preaccept_ack(owner, m.inst, r, m)
            return
        e = self.insts[self.id].get(m.inst)
        if e is None or e.status != PREACCEPTED or e.request is None:
            return
        e.acked.add(ID(m.id))
        deps = {ID(k): v for k, v in m.deps.items()}
        if m.seq != e.seq or deps != e.deps:
            e.changed = True
            e.seq = max(e.seq, m.seq)
            for k, v in deps.items():
                e.deps[k] = max(e.deps.get(k, -1), v)
        self._leader_check(m.inst, e)

    def _leader_check(self, inst: int, e: Instance) -> None:
        if e.ballot > 0:
            return   # a recoverer claimed this instance; stop driving it
        if len(e.acked) >= self.fast and not e.changed:
            self.fast_commits += 1
            self._commit(self.id, inst, e)
        elif len(e.acked) >= self.fast and e.changed:
            self._run_accept(inst, e)
        elif len(e.acked) >= self.maj and not e.fallback_armed:
            # fast quorum may never materialize (dead replicas); after a
            # grace period run the always-safe slow path on the majority
            e.fallback_armed = True
            asyncio.get_running_loop().call_later(
                self.accept_fallback, self._fallback_accept, inst)

    def _fallback_accept(self, inst: int) -> None:
        e = self.insts[self.id].get(inst)
        if (e is not None and e.status == PREACCEPTED and e.ballot == 0
                and e.request is not None and len(e.acked) >= self.maj):
            self._run_accept(inst, e)

    def _run_accept(self, inst: int, e: Instance) -> None:
        e.status = ACCEPTED
        e.accepted_ballot = e.ballot
        e.accept_acked = {self.id}
        c = e.command
        self.socket.broadcast(Accept(
            str(self.id), inst, c.key, c.value, e.seq,
            {str(k): v for k, v in e.deps.items()},
            c.client_id, c.command_id, e.ballot, str(self.id)))
        if len(e.accept_acked) >= self.maj:
            self.slow_commits += 1
            self._commit(self.id, inst, e)

    def handle_accept(self, m: Accept) -> None:
        owner = ID(m.owner)
        cmd = Command(m.key, m.value, m.client_id, m.command_id)
        prev = self.insts[owner].get(m.inst)
        if prev is not None and m.ballot < prev.ballot:
            return        # promised a higher-ballot recoverer
        e = Instance(cmd, m.seq, {ID(k): v for k, v in m.deps.items()},
                     status=ACCEPTED,
                     request=prev.request if prev else None,
                     ballot=m.ballot, accepted_ballot=m.ballot)
        if prev is None or prev.status < COMMITTED:
            self._record(owner, m.inst, e)
        self.socket.send(ID(m.src) if m.src else owner,
                         AcceptReply(m.owner, m.inst, str(self.id),
                                     m.ballot))

    def handle_accept_reply(self, m: AcceptReply) -> None:
        owner = ID(m.owner)
        r = self.recoveries.get((owner, m.inst))
        if r is not None and r.phase == 2 and m.ballot == r.ballot:
            self._recovery_accept_ack(owner, m.inst, r, ID(m.id))
            return
        if owner != self.id:
            return
        e = self.insts[self.id].get(m.inst)
        if (e is None or e.status != ACCEPTED or e.request is None
                or m.ballot != e.ballot):
            return   # ballot mismatch: a recoverer superseded this round
        e.accept_acked.add(ID(m.id))
        if len(e.accept_acked) >= self.maj:
            self.slow_commits += 1
            self._commit(self.id, m.inst, e)

    def _commit(self, owner: ID, inst: int, e: Instance) -> None:
        e.status = COMMITTED
        c = e.command
        self.socket.broadcast(Commit(
            str(owner), inst, c.key, c.value, e.seq,
            {str(k): v for k, v in e.deps.items()},
            c.client_id, c.command_id))
        self._execute()

    # ---- recovery (epaxos Prepare/PrepareReply, explicit prepare) -------
    async def _recovery_watchdog(self) -> None:
        while True:
            await asyncio.sleep(self.recovery_interval)
            try:
                # GC recovery records whose instance committed via a
                # competing recoverer or the returning owner; also
                # expire stalled rounds (lost Prepare/Accept broadcast)
                # so the stuck-scan can retry them at a higher ballot
                now = time.monotonic()
                for (o, i) in list(self.recoveries):
                    e = self.insts[o].get(i)
                    r = self.recoveries[(o, i)]
                    if e is not None and e.status >= COMMITTED:
                        del self.recoveries[(o, i)]
                    elif now - r.born > 2 * self.recovery_timeout:
                        del self.recoveries[(o, i)]
                for owner, inst in self._stuck_instances():
                    self.recover(owner, inst)
            except Exception:     # never kill the watchdog
                from paxi_tpu_torch.utils import log
                import traceback
                log.errorf("%s: recovery watchdog: %s", self.id,
                           traceback.format_exc())

    def _stuck_instances(self) -> List[Tuple[ID, int]]:
        """Instances needing takeover, from the _live set only:
        uncommitted past the timeout and either blocking execution as a
        direct dep of a committed instance, or known locally on a
        peer's row.  Dep holes (instances we have never seen) get a
        placeholder so the same age gate applies to them."""
        now = time.monotonic()
        stuck: List[Tuple[ID, int]] = []
        holes: List[Tuple[ID, int]] = []
        for (owner, i) in self._live:
            e = self.insts[owner].get(i)
            if e is None or e.status >= EXECUTED:
                continue
            if e.status == COMMITTED:
                for p, j in e.deps.items():
                    if j < 0:
                        continue
                    d = self.insts[p].get(j)
                    if d is None:
                        holes.append((p, j))
                    elif (d.status < COMMITTED
                            and now - d.born > self.recovery_timeout
                            and (p, j) not in self.recoveries):
                        stuck.append((p, j))
            elif (owner != self.id
                    and now - e.born > self.recovery_timeout
                    and (owner, i) not in self.recoveries):
                stuck.append((owner, i))
            elif (owner == self.id and e.ballot == 0
                    and e.request is not None
                    and now - e.born > self.recovery_timeout):
                # own stalled round (lost PreAccepts/Accepts and below
                # the fallback's majority): retransmit; dedup by the
                # distinct-acker sets, so this can never fake a quorum
                self._retransmit(i, e)
        for (p, j) in holes:
            # first sighting: start the age clock, recover next rounds
            ph = Instance(Command(NOOP_KEY, b""), 0, {}, status=NONE)
            self.insts[p][j] = ph
            self._live.add((p, j))
        return stuck

    def _retransmit(self, inst: int, e: Instance) -> None:
        e.born = time.monotonic()
        c = e.command
        if e.status == PREACCEPTED:
            self.socket.broadcast(PreAccept(
                str(self.id), inst, c.key, c.value, e.seq,
                {str(k): v for k, v in e.deps.items()},
                c.client_id, c.command_id))
        elif e.status == ACCEPTED:
            self.socket.broadcast(Accept(
                str(self.id), inst, c.key, c.value, e.seq,
                {str(k): v for k, v in e.deps.items()},
                c.client_id, c.command_id, e.ballot, str(self.id)))

    def recover(self, owner: ID, inst: int) -> None:
        """Take over (owner, inst) at a ballot above anything seen."""
        if (owner, inst) in self.recoveries:
            return
        e = self.insts[owner].get(inst)
        if e is not None and e.status >= COMMITTED:
            return
        if e is None:
            e = Instance(Command(NOOP_KEY, b""), 0, {}, status=NONE)
            self.insts[owner][inst] = e
            self._live.add((owner, inst))
        b = next_ballot(max(e.ballot, e.accepted_ballot), self.id)
        r = _Recovery(ballot=b)
        self.recoveries[(owner, inst)] = r
        e.ballot = b
        r.replies[self.id] = PrepareReply(
            str(owner), inst, b, e.status, e.accepted_ballot,
            e.command.key, e.command.value, e.seq,
            {str(k): v for k, v in e.deps.items()}, str(self.id),
            e.command.client_id, e.command.command_id)
        self.socket.broadcast(Prepare(str(owner), inst, b, str(self.id)))
        self._recovery_decide(owner, inst, r)

    def handle_prepare(self, m: Prepare) -> None:
        owner = ID(m.owner)
        e = self.insts[owner].get(m.inst)
        if e is None:
            e = Instance(Command(NOOP_KEY, b""), 0, {}, status=NONE)
            self.insts[owner][m.inst] = e
            self._live.add((owner, m.inst))
        if m.ballot > e.ballot:
            e.ballot = m.ballot
        self.socket.send(ID(m.src), PrepareReply(
            m.owner, m.inst, e.ballot, e.status, e.accepted_ballot,
            e.command.key, e.command.value, e.seq,
            {str(k): v for k, v in e.deps.items()}, str(self.id),
            e.command.client_id, e.command.command_id))

    def handle_prepare_reply(self, m: PrepareReply) -> None:
        owner = ID(m.owner)
        r = self.recoveries.get((owner, m.inst))
        if r is None or r.decided:
            return
        if m.ballot > r.ballot:
            # a higher-ballot recoverer owns this instance now; back off
            # (the watchdog re-triggers if it dies too)
            del self.recoveries[(owner, m.inst)]
            e = self.insts[owner].get(m.inst)
            if e is not None:
                e.ballot = max(e.ballot, m.ballot)
                e.born = time.monotonic()
            return
        if m.ballot < r.ballot:
            return   # stale reply from an older prepare round of ours
        r.replies[ID(m.id)] = m
        self._recovery_decide(owner, m.inst, r)

    def _recovery_decide(self, owner: ID, inst: int, r: _Recovery) -> None:
        if r.decided or len(r.replies) < self.maj:
            return
        replies = list(r.replies.values())
        committed = [p for p in replies if p.status >= COMMITTED]
        accepted = [p for p in replies if p.status == ACCEPTED]
        preaccepted = [p for p in replies if p.status == PREACCEPTED]
        r.decided = True
        if committed:
            p = committed[0]
            self._finish_recovery(owner, inst, r, p, commit=True)
        elif accepted:
            p = max(accepted, key=lambda p: p.accepted_ballot)
            self._finish_recovery(owner, inst, r, p, commit=False)
        elif preaccepted:
            # A surviving fast-path commit implies >= floor(N/2)
            # identical replies from acceptors OTHER than the owner in
            # any prepare majority (fast-quorum intersection).  Only
            # that condition licenses jumping straight to Accept; a
            # bare plurality — e.g. the owner's initial attrs echoed by
            # one acceptor — says nothing about dependency completeness
            # (an interfering command may have committed on a disjoint
            # slow-path quorum that never saw this one).  Below the
            # threshold, restart phase 1 at the recovery ballot to
            # recompute the dep union from live conflict maps.
            groups: Dict[tuple, List[PrepareReply]] = {}
            for p in preaccepted:
                sig = (p.seq, tuple(sorted(p.deps.items())), p.key, p.value)
                groups.setdefault(sig, []).append(p)

            def support(g: List[PrepareReply]) -> int:
                return sum(1 for p in g if ID(p.id) != owner)

            best = max(groups.values(), key=support)
            if support(best) >= self.n // 2:
                self._finish_recovery(owner, inst, r, best[0], commit=False)
            else:
                self._repreaccept(owner, inst, r, best[0])
        else:
            # nobody saw the command: commit a NOOP to unblock the hole
            noop = PrepareReply(str(owner), inst, r.ballot, NONE, 0,
                                NOOP_KEY, b"", 0, {}, str(self.id))
            self._finish_recovery(owner, inst, r, noop, commit=True)

    def _finish_recovery(self, owner: ID, inst: int, r: _Recovery,
                         p: PrepareReply, commit: bool) -> None:
        cmd = Command(p.key, p.value, p.client_id, p.command_id)
        deps = {ID(k): v for k, v in p.deps.items()}
        prev = self.insts[owner].get(inst)
        e = Instance(cmd, p.seq, dict(deps),
                     request=prev.request if prev else None,
                     ballot=r.ballot, accepted_ballot=r.ballot)
        if commit:
            e.status = COMMITTED
            self._record(owner, inst, e)   # NOOPs skip the conflict map
            del self.recoveries[(owner, inst)]
            self._commit(owner, inst, e)
        else:
            e.status = ACCEPTED
            self._record(owner, inst, e)
            r.phase = 2
            r.accept_acked = {self.id}
            self.socket.broadcast(Accept(
                str(owner), inst, cmd.key, cmd.value, e.seq,
                {str(k): v for k, v in e.deps.items()},
                cmd.client_id, cmd.command_id, r.ballot, str(self.id)))
            self._recovery_accept_ack(owner, inst, r, None)

    def _repreaccept(self, owner: ID, inst: int, r: _Recovery,
                     p: PrepareReply) -> None:
        """Restarted phase 1 (epaxos explicit-prepare's TryPreAccept
        analog): re-PreAccept the command at the recovery ballot,
        recomputing seq/deps as the union over a majority of acceptors'
        live conflict maps, then Accept — never the fast path."""
        cmd = Command(p.key, p.value, p.client_id, p.command_id)
        r.phase = 3
        r.cmd = cmd
        mseq, mdeps = self._attrs(cmd.key, (owner, inst))
        r.seq = max(p.seq, mseq)
        r.deps = {ID(k): v for k, v in p.deps.items()}
        for k, v in mdeps.items():
            r.deps[k] = max(r.deps.get(k, -1), v)
        r.pre_acked = {self.id}
        prev = self.insts[owner].get(inst)
        self._record(owner, inst, Instance(
            cmd, r.seq, dict(r.deps),
            request=prev.request if prev else None, ballot=r.ballot))
        self.socket.broadcast(PreAccept(
            str(owner), inst, cmd.key, cmd.value, r.seq,
            {str(k): v for k, v in r.deps.items()},
            cmd.client_id, cmd.command_id, r.ballot, str(self.id)))
        self._recovery_preaccept_ack(owner, inst, r, None)

    def _recovery_preaccept_ack(self, owner: ID, inst: int, r: _Recovery,
                                m: Optional[PreAcceptReply]) -> None:
        if m is not None:
            r.pre_acked.add(ID(m.id))
            r.seq = max(r.seq, m.seq)
            for k, v in m.deps.items():
                kid = ID(k)
                r.deps[kid] = max(r.deps.get(kid, -1), v)
        if len(r.pre_acked) < self.maj:
            return
        merged = PrepareReply(
            str(owner), inst, r.ballot, PREACCEPTED, r.ballot,
            r.cmd.key, r.cmd.value, r.seq,
            {str(k): v for k, v in r.deps.items()}, str(self.id),
            r.cmd.client_id, r.cmd.command_id)
        self._finish_recovery(owner, inst, r, merged, commit=False)

    def _recovery_accept_ack(self, owner: ID, inst: int, r: _Recovery,
                             acker: Optional[ID]) -> None:
        if acker is not None:
            r.accept_acked.add(acker)
        if len(r.accept_acked) >= self.maj:
            e = self.insts[owner].get(inst)
            if e is None or e.status >= COMMITTED:
                self.recoveries.pop((owner, inst), None)
                return
            self.slow_commits += 1
            self.recoveries.pop((owner, inst), None)
            self._commit(owner, inst, e)

    def handle_commit(self, m: Commit) -> None:
        owner = ID(m.owner)
        prev = self.insts[owner].get(m.inst)
        if prev is not None and prev.status >= COMMITTED:
            return   # recovery re-Commits must not re-execute
        e = Instance(Command(m.key, m.value, m.client_id, m.command_id),
                     m.seq, {ID(k): v for k, v in m.deps.items()},
                     status=COMMITTED,
                     request=prev.request if prev else None)
        self._record(owner, m.inst, e)
        self._execute()

    # ---- execution (exec.go: Tarjan SCC + seq order) --------------------
    def _execute(self) -> None:
        """Execute every committed instance whose transitive dependency
        closure is committed, SCC-by-SCC in reverse topological order,
        within an SCC by (seq, owner)."""
        index: Dict[Tuple[ID, int], int] = {}
        low: Dict[Tuple[ID, int], int] = {}
        on_stack: Dict[Tuple[ID, int], bool] = {}
        stack: List[Tuple[ID, int]] = []
        counter = [0]
        blocked: Dict[Tuple[ID, int], bool] = {}

        def node(u: Tuple[ID, int]) -> Optional[Instance]:
            return self.insts[u[0]].get(u[1])

        def strongconnect(u: Tuple[ID, int]) -> None:
            # iterative Tarjan (explicit stack) to survive deep chains
            work = [(u, iter(self._neighbors(u)))]
            index[u] = low[u] = counter[0]
            counter[0] += 1
            stack.append(u)
            on_stack[u] = True
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    nw = node(w)
                    if nw is None or nw.status < COMMITTED:
                        blocked[v] = True   # uncommitted dep: defer
                        continue
                    if nw.status >= EXECUTED:
                        continue
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack[w] = True
                        work.append((w, iter(self._neighbors(w))))
                        advanced = True
                        break
                    elif on_stack.get(w):
                        low[v] = min(low[v], index[w])
                    else:
                        # cross-edge into a component already finished
                        # THIS pass: if it was deferred (blocked on an
                        # uncommitted dep), so is everything that
                        # depends on it — without this, a read could
                        # execute ahead of its deferred dependency and
                        # return a stale value (observed under fault
                        # injection: soak_host.py, epaxos, 718
                        # anomalies)
                        blocked[v] = blocked.get(v, False) \
                            or blocked.get(w, False)
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
                    blocked[parent] = blocked.get(parent) or blocked.get(v, False)
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        comp.append(w)
                        if w == v:
                            break
                    if not any(blocked.get(w, False) for w in comp):
                        comp.sort(key=lambda w: (node(w).seq, str(w[0]), w[1]))
                        for w in comp:
                            self._apply(w, node(w))
                    else:
                        for w in comp:
                            blocked[w] = True

        roots = sorted((w for w in self._live
                        if (n := node(w)) is not None
                        and n.status == COMMITTED),
                       key=lambda w: (str(w[0]), w[1]))
        for w in roots:
            if w not in index:
                strongconnect(w)

    def _neighbors(self, u: Tuple[ID, int]) -> List[Tuple[ID, int]]:
        e = self.insts[u[0]].get(u[1])
        if e is None:
            return []
        return [(p, j) for p, j in e.deps.items() if j >= 0]

    def _apply(self, w: Tuple[ID, int], e: Instance) -> None:
        if e.status >= EXECUTED:
            return
        e.status = EXECUTED
        self._live.discard(w)
        if e.command.key == NOOP_KEY:
            if e.request is not None:
                e.request.reply(Reply(e.command, err="noop"))
                e.request = None
            return
        value = self.db.execute(e.command)
        if e.request is not None:
            e.request.reply(Reply(e.command, value=value))
            e.request = None


def new_replica(id: ID, cfg: Config) -> EPaxosReplica:
    return EPaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  The sim splits recovery onto separate
# ballot-carrying planes (racc/raccr/rcmt) so an owner and a recoverer
# broadcasting in the same step never collide on a wheel edge; on the
# host both paths travel the SAME wire classes (Accept/AcceptReply/
# Commit carry the ballot), so the recovery planes fold back onto them.
# The ``gc`` executed-frontier gossip is kernel-internal window flow
# control with no host wire analog (the host's unbounded dict log never
# recycles) — baselined in analysis/baseline.toml.
TRACE_MSG_MAP = {
    "pa": "PreAccept", "par": "PreAcceptReply",
    "acc": "Accept", "accr": "AcceptReply", "cmt": "Commit",
    "prep": "Prepare", "prepr": "PrepareReply",
    "racc": "Accept", "raccr": "AcceptReply", "rcmt": "Commit",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    # instance ring SoA <-> Instance aggregates in self.insts
    "cmd":       "insts",
    "seq":       "insts",
    "deps":      "insts",
    "status":    "insts",
    "executed":  "status",           # EXECUTED is a status on the host
    "bal":       "ballot",           # promised ballot per cell
    "abal":      "accepted_ballot",
    "age":       "born",             # frontier-block steps <-> wall-clock age
    # command-leader driving state
    "cur":       "next_inst",
    "pa_acks":   "acked",            # PreAccept ack bitmask <-> set
    "ac_acks":   "accept_acked",
    "agree":     "changed",          # fast-path attr agreement (inverse)
    "seq0":      "seq",              # original vs merged attrs: the host
    "deps0":     "deps",             # folds both into the Instance
    "mseq":      "seq",
    "mdeps":     "deps",
    # recovery driving state <-> Recovery entries
    "rphase":    "recoveries",
    "rowner":    "owner",
    "rinst":     "inst",
    "rballot":   "ballot",
    "racks":     "replies",          # prepare-round replies
    "rstat":     "replies",          # per-replier recorded state
    "rcmd":      "replies",
    "rseq2":     "replies",
    "rabal":     "replies",
    "rdeps2":    "replies",
    "rcseq":     "replies",
    "rcdeps":    "replies",
    "rdcmd":     "recoveries",       # decided attrs driven via Accept
    "rdseq":     "recoveries",
    "rddeps":    "recoveries",
    "aacks":     "accept_acked",
    "base":      "",  # instance ring window: host insts dicts are unbounded
    "stuck":     "",  # leader retry ticks: host fallback timer is wall-clock
    "rstuck":    "",  # recovery retry ticks (kernel-only)
    "recovered": "",  # completed-recovery counter (metrics)
    "gfront":    "",  # GC gossip frontier: the host log never recycles
                      # (see the PXT302 `gc` baseline entry)
    "ccount":    "",  # commit counter (metrics)
    "xcount":    "",  # execution counter (metrics)
    "kcount":    "",  # per-key execution oracle (invariant bookkeeping)
    "khash":     "",
    # on-device observability — measurement planes, excluded
    # from the trace witness hash; the host twins are the registry's
    # live latency histograms and the post-hoc linearizability checker
    "m_prop_t":      "",
    "m_commit_dt":   "",   # pending deltas for the deferred flush
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
}
