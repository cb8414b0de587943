"""WPaxos replica for the host (deployment) runtime.

Reference: paxi wpaxos/ [driver] — every key is its own Paxos object
(per-key ballot, log, and quorums); a replica whose zone's clients keep
demanding a remote key *steals* it by running phase-1 on that key's
ballot (the ballot embeds zone.node via the ballot encoding); the
``Policy`` (core/policy.py, policy.go) decides when; quorums are
flexible grids (quorum.go): phase-1 needs zone-majorities in
``Z - q2 + 1`` zones, phase-2 zone-majorities in ``q2`` zones (default
1 => steady-state commits stay zone-local — the WAN win).

The same protocol runs as a sim kernel in ``sim.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from paxi_tpu_torch.core.ballot import ballot_id, next_ballot
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.policy import Policy, new_policy
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

NOOP = Command(key=-1, value=b"\x00noop")


@register_message
@dataclass
class WP1a:
    key: int
    ballot: int
    # stealer's execute frontier for the key: ackers ship their session
    # table only when ahead of it, so steady-state steals (equal
    # frontiers) pay no per-client wire cost
    execute: int = 0


@register_message
@dataclass
class WP1b:
    key: int
    ballot: int
    id: str
    # slot -> [ballot, key, value, client_id, command_id, committed]
    log: Dict[int, list] = field(default_factory=dict)
    # state transfer: sender's execute frontier + its current value for
    # the key, standing in for the executed prefix the log omits
    execute: int = 0
    snap: bytes = b""
    # at-most-once session table for this key (ADVICE r2 medium):
    # client_id -> [command_id, value] of its highest executed command
    ctab: Dict[str, list] = field(default_factory=dict)


@register_message
@dataclass
class WP2a:
    key: int
    ballot: int
    slot: int
    value: bytes
    client_id: str = ""
    command_id: int = 0


@register_message
@dataclass
class WP2b:
    key: int
    ballot: int
    slot: int
    id: str


@register_message
@dataclass
class WP3:
    key: int
    ballot: int
    slot: int
    value: bytes
    client_id: str = ""
    command_id: int = 0


@dataclass
class Entry:
    ballot: int
    command: Command
    commit: bool = False
    request: Optional[Request] = None
    quorum: Optional[Quorum] = None


class KeyObject:
    """One per-key Paxos instance (wpaxos's paxos-object-per-key)."""

    def __init__(self):
        self.ballot = 0
        self.active = False
        self.log: Dict[int, Entry] = {}
        self.slot = -1
        self.execute = 0
        self.p1_quorum: Optional[Quorum] = None
        self.p1b_logs: Dict[ID, Dict[int, list]] = {}
        self.p1b_meta: Dict[ID, tuple] = {}   # id -> (execute, snap, ctab)
        self.pending: list = []
        # per-key at-most-once filter: a steal's frontier jump re-pends
        # uncommitted entries whose true outcome was compacted away; if
        # the old quorum in fact executed them, _exec must skip the
        # re-proposal instead of re-applying an old write over newer
        # ones.  client_id -> (highest executed command_id, value);
        # command_ids are client-monotonic, so per-key subsequences are
        # monotonic too.
        self.ctab: Dict[str, tuple] = {}


class WPaxosReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.objs: Dict[int, KeyObject] = {}
        self.policies: Dict[int, Policy] = {}
        self.steals = 0
        z = len(cfg.zones())
        self.q2 = 1                      # phase-2 zones (paxi default)
        self.q1 = max(z - self.q2 + 1, 1)  # phase-1 zones; q1+q2 > Z
        self.register(Request, self.handle_request)
        self.register(WP1a, self.handle_p1a)
        self.register(WP1b, self.handle_p1b)
        self.register(WP2a, self.handle_p2a)
        self.register(WP2b, self.handle_p2b)
        self.register(WP3, self.handle_p3)

    def obj(self, key: int) -> KeyObject:
        if key not in self.objs:
            self.objs[key] = KeyObject()
        return self.objs[key]

    def policy(self, key: int) -> Policy:
        if key not in self.policies:
            self.policies[key] = new_policy(self.cfg.policy,
                                            self.cfg.threshold)
        return self.policies[key]

    def owner(self, o: KeyObject) -> Optional[ID]:
        return ballot_id(o.ballot) if o.ballot else None

    def owns(self, o: KeyObject) -> bool:
        return o.active and self.owner(o) == self.id

    # ---- client requests + policy --------------------------------------
    def handle_request(self, req: Request) -> None:
        k = req.command.key
        o = self.obj(k)
        if self.owns(o):
            self.propose(o, k, req)
            return
        owner = self.owner(o)
        if owner is None or owner == self.id:
            # unowned key (first toucher acquires it), or our steal is
            # already in flight: queue until phase-1 resolves
            o.pending.append(req)
            if not self.steal_in_flight(o):
                self.steal(k, o)
            return
        # owned elsewhere: my zone is demanding this key — let the policy
        # decide between forwarding and stealing (policy.go seam)
        if self.policy(k).hit(self.id.zone) == self.id.zone:
            o.pending.append(req)
            if not self.steal_in_flight(o):
                self.steal(k, o)
        else:
            self.forward(owner, req)

    def steal_in_flight(self, o: KeyObject) -> bool:
        return (o.p1_quorum is not None and not o.active
                and ballot_id(o.ballot) == self.id)

    def steal(self, k: int, o: KeyObject) -> None:
        """wpaxos steal: phase-1 on this key's ballot."""
        o.ballot = next_ballot(o.ballot, self.id)
        o.active = False
        o.p1_quorum = Quorum(self.cfg.ids)
        o.p1_quorum.ack(self.id)
        o.p1b_logs = {self.id: self._log_payload(o)}
        o.p1b_meta = {self.id: (o.execute, self.db.get(k) or b"", {})}
        self.steals += 1
        self.socket.broadcast(WP1a(k, o.ballot, o.execute))
        self._maybe_win(k, o)

    def _log_payload(self, o: KeyObject) -> Dict[int, list]:
        # O(unexecuted window): slots below the sender's execute frontier
        # are covered by the (execute, snap) state transfer in WP1b —
        # the winner adopts the max frontier's value instead of needing
        # every executed committed entry (which would otherwise let a
        # stealer NOOP over a committed, executed write)
        return {s: [e.ballot, e.command.key, e.command.value,
                    e.command.client_id, e.command.command_id, e.commit]
                for s, e in o.log.items() if s >= o.execute}

    # ---- phase 1 (steal) -----------------------------------------------
    def handle_p1a(self, m: WP1a) -> None:
        o = self.obj(m.key)
        if m.ballot > o.ballot:
            o.ballot = m.ballot
            o.active = False
            self._repend(o)
        ctab = ({c: [i, v] for c, (i, v) in o.ctab.items()}
                if o.execute > m.execute else {})  # receiver drops it else
        self.socket.send(ballot_id(m.ballot),
                         WP1b(m.key, o.ballot, str(self.id),
                              self._log_payload(o), o.execute,
                              self.db.get(m.key) or b"", ctab))

    def _repend(self, o: KeyObject) -> None:
        for e in o.log.values():
            if not e.commit and e.request is not None:
                o.pending.append(e.request)
                e.request = None
        self._drain(o)

    def handle_p1b(self, m: WP1b) -> None:
        o = self.obj(m.key)
        if m.ballot != o.ballot or o.active:
            if m.ballot > o.ballot:
                o.ballot = m.ballot
                o.active = False
            return
        if o.p1_quorum is None or ballot_id(o.ballot) != self.id:
            return
        o.p1_quorum.ack(ID(m.id))
        o.p1b_logs[ID(m.id)] = m.log
        o.p1b_meta[ID(m.id)] = (m.execute, m.snap, m.ctab)
        self._maybe_win(m.key, o)

    def _maybe_win(self, k: int, o: KeyObject) -> None:
        if o.p1_quorum is None or not o.p1_quorum.grid_q1(self.q1):
            return
        # adopted: merge P1b logs exactly like single-leader recovery
        o.active = True
        o.p1_quorum = None
        # state transfer first: any acker ahead of our execute frontier
        # has executed (hence committed) everything below its frontier —
        # adopt its KV value and jump our frontier there, so the merge
        # below never NOOP-fills an executed slot
        front, snap, ctab = max(o.p1b_meta.values(),
                                key=lambda t: t[0], default=(0, b"", {}))
        if front > o.execute:
            # adopt the acker's session table before re-pending, so a
            # skipped command the old quorum already executed is
            # filtered by _exec rather than applied a second time
            for c, (i, v) in ctab.items():
                if c not in o.ctab or o.ctab[c][0] < int(i):
                    o.ctab[c] = (int(i), v)
            # same request handling as paxos host's frontier jump:
            # re-pend skipped uncommitted entries; committed ones get
            # acks for writes, the snapshot value for reads
            for s in range(o.execute, front):
                e = o.log.get(s)
                if e is None or e.request is None:
                    continue
                if e.commit:
                    v = snap if e.command.is_read() else b""
                    e.request.reply(Reply(e.command, value=v))
                else:
                    o.pending.append(e.request)
                e.request = None
            if snap:
                self.db.put(k, snap)
            o.execute = front
            o.slot = max(o.slot, front - 1)
        merged: Dict[int, tuple] = {}
        top = o.slot
        for log in o.p1b_logs.values():
            for s_raw, (bal, key, value, cid, cmid, committed) in log.items():
                s = int(s_raw)
                top = max(top, s)
                cmd = Command(int(key), value, cid, int(cmid))
                cur = merged.get(s)
                if committed:
                    merged[s] = (bal, cmd, True)
                elif cur is None or (not cur[2] and bal > cur[0]):
                    merged[s] = (bal, cmd, False)
        for s in range(o.execute, top + 1):
            bal, cmd, committed = merged.get(s, (0, NOOP, False))
            prev = o.log.get(s)
            req = prev.request if prev else None
            if prev is not None and prev.commit:
                continue
            if committed:
                o.log[s] = Entry(bal, cmd, commit=True, request=req)
            else:
                self.propose(o, k, req, command=cmd, at_slot=s)
        o.slot = max(o.slot, top)
        self._exec(k, o)
        self._drain(o)

    def _drain(self, o: KeyObject) -> None:
        pending, o.pending = o.pending, []
        for req in pending:
            self.handle_request(req)

    # ---- phase 2 -------------------------------------------------------
    def propose(self, o: KeyObject, k: int, req: Optional[Request],
                command: Optional[Command] = None,
                at_slot: Optional[int] = None) -> None:
        cmd = command if command is not None else req.command
        if at_slot is None:
            o.slot += 1
            slot = o.slot
        else:
            slot = at_slot
            o.slot = max(o.slot, slot)
        q = Quorum(self.cfg.ids)
        q.ack(self.id)
        o.log[slot] = Entry(o.ballot, cmd, request=req, quorum=q)
        self.socket.broadcast(WP2a(k, o.ballot, slot, cmd.value,
                                   cmd.client_id, cmd.command_id))
        if q.grid_q2(self.q2):  # one-node zones
            self._commit(k, o, slot)

    def handle_p2a(self, m: WP2a) -> None:
        o = self.obj(m.key)
        if m.ballot >= o.ballot:
            if m.ballot > o.ballot:
                o.ballot = m.ballot
                o.active = False
                self._repend(o)
            e = o.log.get(m.slot)
            if e is None or (not e.commit and m.ballot >= e.ballot):
                req = e.request if e else None
                o.log[m.slot] = Entry(
                    m.ballot, Command(m.key, m.value, m.client_id,
                                      m.command_id), request=req)
            o.slot = max(o.slot, m.slot)
        self.socket.send(ballot_id(m.ballot),
                         WP2b(m.key, o.ballot, m.slot, str(self.id)))

    def handle_p2b(self, m: WP2b) -> None:
        o = self.obj(m.key)
        if m.ballot > o.ballot:
            o.ballot = m.ballot
            o.active = False
            self._repend(o)
            return
        e = o.log.get(m.slot)
        if (o.active and e is not None and not e.commit
                and m.ballot == o.ballot == e.ballot
                and e.quorum is not None):
            e.quorum.ack(ID(m.id))
            if e.quorum.grid_q2(self.q2):   # zone-local commit quorum
                self._commit(m.key, o, m.slot)

    def _commit(self, k: int, o: KeyObject, slot: int) -> None:
        e = o.log[slot]
        e.commit = True
        c = e.command
        self.socket.broadcast(WP3(k, o.ballot, slot, c.value,
                                  c.client_id, c.command_id))
        self._exec(k, o)

    def handle_p3(self, m: WP3) -> None:
        o = self.obj(m.key)
        e = o.log.get(m.slot)
        req = e.request if e else None
        o.log[m.slot] = Entry(m.ballot, Command(m.key, m.value, m.client_id,
                                                m.command_id),
                              commit=True, request=req)
        o.slot = max(o.slot, m.slot)
        self._exec(m.key, o)
        self._drain(o)

    def _exec(self, k: int, o: KeyObject) -> None:
        while True:
            e = o.log.get(o.execute)
            if e is None or not e.commit:
                break
            if e.command.key >= 0:
                cmd = e.command
                last = o.ctab.get(cmd.client_id) if cmd.client_id else None
                if last is not None and cmd.command_id <= last[0]:
                    # at-most-once: already executed (possibly in a
                    # compacted slot under a previous owner)
                    value = last[1] if cmd.command_id == last[0] else b""
                else:
                    value = self.db.execute(cmd)
                    if cmd.client_id:
                        o.ctab[cmd.client_id] = (cmd.command_id, value)
                if e.request is not None:
                    e.request.reply(Reply(e.command, value=value))
                    e.request = None
            elif e.request is not None:
                e.request.reply(Reply(e.command, err="noop"))
                e.request = None
            o.execute += 1


def new_replica(id: ID, cfg: Config) -> WPaxosReplica:
    return WPaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  Wire-level identity: the sim kernel's
# five mailbox planes are the host runtime's five message classes
# (per-key ballots ride inside the payload on both sides).
TRACE_MSG_MAP = {
    "p1a": "WP1a", "p1b": "WP1b", "p2a": "WP2a", "p2b": "WP2b",
    "p3": "WP3",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.  The
# sim's per-object planes correspond to per-key ``KeyObject``
# aggregates on the host.
SIM_STATE_MAP = {
    "log_bal":     "log",        # per-object ring planes <-> KeyObject.log
    "log_cmd":     "log",
    "log_commit":  "log",
    "log_acks":    "log",        # P2b bitmask <-> Entry.quorum
    "next_slot":   "slot",
    "kv":          "db",
    "p1_acks":     "p1_quorum",  # in-flight steal ack bitmask
    "hits":        "policies",   # demand counters <-> Policy state
    "steal_obj":   "steals",     # in-flight steal target; completed count
    "base":        "",  # ring-window base: host logs are unbounded dicts
    "proposed":    "",  # own-ballot P2a mask: implied by Entry existence
    "steal_timer": "",  # steal retry step-timer: host retries are wall-clock
    # zone-latency accounting (scenario bench axis) — measurement
    # planes, not protocol state; excluded from the trace witness hash
    "m_prop_t":        "",
    "m_lat_local_sum": "",
    "m_lat_local_n":   "",
    "m_lat_cross_sum": "",
    "m_lat_cross_n":   "",
    # on-device commit-latency histogram + in-scan spot-check
    # — the host-side twin is the registry's live latency histograms
    # and the post-hoc linearizability checker, not node state
    "m_lat_hist":      "",
    "m_lat_sum":       "",
    "m_inscan_viol":   "",
}
