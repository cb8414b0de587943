"""WanKeeper replica for the host (deployment) runtime.

Reference: the paxi lineage's wankeeper/ package (SURVEY §2.2 "others")
— hierarchical token/lease coordination: a **root** coordinator grants
per-key tokens to zones; a key's operations execute in the zone holding
its token (zone-majority replication, zone-local latency); cross-zone
demand triggers a revoke → flush → grant handoff through the root, with
the key's version travelling so the receiving zone resumes where the
releasing zone committed.

Host re-design (event-driven lease form; the sim kernel in ``sim.py``
runs the log-derived form):
- The root is elected with ballots (Root1a/Root1b).  Its token table is
  **soft state**: every Root1b carries the sender's zone-held tokens
  (the ground truth lives with the holders) and the rebuild MERGES
  reports over the Grant-tracked table, so a root crash costs one
  election, never exclusivity: an unreported holder keeps its entry
  (its keys stall until its leader answers a revoke — leases here have
  no expiry clock), late reports fold in unless the key was granted
  away under the new ballot, and grants/revokes are ballot-fenced so a
  deposed root cannot move tokens.
- Zone leaders are static (lowest id per zone — intra-zone failover is
  out of scope here, as in the sim kernel).  A zone leader replicates
  writes to its zone (``ZWrite``/``ZAck``, zone-majority) and serves
  reads locally while holding the token (the lease makes this
  linearizable — the WanKeeper latency argument).
- Handoff: root sends ``Revoke(key, gen)``; the holder stops, waits
  for its zone-majority flush, then reports ``Rel(key, ver, gen)``
  (retried); the root then ``Grant(key, zone, ver, gen)``s the waiting
  zone, whose leader adopts the version and drains its queued ops.
  Generations fence stale reports, exactly like the sim kernel.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from paxi_tpu_torch.core.ballot import ballot_id, next_ballot
from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


@register_message
@dataclass
class Root1a:
    ballot: int


@register_message
@dataclass
class Root1b:
    ballot: int
    id: str
    # ground truth from the holders: key -> version for tokens MY ZONE
    # holds (zone leaders report; members report {})
    held: Dict[int, int] = field(default_factory=dict)


@register_message
@dataclass
class TReq:
    """Zone leader -> root: my zone wants key's token."""

    key: int
    zone: int


@register_message
@dataclass
class Revoke:
    """Root -> holding zone leader: release key's token.  Ballot-fenced
    so a deposed root's revokes are ignored."""

    key: int
    gen: int
    ballot: int = 0


@register_message
@dataclass
class Rel:
    """Holder -> root: flushed; key's final committed version AND value
    (object state travels with the token; retried until the matching
    Grant is observed)."""

    key: int
    ver: int
    value: bytes
    gen: int


@register_message
@dataclass
class Grant:
    """Root -> everyone (so every replica tracks the table): key now
    belongs to ``zone`` at ``ver`` with ``value``."""

    key: int
    zone: int
    ver: int
    value: bytes
    gen: int
    ballot: int = 0     # fence: grants from a deposed root are ignored


@register_message
@dataclass
class ZWrite:
    """Zone leader -> zone members: apply (key, ver, value) in order."""

    key: int
    ver: int
    value: bytes


@register_message
@dataclass
class ZAck:
    key: int
    ver: int
    id: str


@dataclass
class _Op:
    req: Request
    ver: Optional[int] = None          # assigned once writable


class WanKeeperReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        zs = cfg.zones()
        self.zone = self.id.zone
        self.zone_ids = [i for i in cfg.ids if i.zone == self.zone]
        self.zone_leader = self.zone_ids[0]
        self.n_zones = len(zs)
        # token table: key -> zone (every replica tracks via Grants);
        # home assignment mirrors the sim kernel (key mod zones, over
        # the sorted zone list)
        self.zs = zs
        self.tokens: Dict[int, int] = {}
        self.ver: Dict[int, int] = {}      # my applied version per key
        self.val: Dict[int, bytes] = {}
        # durable grant floor (the sim kernel's gver, host form): last
        # granted (ver, value) per key, tracked from the broadcast
        # Grants by EVERY replica.  Grants and release reports are
        # floored at it, so a dropped Grant can never make a later
        # handoff resume below a committed, client-acked version.
        self.granted: Dict[int, Tuple[int, bytes]] = {}
        # highest Grant generation seen per key: fences out delayed /
        # duplicate Grants from an earlier handoff of the same key
        self.gen_seen: Dict[int, int] = {}
        # zone-leader state
        self.flushq: Dict[int, Quorum] = {}       # key -> current quorum
        self.pending: Dict[int, List[_Op]] = {}   # key -> queued ops
        self.revoking: Dict[int, int] = {}        # key -> gen to release
        # root state
        self.ballot = 0
        self.active = False
        self.root_quorum = Quorum(cfg.ids)
        self.gen = 0
        self.transit: Dict[int, Tuple[int, int]] = {}  # key -> (gen, zone)
        self.want: Dict[int, int] = {}
        self.granted_log: Set[Tuple[int, int]] = set()  # (key, gen) dedup
        self.granted_keys: Set[int] = set()   # granted under MY ballot
        self._done = 0                        # completed-op progress
        self.register(Request, self.handle_request)
        self.register(Root1a, self.handle_root1a)
        self.register(Root1b, self.handle_root1b)
        self.register(TReq, self.handle_treq)
        self.register(Revoke, self.handle_revoke)
        self.register(Rel, self.handle_rel)
        self.register(Grant, self.handle_grant)
        self.register(ZWrite, self.handle_zwrite)
        self.register(ZAck, self.handle_zack)

    async def start(self) -> None:
        await super().start()
        self._tasks.append(asyncio.create_task(self._watchdog()))

    async def _watchdog(self) -> None:
        stall = 0
        last_done = 0
        try:
            while True:
                await asyncio.sleep(0.05)
                # retry pending token requests (root may have changed)
                if self.is_zone_leader():
                    for k, ops in list(self.pending.items()):
                        if ops and self.holder(k) != self.zone \
                                and k not in self.revoking:
                            self._ask_root(k)
                    # retry unfinished releases
                    for k, gen in list(self.revoking.items()):
                        self._try_release(k, gen)
                # a dead root leaves a stale ballot behind: work in
                # flight with NO completed-op progress elects a fresh
                # root; under normal load ops keep completing and the
                # counter resets (ballot ordering resolves duels)
                if (self.pending or self.revoking) \
                        and self._done == last_done:
                    stall += 1
                    if stall >= 6:
                        stall = 0
                        self.run_root_election()
                else:
                    stall = 0
                last_done = self._done
        except asyncio.CancelledError:
            pass

    # ---- topology helpers ----------------------------------------------
    def is_zone_leader(self) -> bool:
        return self.id == self.zone_leader

    def home_zone(self, key: int) -> int:
        return self.zs[key % self.n_zones]

    def holder(self, key: int) -> Optional[int]:
        """Current holding zone per my table; None while in transit."""
        return self.tokens.get(key, self.home_zone(key))

    @property
    def root(self) -> Optional[ID]:
        return ballot_id(self.ballot) if self.ballot else None

    def is_root(self) -> bool:
        return self.active and self.root == self.id

    # ---- root election (token table rebuilt from holders) ---------------
    def run_root_election(self) -> None:
        self.ballot = next_ballot(self.ballot, self.id)
        self.active = False
        self.root_quorum = Quorum(self.cfg.ids)
        self.root_quorum.ack(self.id)
        self._1b_tables = {self.id: self._held_payload()}
        self.socket.broadcast(Root1a(self.ballot))

    def _held_payload(self) -> Dict[int, int]:
        if not self.is_zone_leader():
            return {}
        keys = set(self.ver) | set(self.tokens)
        return {k: self.ver.get(k, 0) for k in keys
                if self.holder(k) == self.zone}

    def handle_root1a(self, m: Root1a) -> None:
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
        self.socket.send(ballot_id(m.ballot),
                         Root1b(self.ballot, str(self.id),
                                self._held_payload()))

    def handle_root1b(self, m: Root1b) -> None:
        if m.ballot != self.ballot or self.active:
            if m.ballot > self.ballot:
                self.ballot = m.ballot
                self.active = False
            elif (m.ballot == self.ballot and self.is_root()):
                # late holder report: fold it in unless I already
                # granted the key away under this ballot
                for k in m.held:
                    if int(k) not in self.granted_keys:
                        self.tokens[int(k)] = ID(m.id).zone
            return
        self.root_quorum.ack(ID(m.id))
        self._1b_tables[ID(m.id)] = {int(k): int(v)
                                     for k, v in m.held.items()}
        if self.root_quorum.majority() and ballot_id(self.ballot) == self.id:
            self.active = True
            # rebuild: MERGE holder reports over my existing table (it
            # tracked every broadcast Grant).  A holder whose Root1b is
            # late keeps its entry — its keys stall until its leader
            # answers a revoke, rather than being re-granted into a
            # two-holders fork; late reports are folded in by
            # handle_root1b below.  A genuinely dead zone leader pins
            # its keys (leases here have no clock; the sim kernel's
            # log-derived variant has no such pin).
            for rid, held in self._1b_tables.items():
                for k in held:
                    self.tokens[k] = rid.zone
            self.transit = {}
            # generations are namespaced by ballot so a deposed root's
            # in-flight handshake can never collide with mine
            self.gen = self.ballot << 16
            self.granted_keys = set()

    # ---- client requests -------------------------------------------------
    def handle_request(self, req: Request) -> None:
        if not self.is_zone_leader():
            self.forward(self.zone_leader, req)
            return
        k = req.command.key
        self.pending.setdefault(k, []).append(_Op(req))
        if self.holder(k) == self.zone and k not in self.revoking:
            self._drain(k)
        else:
            self._ask_root(k)

    def _ask_root(self, k: int) -> None:
        if self.is_root():
            self.handle_treq(TReq(k, self.zone))
        elif self.root is not None:
            self.socket.send(self.root, TReq(k, self.zone))
        else:
            self.run_root_election()

    def _drain(self, k: int) -> None:
        """Serve queued ops for a held key, one write pipeline stage at
        a time (next write starts when the previous flushes)."""
        ops = self.pending.get(k, [])
        while ops and k not in self.revoking \
                and self.holder(k) == self.zone:
            op = ops[0]
            cmd = op.req.command
            if cmd.is_read():
                ops.pop(0)
                self._done += 1
                op.req.reply(Reply(cmd, value=self.val.get(k, b"")))
                continue
            if op.ver is None and k not in self.flushq:
                v = self.ver.get(k, 0) + 1
                op.ver = v
                q = Quorum(self.zone_ids)
                q.ack(self.id)
                self.flushq[k] = q
                self.ver[k] = v
                self.val[k] = cmd.value
                self.db.execute(cmd)
                for i in self.zone_ids:
                    if i != self.id:
                        self.socket.send(i, ZWrite(k, v, cmd.value))
                if q.majority():
                    self._write_flushed(k)
            break           # wait for the flush (or it already popped)
        if not ops:
            self.pending.pop(k, None)

    def _write_flushed(self, k: int) -> None:
        self.flushq.pop(k, None)
        ops = self.pending.get(k, [])
        if ops and ops[0].ver is not None:
            op = ops.pop(0)
            self._done += 1
            op.req.reply(Reply(op.req.command, value=b""))
        self._drain(k)
        if k in self.revoking:
            self._try_release(k, self.revoking[k])

    # ---- zone replication ------------------------------------------------
    def handle_zwrite(self, m: ZWrite) -> None:
        if m.ver > self.ver.get(m.key, 0):
            self.ver[m.key] = m.ver
            self.val[m.key] = m.value
            self.db.execute(Command(m.key, m.value))
        self.socket.send(self.zone_leader, ZAck(m.key, m.ver, str(self.id)))

    def handle_zack(self, m: ZAck) -> None:
        q = self.flushq.get(m.key)
        if q is not None and m.ver == self.ver.get(m.key, 0):
            q.ack(ID(m.id))
            if q.majority():
                self._write_flushed(m.key)

    # ---- root: token requests and handoffs -------------------------------
    def handle_treq(self, m: TReq) -> None:
        if not self.is_root():
            return
        k = m.key
        if k in self.transit:
            self.want[k] = m.zone       # latest request wins the grant
            return
        holder = self.holder(k)
        if holder == m.zone:
            # requester already owns it but may not know: re-grant
            self.gen += 1
            self._grant(k, m.zone, None, None, self.gen)
            return
        self.gen += 1
        self.transit[k] = (self.gen, m.zone)
        self.want[k] = m.zone
        hz_leader = min(j for j in self.cfg.ids if j.zone == holder)
        rv = Revoke(k, self.gen, self.ballot)
        if hz_leader == self.id:
            self.handle_revoke(rv)
        else:
            self.socket.send(hz_leader, rv)

    def handle_revoke(self, m: Revoke) -> None:
        if not self.is_zone_leader() or m.ballot < self.ballot:
            return
        # generation fence, symmetric with handle_grant's: a delayed /
        # duplicate Revoke from an EARLIER handoff must not overwrite a
        # newer pending revocation (the holder would then retry Rel at
        # the old gen forever while the root waits on the new one — a
        # permanent wedge), nor re-open a handoff whose Grant already
        # landed (gen_seen)
        if m.gen <= self.gen_seen.get(m.key, -1) \
                or m.gen < self.revoking.get(m.key, m.gen):
            return
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
        self.revoking[m.key] = m.gen
        self._try_release(m.key, m.gen)

    def _try_release(self, k: int, gen: int) -> None:
        if k in self.flushq:
            return                       # still flushing: Rel after
        # floor the report at the version the token was granted at
        # (sim kernel's rel_ver gver floor): if the Grant that carried
        # the state to my zone was lost, reporting my local ver would
        # regress the object's history at the next handoff
        ver, val = self.ver.get(k, 0), self.val.get(k, b"")
        gv, gval = self.granted.get(k, (0, b""))
        if ver < gv:
            ver, val = gv, gval
        msg = Rel(k, ver, val, gen)
        if self.is_root():
            self.handle_rel(msg)
        elif self.root is not None:
            self.socket.send(self.root, msg)

    def handle_rel(self, m: Rel) -> None:
        if not self.is_root():
            return
        t = self.transit.get(m.key)
        if t is not None:
            if t[0] != m.gen:
                return                   # stale generation: fenced off
            zone = self.want.get(m.key, t[1])
            self._grant(m.key, zone, m.ver, m.value, m.gen)
            return
        if (m.key, m.gen) in self.granted_log:
            return                       # duplicate of a completed handoff
        # no handshake in flight and an unknown generation: a holder is
        # retrying the release of a DEAD root's revoke — the Grant that
        # would answer it can never arrive, so without help the key
        # wedges whenever the holder's OWN zone wants it (no TReq is
        # sent for a held key, so no fresh Revoke re-keys the
        # handshake).  Answer with a fresh Grant under MY generation:
        # the holder resumes only via a root-issued Grant, never by
        # unilaterally dropping its revoking entry — a failed
        # candidate's Root1a bumps ballots without deposing the live
        # root, so "gen predates my ballot" alone must NOT re-open the
        # drain gate (two zones could end up draining concurrently).
        self.gen += 1
        self._grant(m.key, self.holder(m.key), m.ver, m.value, self.gen)

    def _grant(self, k: int, zone: int, ver: Optional[int],
               value: Optional[bytes], gen: int) -> None:
        if (k, gen) in self.granted_log:
            return
        self.granted_log.add((k, gen))
        self.granted_keys.add(k)
        self.transit.pop(k, None)
        self.want.pop(k, None)
        self.tokens[k] = zone
        if ver is None:
            ver, value = self.ver.get(k, 0), self.val.get(k, b"")
        # floor at the last granted (ver, value) — the sim kernel's
        # gver floor at the root.  The re-grant path (handle_treq with
        # holder == requester) lands here with my LOCAL state, which is
        # stale whenever my zone didn't hold the key last; without the
        # floor a single dropped Grant broadcast makes the re-grant
        # regress the holder below committed, client-acked writes.
        gv, gval = self.granted.get(k, (0, b""))
        if ver < gv:
            ver, value = gv, gval
        g = Grant(k, zone, ver, value, gen, self.ballot)
        self.socket.broadcast(g)
        self.handle_grant(g)

    def handle_grant(self, m: Grant) -> None:
        if m.ballot < self.ballot:
            return                       # a deposed root's grant
        # generation fence: a delayed or duplicate Grant from an
        # EARLIER handoff of this key (same ballot — the slow-link path
        # reorders) must not resurrect my holder state after a newer
        # Revoke, or two zones end up holding the token concurrently
        if m.gen < self.revoking.get(m.key, m.gen) \
                or m.gen <= self.gen_seen.get(m.key, -1):
            return
        self.gen_seen[m.key] = m.gen
        if m.ballot > self.ballot:
            self.ballot = m.ballot
            self.active = False
        if m.ver >= self.granted.get(m.key, (0, b""))[0]:
            self.granted[m.key] = (m.ver, m.value)
        self.tokens[m.key] = m.zone
        self.revoking.pop(m.key, None)
        if m.zone == self.zone and m.ver > self.ver.get(m.key, 0):
            # the object state rode the token: adopt it zone-wide
            self.ver[m.key] = m.ver
            self.val[m.key] = m.value
            self.db.execute(Command(m.key, m.value))
        if self.is_zone_leader() and m.zone == self.zone:
            self._drain(m.key)


def new_replica(id: ID, cfg: Config) -> WanKeeperReplica:
    return WanKeeperReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  The sim's root log (p2a/p3) carries the
# grant/revoke commands that the host runtime sends as explicit Grant
# messages, so log-plane faults project onto the Grant broadcast — a
# schedule homomorphism, not a wire-level identity.
TRACE_MSG_MAP = {
    "zrep": "ZWrite", "zack": "ZAck", "treq": "TReq", "rel": "Rel",
    "p1a": "Root1a", "p1b": "Root1b", "p2a": "Grant", "p3": "Grant",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    # token table + zone replication
    "token_zone": "tokens",      # holder zone per object
    "prev_zone":  "transit",     # releasing zone during a handoff
    "aver":       "flushq",      # member acked versions <-> flush Quorum
    "relv":       "revoking",    # reported release version (gen-gated)
    "pend":       "transit",     # revoke-in-flight mark at the root
    "pgen":       "gen_seen",    # executed-revoke generation fence
    "rgen":       "gen_seen",    # my zone's release generation
    "gver":       "granted",     # durable grant floor (host form)
    # root log (shared ballot-ring planes; cf. paxos/host.py)
    "p1_acks":    "root_quorum",
    "log_bal":    "granted_log", # root-log planes: the host root drives
    "log_cmd":    "granted_log", # grants off a leader lease + dedup log
    "log_commit": "granted_log", # (see the PXT302 p2b baseline entry)
    "log_acks":   "granted_log",
    "next_slot":  "gen",         # root command counter <-> generation
    "execute":    "_done",       # executed-prefix <-> progress counter
    "base":       "",  # ring-window base (kernel-only)
    "proposed":   "",  # own-ballot P2a mask (kernel-only)
    "timer":      "",  # election step-timer: host root uses wall-clock
    "stuck":      "",  # frontier-stall retry counter (kernel-only)
    "viol_acc":   "",  # invariant accumulator (oracle)
    "writes":     "",  # leader write counter (metrics)
    "transfers":  "",  # token-transfer counter (metrics)
    # zone-latency accounting (scenario bench axis) — measurement
    # planes, not protocol state; excluded from the trace witness hash
    "m_wr_t":          "",
    "m_wr_p":          "",
    "m_acq_t":         "",
    "m_acq_p":         "",
    "m_lat_local_sum": "",
    "m_lat_local_n":   "",
    "m_lat_cross_sum": "",
    "m_lat_cross_n":   "",
    # on-device commit-latency histogram + in-scan spot-check
    "m_prop_t":        "",
    "m_lat_hist":      "",
    "m_lat_sum":       "",
    "m_inscan_viol":   "",
}
