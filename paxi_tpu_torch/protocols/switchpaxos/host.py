"""SwitchPaxos replica for the host (deployment) runtime: Multi-Paxos
speaking through the in-fabric consensus tier (switchnet/).

Subclasses the Paxos replica (protocols/paxos/host.py) through its
message-class hooks: every frame is a switchnet-marked subclass the
``SwitchTier`` recognizes mid-flight on the virtual-clock fabric —
P1a frames raise the switch's promise and trigger a ``SwitchSnap``
register read (recovery MUST consult the registers), P2a frames are
voted on and sequence-stamped in flight, and every frame gossips the
sender's execute frontier for the tier's execution-gated register
eviction.

The three paths this module adds on top of classic Paxos:

- **fast commit**: a ``SwitchVote`` arriving one fabric delivery
  after the P2a broadcast commits the slot immediately — the classic
  majority-P2b tally still runs underneath (register overflow, switch
  down windows, and fabric-less deployments all fall back to it; with
  no fabric installed this replica IS the paxos replica).
- **gap agreement**: replicas track the ordered-multicast ``expect``
  counter and, on a stamp gap, ask the leader to retransmit the
  missing sequence number (``GapReq``) — committed frames come back
  as a targeted stamped P3, in-flight ones as a P2a retransmit that
  keeps its original stamp (the switch register remembers).  A
  session bump (sequencer failover) resyncs ``expect`` past the first
  stamp of the new session.
- **recovery through the switch**: ``_become_leader`` waits for the
  ``SwitchSnap`` and merges the register file as a pseudo-acker log,
  so a value committed via the in-network vote alone survives leader
  failover (the PXQ505 obligation, mirrored from the sim kernel's
  ``recovery_fold``).

The seeded twin (nogap.py) replaces gap agreement with unilateral
NOOP-commits of the holes — the same bug as the sim's
``PROTOCOL_NOGAP``, so hunt witnesses classify REPRODUCED.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from paxi_tpu_torch.core.ballot import ballot_id
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.protocols.paxos.host import (P1a, P1b, P2a, P2b, P3,
                                           PaxosReplica, _wire_cmds)
from paxi_tpu_torch.switchnet import SwitchSnap, SwitchTier, SwitchVote

__all__ = ["SwitchPaxosReplica", "new_replica", "SwitchTier"]

_SNAP_KEY = "__switch__"   # pseudo-acker key for the register read


# ---- switchnet-marked frames (tier recognition is by class attr) --------
@register_message
@dataclass
class SwP1a(P1a):
    switchnet_role = "p1a"


@register_message
@dataclass
class SwP1b(P1b):
    switchnet_role = "p1b"


@register_message
@dataclass
class OmP2a(P2a):
    """The ordered-multicast frame: the switch stamps sess/seq in
    flight (all broadcast copies share the object)."""

    sess: int = -1
    seq: int = -1
    execute: int = 0
    switchnet_role = "p2a"


@register_message
@dataclass
class SwP2b(P2b):
    execute: int = 0     # frontier gossip for register eviction
    switchnet_role = "p2b"


@register_message
@dataclass
class OmP3(P3):
    sess: int = -1
    seq: int = -1
    execute: int = 0
    switchnet_role = "p3"


@register_message
@dataclass
class GapReq:
    """Gap agreement: "retransmit the frame with sequence ``n``"."""

    n: int
    id: str


class SwitchPaxosReplica(PaxosReplica):
    P1A_CLS = SwP1a
    P1B_CLS = SwP1b
    P2A_CLS = OmP2a
    P2B_CLS = SwP2b
    P3_CLS = OmP3

    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.expect = 0                    # next expected sequence
        self.sess = 0                      # session last seen
        self.slot_seq: Dict[int, int] = {}  # slot -> received stamp
        self.seq_slot: Dict[int, int] = {}  # seq -> slot (leader side)
        self.gap_events = 0
        self.fast_commits = 0
        self._switch_snap = None
        fabric = self.socket.fabric
        # with no switch on the wire this replica degrades to classic
        # paxos: no votes arrive, no stamps, majority path only
        self._sw_expected = (fabric is not None
                             and getattr(fabric, "switch", None)
                             is not None)
        # the switchnet frame classes dispatch on their exact type
        # (Node.handles is keyed by type, not by isinstance)
        self.register(SwP1a, self.handle_p1a)
        self.register(SwP1b, self.handle_p1b)
        self.register(OmP2a, self.handle_p2a)
        self.register(SwP2b, self.handle_p2b)
        self.register(OmP3, self.handle_p3)
        self.register(SwitchVote, self.handle_switch_vote)
        self.register(SwitchSnap, self.handle_switch_snap)
        self.register(GapReq, self.handle_gapreq)

    # ---- the in-network fast path ---------------------------------------
    def handle_switch_vote(self, m: SwitchVote) -> None:
        """The switch accepted my frame: commit after ONE delivery."""
        if m.seq >= 0:
            self.seq_slot[m.seq] = m.slot
            self.slot_seq[m.slot] = m.seq
        if not self.active or m.ballot != self.ballot:
            return
        e = self.log.get(m.slot)
        if e is not None and not e.commit and e.ballot == m.ballot:
            self.fast_commits += 1
            self._commit(m.slot)

    def _commit(self, slot: int) -> None:
        """Commit + stamped P3 broadcast (the stamp lets followers'
        ``expect`` advance over holes healed by P3)."""
        e = self.log[slot]
        e.commit = True
        self._renew_lease(e.timestamp)
        self.socket.broadcast(OmP3(
            self.ballot, slot, _wire_cmds(e.cmds), sess=self.sess,
            seq=self.slot_seq.get(slot, -1), execute=self.execute))
        self._exec()

    # ---- sequencer tracking + gap agreement ------------------------------
    def _note_stamp(self, sess: int, seq: int, slot: int) -> None:
        if sess > self.sess:
            # sequencer failover: resync past the new session's first
            # stamp (old-session holes heal via retry/P3).  max(): a
            # P3 retransmit carries the CURRENT session over its
            # frame's ORIGINAL stamp — resync only ever raises
            self.sess = sess
            self.expect = max(self.expect, seq + 1)
        self.slot_seq[slot] = seq
        known = set(self.slot_seq.values())
        while self.expect in known:
            self.expect += 1

    def _on_gap(self, m: OmP2a) -> None:
        """The gap-agreement slow path: ask the frame's sender to
        retransmit the first missing sequence number."""
        self.gap_events += 1
        self.socket.send(ballot_id(m.ballot),
                         GapReq(self.expect, str(self.id)))

    def _make_p2a(self, slot: int, cmds):
        return OmP2a(self.ballot, slot, _wire_cmds(cmds),
                     execute=self.execute)

    def _make_p2b(self, slot: int):
        return SwP2b(self.ballot, slot, str(self.id),
                     execute=self.execute)

    def handle_p2a(self, m: OmP2a) -> None:
        seq = getattr(m, "seq", -1)
        if seq >= 0:
            if m.sess == self.sess and seq > self.expect:
                self._on_gap(m)
            self._note_stamp(m.sess, seq, m.slot)
        super().handle_p2a(m)

    def handle_p3(self, m: OmP3) -> None:
        seq = getattr(m, "seq", -1)
        if seq >= 0:
            self._note_stamp(m.sess, seq, m.slot)
        super().handle_p3(m)

    def handle_gapreq(self, m: GapReq) -> None:
        """Leader half of gap agreement: retransmit the missing frame
        — a targeted stamped P3 when committed, a P2a re-broadcast
        (original stamp: the register remembers) when in flight."""
        if not self.is_leader():
            return
        slot = self.seq_slot.get(m.n)
        if slot is None:
            return   # recycled or never mine: retry/P3 will heal it
        e = self.log.get(slot)
        if e is None:
            return
        if e.commit:
            self.socket.send(ID(m.id), OmP3(
                self.ballot, slot, _wire_cmds(e.cmds), sess=self.sess,
                seq=self.slot_seq.get(slot, -1), execute=self.execute))
        else:
            self.socket.broadcast(OmP2a(
                e.ballot, slot, _wire_cmds(e.cmds),
                execute=self.execute))

    # ---- recovery through the switch ------------------------------------
    def handle_switch_snap(self, m: SwitchSnap) -> None:
        """The register read the P1a triggered: stash it as a
        pseudo-acker log (slot -> [vballot, frame, committed=False])
        and complete the election if the P1b quorum beat it here."""
        self._switch_snap = {
            int(s): [int(vbal), list(cmds) if cmds else [], False]
            for s, (vbal, cmds, _seq) in m.regs.items()}
        if not self.active and self._p1_complete():
            self._become_leader()

    def _become_leader(self) -> None:
        if self._sw_expected and self._switch_snap is None:
            return   # the register read is part of the recovery quorum
        if self._switch_snap is not None:
            self.p1b_logs[_SNAP_KEY] = self._switch_snap
            self.p1b_meta[_SNAP_KEY] = (0, {}, {})
            self._switch_snap = None
        super()._become_leader()


def new_replica(id: ID, cfg: Config) -> SwitchPaxosReplica:
    return SwitchPaxosReplica(ID(id), cfg)


def HUNT_FABRIC_SETUP(fabric, scfg) -> None:
    """hunt/classify hook: interpose the switch tier on the replay
    fabric, mirroring the sim kernel's static ``sw_*`` knobs (the
    trace's ``sim_cfg`` meta carries them)."""
    from paxi_tpu_torch.scenarios.spec import SwitchChurn
    churn = None
    if scfg.sw_down_start >= 0 and scfg.sw_down_for > 0:
        churn = SwitchChurn(start=scfg.sw_down_start,
                            period=scfg.sw_down_period,
                            down_for=scfg.sw_down_for)
    fabric.install_switch(SwitchTier(window=scfg.sw_window, churn=churn,
                                     n_replicas=scfg.n_replicas))


def HUNT_ORACLE(cluster) -> int:
    """Safety-violation count after a replay: cross-replica
    disagreement on committed batches (the host analog of the sim
    kernel's agreement oracle — what the nogap twin's unilateral
    NOOP-commits diverge)."""
    bad = 0
    seen: Dict[int, list] = {}
    for i in cluster.ids:
        r = cluster[i]
        for s, e in r.log.items():
            if not e.commit:
                continue
            ident = [(c.client_id, c.command_id) for c in e.cmds]
            if s in seen:
                if seen[s] != ident:
                    bad += 1
            else:
                seen[s] = ident
    return bad


# gap agreement converges a few commits after the replayed schedule
# (detect -> GapReq -> retransmit -> P3), like bpaxos's gap strikes
HUNT_TAIL_STEPS = 30


# sim mailbox name -> host message class (trace/host.py projection).
# The in-network votes/snaps are NOT mailbox planes in the sim (they
# ride the scan carry), so the fabric replay regenerates them through
# the tier itself — nothing to map.
TRACE_MSG_MAP = {
    "p1a": "SwP1a", "p1b": "SwP1b", "p2a": "OmP2a", "p2b": "SwP2b",
    "p3": "OmP3", "gapreq": "GapReq",
}

# sim state field -> host attribute (analysis/parity.py PXS7xx).
# Empty string = kernel-internal or fabric-tier state with no replica
# analog (the switch planes live in switchnet.SwitchTier on the host).
SIM_STATE_MAP = {
    "p1_acks":    "p1_quorum",
    "log_bal":    "log",
    "log_cmd":    "log",
    "log_commit": "log",
    "log_acks":   "log",
    "next_slot":  "slot",
    "kv":         "db",
    "base":       "",   # ring-window base: the host log is a dict
    "proposed":   "",   # implied by Entry existence
    "timer":      "",   # host elections are wall-clock
    "stuck":      "",   # go-back-N retry counter (kernel-only)
    # (the switch register file — sw_bal/sw_base/sw_vbal/sw_vcmd/
    # sw_reg_seq/sw_seq — is built by switchnet.plane.init_planes and
    # lives in switchnet.SwitchTier on the host, not in any replica;
    # the parity field scanner only sees literal init_state keys, so
    # those planes carry no map entries here)
    # sequencer bookkeeping
    "seq_ring":   "seq_slot",   # my frames' stamps (leader side)
    "slot_seq":   "slot_seq",   # received stamps per slot
    "expect":     "expect",
    "r_sess":     "sess",
    # on-device observability
    "m_prop_t":      "",
    "m_commit_dt":   "",
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
    "m_fast_commits": "fast_commits",
    "m_gap_events":   "gap_events",
    "m_sw_overflow":  "",
}
