"""WPaxos, the plain reference: multi-leader WAN Paxos with object
stealing on a zone grid (the semantics of the port's lane-major kernel,
``protocols/wpaxos/sim.py``), written with loops over the object and
sender axes where the port gathers or sums one-hot selections, and with a
gather where it sums a one-hot slot of a ring; each such place says so.

Every object is a separate Paxos instance whose ballot embeds its owner
(``ballot % ballot_stride``); object ``o`` starts owned by replica
``o % R``.  A replica steals an object by running phase 1 on a higher
ballot of it once it has demanded that object, unowned, in
``steal_threshold`` consecutive rounds.  Quorums are flexible grids over
``Z`` zones of ``R / Z`` replicas (replica ``r`` in zone ``r // (R / Z)``):
a zone counts when a majority of its replicas acked, phase 1 needs
``Z - grid_q2 + 1`` such zones and phase 2 ``grid_q2``, so with
``grid_q2 = 1`` a commit needs the owner's zone alone.

Layout, as in the port: state ``(R, O, G)`` / ``(R, O, S, G)`` with the
group axis last, mailbox planes ``(src, dst, G)``; each (replica, object)
log is a fixed-cell ring of S slots (``cell.py``: absolute slot ``a`` at
cell ``a % S``) whose window slides with its execute frontier; ack sets
are int32 masks, one bit a replica.  A round, every replica in turn:

1. P1a: promise the highest ballot offered for each object above its own
   (which deposes it, and ends its own steal of that object), and reply
   P1b to the sender of the highest such ballot.
2. P1b: a stealer collects acks; on a phase-1 grid quorum it owns the
   object, merging the ackers' logs on the common window (the highest
   ballot's command per cell, a committed command over it; holes become
   no-ops) and taking the most advanced acker's frontier and register.
3. P2a: accept the highest ballot's proposal for each object at least as
   high as its promise, in-window and over no commit; ack it with P2b.
4. P2b: an owner commits each proposed slot whose acks make a phase-2
   grid quorum; the commit is zone-local when its own zone's acks alone
   make it, else cross-zone, and its propose-to-commit rounds are binned.
5. P3: learn commits (and everything below the owner's frontier written
   at the same ballot); a replica whose frontier fell below the owner's
   window base (``lowslot``) adopts the owner's row (snapshot catch-up).
6. Demand: each replica demands one object, its home object
   (``r * max(O // R, 1)`` plus a draw below that, mod O) with
   probability ``locality``, else any object.  An owner proposes for its
   demanded object (a hole of its window first, else the next slot while
   the window has room) and sends P3 for its lowest new commit of it.
7. Stealing: consecutive misses count per object; at ``steal_threshold``
   an idle replica fires phase 1 on a ballot above every ballot it holds;
   a steal that has not won after ``election_timeout`` plus a jittered
   backoff is given up (and fires again later).
8. Execute up to ``exec_window`` committed slots in order into the
   object's register, slide the window, and run the in-round spot-check.

Every draw goes through ``prng.LaneKey`` at the batch's shapes, so a
sampled group draws what it draws inside the batch.  The port's workload
model (``cfg.workload``: spec-drawn keys, a flash-crowd gate, per-class
histograms) is left out: this module raises if a geometry carries one.
WPaxos bins commit latencies in the step, so its state has no pending
``m_commit_dt`` plane and the round loop's deferred flush skips it.

The quorum sizes are read through the geometry (``GridGeometry``), so
``control_geometry`` can cut every quorum to one replica in one zone.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from simbench.reference import cell
from simbench.reference import common as inscan
from simbench.reference import common as lathist
from simbench.reference import prng as tr
from simbench.reference.ballot_ring import argmax_i32, popcount
from simbench.reference.common import Geometry, StepCtx, group_sum
from simbench.reference.ring import dst_major, require_packable

NO_CMD = -1
NOOP = -2
BIG = 2 ** 30
I32 = torch.int32


@dataclass(frozen=True)
class GridGeometry(Geometry):
    """A geometry with WPaxos's grid quorums as the paper states them."""

    @property
    def zone_majority(self) -> int:
        """Acks that make a zone count: a majority of its replicas."""
        return (self.n_replicas // self.n_zones) // 2 + 1

    @property
    def phase1_zones(self) -> int:
        return self.n_zones - self.grid_q2 + 1

    @property
    def phase2_zones(self) -> int:
        return self.grid_q2


@dataclass(frozen=True)
class OneReplicaOneZone(GridGeometry):
    """The control's geometry: every quorum, phase 1 and phase 2 alike, is
    one replica in one zone, which breaks the grid's intersection (the
    zones keep their replicas)."""

    @property
    def zone_majority(self) -> int:
        return 1

    @property
    def phase1_zones(self) -> int:
        return 1

    @property
    def phase2_zones(self) -> int:
        return 1


def _fields(geo: Geometry) -> dict:
    return {f.name: getattr(geo, f.name)
            for f in dataclasses.fields(Geometry)}


def grid(geo: Geometry) -> GridGeometry:
    """``geo`` with its grid quorums: a plain geometry gets the paper's."""
    return geo if isinstance(geo, GridGeometry) else GridGeometry(
        **_fields(geo))


def control_geometry(geo: Geometry) -> GridGeometry:
    """The check's control: the configuration's geometry with every quorum
    cut to one replica in one zone (``check.QuorumOfOne`` changes only
    ``majority`` and ``fast_size``, which no grid quorum reads)."""
    return OneReplicaOneZone(**_fields(geo))


def _no_workload(cfg: Geometry) -> None:
    if cfg.workload is not None:
        raise ValueError("the WPaxos reference runs no workload model; a "
                         "configuration with a workload needs a reference "
                         "that models it")


def mailbox_spec(cfg: Geometry) -> Dict[str, Tuple[str, ...]]:
    return {
        "p1a": ("obj", "bal"),
        "p1b": ("obj", "bal"),
        "p2a": ("obj", "bal", "slot", "cmd"),
        "p2b": ("obj", "bal", "slot"),
        "p3": ("obj", "bal", "slot", "cmd", "upto", "lowslot"),
    }


def encode_cmd(bal, slot):
    """The command id of (ballot, absolute slot): the register's value."""
    return ((bal & 0x7FFF) << 16) | (slot & 0xFFFF)


def _sum(x, dim):
    return torch.sum(x, dim=dim, dtype=I32)


def _bits(x: torch.Tensor, n: int) -> torch.Tensor:
    """int32 masks ``(M, G)`` -> their low ``n`` bits as bools
    ``(M, n, G)``."""
    sh = torch.arange(n, dtype=I32, device=x.device)[None, :, None]
    return ((x[:, None, :] >> sh) & 1).to(torch.bool)


def zone_quorums(acks: torch.Tensor, cfg: GridGeometry) -> torch.Tensor:
    """The zones in which ``acks`` (int32 masks, one bit a replica) hold a
    zone majority."""
    R, Z = cfg.n_replicas, cfg.n_zones
    npz = R // Z
    n = torch.zeros_like(acks)
    for z in range(Z):
        per = popcount(acks & (((1 << npz) - 1) << (z * npz)), R)
        n = n + (per >= cfg.zone_majority).to(I32)
    return n


def _at(plane: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """``plane (R, O, ..., G)`` at each replica's object ``obj (R, G)``:
    ``(R, ..., G)``.  A loop over the objects (the port sums a one-hot
    selection, which holds the same value for an object in range; every
    caller's is)."""
    R, O = plane.shape[:2]
    lead = obj.reshape((R,) + (1,) * (plane.ndim - 3) + (obj.shape[-1],))
    out = torch.zeros_like(plane[:, 0])
    for o in range(O):
        out = torch.where(lead == o, plane[:, o], out)
    return out


def _rows_at(plane: torch.Tensor, obj: torch.Tensor) -> torch.Tensor:
    """Every replica's row of ``plane (R, O, ..., G)`` at the object that
    replica ``me`` names, ``obj (me, G)``: ``(me, R, ..., G)`` (the port's
    ``_sel_obj`` gathers; here a loop over the objects)."""
    M, O = obj.shape[0], plane.shape[1]
    lead = obj.reshape((M, 1) + (1,) * (plane.ndim - 3) + (obj.shape[-1],))
    out = torch.zeros((M,) + plane[:, 0].shape, dtype=plane.dtype,
                      device=plane.device)
    for o in range(O):
        out = torch.where(lead == o, plane[:, o].unsqueeze(0), out)
    return out


def _first(hits, values, fill):
    """Over the senders, the value of the first whose hit holds, else
    ``fill``: an overwrite from the last sender down, as the port's."""
    out = torch.full_like(values[0], fill)
    for hit, v in zip(reversed(hits), reversed(values)):
        out = torch.where(hit, v, out)
    return out


def _best(m, O: int, fields=()):
    """Per receiver and object, the highest-ballot message among the
    senders, the lowest sender on a tie: ``(has, bal, src, [field...])``,
    each ``(me, O, G)``; ``src`` and the fields are 0 where no message
    with a positive ballot came.  A running maximum over the senders (the
    port takes the maximum over a one-hot cube, then the first sender
    holding it)."""
    v, ob, bl = (dst_major(m[k]) for k in ("valid", "obj", "bal"))
    R, G = v.shape[1], v.shape[2]
    oidx = torch.arange(O, dtype=I32, device=v.device)[None, :, None]
    best = torch.full((v.shape[0], O, G), -1, dtype=I32, device=v.device)
    src = torch.zeros_like(best)
    picks = [torch.zeros_like(best) for _ in fields]
    for s in range(R):
        cand = torch.where(v[:, s, None] & (ob[:, s, None] == oidx),
                           bl[:, s, None], -1)
        better = cand > best
        best = torch.where(better, cand, best)
        src = torch.where(better, s, src)
        for i, f in enumerate(fields):
            picks[i] = torch.where(better, dst_major(m[f])[:, s, None],
                                   picks[i])
    has = best > 0
    return (has, best, torch.where(has, src, 0),
            [torch.where(has, p, 0) for p in picks])


def init_state(cfg: Geometry, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device``; ``rng`` is unused."""
    del rng
    _no_workload(cfg)
    R, O, S, G = cfg.n_replicas, cfg.n_objects, cfg.n_slots, n_groups
    require_packable(R)
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)
    owner0 = torch.arange(O, **i32) % R
    ridx = torch.arange(R, **i32)

    def per_obj(x):
        return x[..., None].expand(R, O, G).contiguous()

    return dict(
        # ballot round 1 of each object's first owner, known to everyone
        ballot=per_obj((cfg.ballot_stride + owner0)[None, :].expand(R, O)),
        active=per_obj(ridx[:, None] == owner0[None, :]),
        log_bal=torch.zeros((R, O, S, G), **i32),
        log_cmd=torch.full((R, O, S, G), NO_CMD, **i32),
        log_commit=torch.zeros((R, O, S, G), **b),
        log_acks=torch.zeros((R, O, S, G), **i32),
        proposed=torch.zeros((R, O, S, G), **b),
        base=torch.zeros((R, O, G), **i32),       # absolute slot of cell 0
        next_slot=torch.zeros((R, O, G), **i32),
        execute=torch.zeros((R, O, G), **i32),    # executed prefix
        kv=torch.zeros((R, O, G), **i32),         # the object's register
        hits=torch.zeros((R, O, G), **i32),       # consecutive misses
        steal_obj=torch.full((R, G), -1, **i32),  # the steal in flight
        p1_acks=torch.zeros((R, G), **i32),
        steal_timer=torch.zeros((R, G), **i32),
        steals=torch.zeros((G,), **i32),
        # measurement planes, never read by the protocol
        m_prop_t=torch.zeros((R, O, S, G), **i32),
        m_lat_local_sum=torch.zeros((G,), **i32),
        m_lat_local_n=torch.zeros((G,), **i32),
        m_lat_cross_sum=torch.zeros((G,), **i32),
        m_lat_cross_n=torch.zeros((G,), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = grid(ctx.cfg)
    _no_workload(cfg)
    R, O, S, Z = cfg.n_replicas, cfg.n_objects, cfg.n_slots, cfg.n_zones
    STRIDE, ZR, RETAIN = cfg.ballot_stride, R // Z, max(S // 2, 1)
    t = ctx.t
    dev = state["ballot"].device
    ridx = torch.arange(R, dtype=I32, device=dev)
    oidx = torch.arange(O, dtype=I32, device=dev)
    sidx = torch.arange(S, dtype=I32, device=dev)
    self_bit = (1 << ridx)[:, None]                    # (R, 1)

    ballot, active = state["ballot"], state["active"]
    log_bal, log_cmd = state["log_bal"], state["log_cmd"]
    log_commit, log_acks = state["log_commit"], state["log_acks"]
    proposed, base = state["proposed"], state["base"]
    next_slot, execute, kv = (state["next_slot"], state["execute"],
                              state["kv"])
    steal_obj, p1_acks = state["steal_obj"], state["p1_acks"]
    m_prop_t = state["m_prop_t"]
    G = steal_obj.shape[-1]
    RRG = (R, R, G)

    def bcast(x):
        """(me, G) -> (src=me, dst, G): the same value to every receiver."""
        return x[:, None, :].expand(RRG)

    def end_steal(steal_obj, deposed):
        """A replica deposed from an object ends its own steal of it."""
        mine = steal_obj[:, None, :] == oidx[None, :, None]
        return torch.where(torch.any(deposed & mine, dim=1), -1, steal_obj)

    def at_cell(row, slot):
        """``row (R, S, G)`` at the cell of absolute ``slot (R, G)`` (the
        port sums the row's one-hot cell)."""
        return torch.gather(row, 1, torch.remainder(slot, S).to(
            torch.int64)[:, None, :])[:, 0]

    # ---- 1. P1a: promise higher ballots, reply to the best stealer ----
    has1, b1, src1, _ = _best(inbox["p1a"], O)
    promote = has1 & (b1 > ballot)
    ballot = torch.where(promote, b1, ballot)
    active = active & ~promote
    steal_obj = end_steal(steal_obj, promote)
    best_o = argmax_i32(torch.where(promote, b1, -1), 1)
    out_p1b = {
        "valid": (torch.any(promote, dim=1)[:, None, :]
                  & (ridx[None, :, None] == _at(src1, best_o)[:, None, :])),
        "obj": bcast(best_o),
        "bal": bcast(_at(ballot, best_o)),
    }

    # ---- 2. P1b: tally the steal's acks on the grid ----
    m = inbox["p1b"]
    v, ob, bl = (dst_major(m[k]) for k in ("valid", "obj", "bal"))
    so = torch.clamp(steal_obj, 0, O - 1)
    ack = (v & (ob == steal_obj[:, None, :])
           & (bl == _at(ballot, so)[:, None, :])
           & (steal_obj >= 0)[:, None, :])
    for s in range(R):
        p1_acks = p1_acks | (ack[:, s].to(I32) << s)
    p1_win = (steal_obj >= 0) & (zone_quorums(p1_acks, cfg)
                                 >= cfg.phase1_zones)

    # the winner reads every acker's row of the object (their state, as
    # the port's lock-step simulation does) and merges it cell by cell
    amask = _bits(p1_acks, R)                          # (me, src, G)
    b_src = _rows_at(base, so)                         # (me, src, G)
    base_star = torch.maximum(_at(base, so),
                              torch.amax(torch.where(amask, b_src, 0), 1))
    A_star = cell.cell_abs(base_star, S)               # (me, S, G)
    lb = _rows_at(log_bal, so)                         # (me, src, S, G)
    lc = _rows_at(log_cmd, so)
    sel = (amask[:, :, None, :] & (A_star[:, None] >= b_src[:, :, None, :])
           & (A_star[:, None] < b_src[:, :, None, :] + S))
    lbm = torch.where(sel, lb, -1)
    best_bal = torch.amax(lbm, dim=1)                  # (me, S, G)
    cmask = sel & _rows_at(log_commit, so)
    merged_commit = torch.any(cmask, dim=1)
    merged_cmd = _first([lbm[:, s] == best_bal for s in range(R)],
                        lc.unbind(1), NO_CMD)
    committed_cmd = _first(cmask.unbind(1), lc.unbind(1), NO_CMD)
    top = torch.amax(torch.where((best_bal > 0) | merged_commit,
                                 A_star + 1, 0), dim=1)
    new_next = torch.maximum(_at(next_slot, so), top)
    in_win = A_star < new_next[:, None, :]
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    win_oh = p1_win[:, None, :] & (oidx[None, :, None] == so[:, None, :])
    # the stolen object's window moves up to base_star: recycled cells
    # are cleared in place
    nb = torch.where(win_oh, base_star[:, None, :], base)
    drop = cell.cell_abs(base, S) < nb[:, :, None, :]
    log_bal = torch.where(drop, 0, log_bal)
    log_cmd = torch.where(drop, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop
    proposed = proposed & ~drop
    log_acks = torch.where(drop, 0, log_acks)
    m_prop_t = torch.where(drop, 0, m_prop_t)
    w4 = win_oh[:, :, None, :]
    iw4 = in_win[:, None, :, :]
    log_cmd = torch.where(w4 & iw4, adopt_cmd[:, None], log_cmd)
    log_bal = torch.where(w4 & iw4, _at(ballot, so)[:, None, None, :],
                          log_bal)
    log_commit = torch.where(w4 & iw4, merged_commit[:, None] | log_commit,
                             log_commit)
    proposed = torch.where(w4, iw4 & (merged_commit[:, None] | log_commit),
                           proposed)
    log_acks = torch.where(w4, torch.where(iw4, self_bit[:, :, None, None],
                                           0), log_acks)
    # adopted cells restart their latency clocks at the takeover
    m_prop_t = torch.where(w4, iw4.to(I32) * t, m_prop_t)
    base = nb
    next_slot = torch.where(win_oh, new_next[:, None, :], next_slot)
    # the frontier and register of the most advanced acker, when ahead
    e_am = torch.where(amask, _rows_at(execute, so), -1)
    f_exec = torch.amax(e_am, dim=1)
    f_kv = _first([e_am[:, s] == f_exec for s in range(R)],
                  _rows_at(kv, so).unbind(1), 0)
    adv = win_oh & (p1_win & (f_exec > _at(execute, so)))[:, None, :]
    execute = torch.where(adv, f_exec[:, None, :], execute)
    kv = torch.where(adv, f_kv[:, None, :], kv)
    active = active | win_oh
    steals = state["steals"] + _sum(p1_win, 0)
    steal_obj = torch.where(p1_win, -1, steal_obj)
    p1_acks = torch.where(p1_win, 0, p1_acks)

    # ---- 3. P2a: accept from the highest-ballot proposer ----
    has2, b2, src2, (slot2, cmd2) = _best(inbox["p2a"], O, ("slot", "cmd"))
    acc_ok = has2 & (b2 >= ballot)
    demote = acc_ok & (b2 > ballot)
    ballot = torch.where(acc_ok, b2, ballot)
    active = active & ~demote
    steal_obj = end_steal(steal_obj, demote)
    acc_in = acc_ok & cell.in_window(slot2, base, S)
    oh = acc_in[:, :, None, :] & (sidx[None, None, :, None] == torch.remainder(
        slot2, S)[:, :, None, :])
    writable = oh & (log_bal <= b2[:, :, None, :]) & ~log_commit
    log_bal = torch.where(writable, b2[:, :, None, :], log_bal)
    log_cmd = torch.where(writable, cmd2[:, :, None, :], log_cmd)
    # one P2b a P2a edge, for a proposal stored in-window and from the
    # proposer whose message was taken
    m = inbox["p2a"]
    ob2 = torch.clamp(dst_major(m["obj"]), 0, O - 1)
    edge = [dst_major(m["valid"])[:, s] & _at(acc_in, ob2[:, s])
            & (_at(src2, ob2[:, s]) == s) for s in range(R)]
    out_p2b = {"valid": torch.stack(edge, dim=1),
               **{k: dst_major(m[k]) for k in ("obj", "bal", "slot")}}

    # the objects each replica owns, as of the ballots accepted so far
    own = torch.remainder(ballot, STRIDE) == ridx[:, None, None]

    # ---- 4. P2b: the owner tallies grid acks and commits ----
    m = inbox["p2b"]
    v = dst_major(m["valid"])
    ob = torch.clamp(dst_major(m["obj"]), 0, O - 1)
    bl, sl = dst_major(m["bal"]), dst_major(m["slot"])
    owned = active & own
    for s in range(R):
        ok = (v[:, s] & (bl[:, s] == _at(ballot, ob[:, s]))
              & _at(owned, ob[:, s]))
        hit = (ok[:, None, None, :]
               & (ob[:, s][:, None, None, :] == oidx[None, :, None, None])
               & cell.in_window(sl[:, s][:, None, :], base, S)[:, :, None, :]
               & (torch.remainder(sl[:, s], S)[:, None, None, :]
                  == sidx[None, None, :, None]))
        log_acks = log_acks | (hit.to(I32) << s)
    newly = (owned[:, :, None, :]
             & (zone_quorums(log_acks, cfg) >= cfg.phase2_zones)
             & ~log_commit & (log_cmd != NO_CMD) & proposed)
    log_commit = log_commit | newly
    # zone-local: the owner's own zone's acks alone make the quorum
    home = ((1 << ZR) - 1) << ((ridx // ZR) * ZR)
    local_q = zone_quorums(log_acks & home[:, None, None, None],
                           cfg) >= cfg.phase2_zones
    local, cross = newly & local_q, newly & ~local_q
    dt = torch.clamp(t - m_prop_t, min=0)
    dims = (0, 1, 2)
    m_lat_local_sum = state["m_lat_local_sum"] + _sum(
        torch.where(local, dt, 0), dims)
    m_lat_local_n = state["m_lat_local_n"] + _sum(local, dims)
    m_lat_cross_sum = state["m_lat_cross_sum"] + _sum(
        torch.where(cross, dt, 0), dims)
    m_lat_cross_n = state["m_lat_cross_n"] + _sum(cross, dims)
    m_lat_hist = lathist.hist_update(state["m_lat_hist"], dt, newly)
    m_lat_sum = state["m_lat_sum"] + _sum(torch.where(newly, dt, 0), dims)

    # ---- 5. P3: learn commits; snapshot catch-up ----
    has3, b3, src3, (slot3, cmd3, upto3, low3) = _best(
        inbox["p3"], O, ("slot", "cmd", "upto", "lowslot"))
    fresh3 = has3 & (b3 >= ballot)
    promote3 = has3 & (b3 > ballot)
    ballot = torch.where(promote3, b3, ballot)
    active = active & ~promote3
    steal_obj = end_steal(steal_obj, promote3)
    oh = ((has3 & cell.in_window(slot3, base, S))[:, :, None, :]
          & (sidx[None, None, :, None]
             == torch.remainder(slot3, S)[:, :, None, :]))
    log_cmd = torch.where(oh, cmd3[:, :, None, :], log_cmd)
    log_bal = torch.where(oh, torch.maximum(log_bal, b3[:, :, None, :]),
                          log_bal)
    log_commit = log_commit | oh
    log_commit = log_commit | (
        fresh3[:, :, None, :]
        & (cell.cell_abs(base, S) < upto3[:, :, None, :])
        & (log_bal == b3[:, :, None, :]) & (log_cmd != NO_CMD))
    # below the owner's window base: take the owner's row (as it stands
    # this round), keeping my commits still inside the owner's window
    adopt = has3 & (execute < low3) & (src3 != ridx[:, None, None])

    def owners(plane):
        """``plane (R, O, ...)`` at each (me, object)'s P3 sender:
        ``(me, O, ...)`` (the port runs a masked loop over the senders)."""
        idx = src3.to(torch.int64).reshape(
            src3.shape[:2] + (1,) * (plane.ndim - 3) + src3.shape[-1:])
        return torch.gather(plane, 0, idx.expand((R,) + plane.shape[1:]))

    s_cmd, s_bal, s_com = owners(log_cmd), owners(log_bal), \
        owners(log_commit)
    b_own, e_own, k_own = owners(base), owners(execute), owners(kv)
    keep = cell.cell_abs(base, S) >= b_own[:, :, None, :]
    a4 = adopt[:, :, None, :]
    log_bal = torch.where(a4, torch.where(
        s_com, s_bal, torch.where(keep, log_bal, 0)), log_bal)
    log_cmd = torch.where(a4, torch.where(
        s_com, s_cmd, torch.where(keep, log_cmd, NO_CMD)), log_cmd)
    log_commit = torch.where(a4, s_com | (keep & log_commit), log_commit)
    proposed = proposed & ~a4
    log_acks = torch.where(a4, 0, log_acks)
    m_prop_t = torch.where(a4, 0, m_prop_t)
    base = torch.where(adopt, b_own, base)
    execute = torch.where(adopt, e_own, execute)
    kv = torch.where(adopt, k_own, kv)
    next_slot = torch.where(adopt, torch.maximum(next_slot, e_own),
                            next_slot)

    # ---- 6. demand, and the owner's proposal ----
    k_d, k_loc, k_jit = tr.split(ctx.rng, 3)
    blk = max(O // R, 1)
    home_obj = torch.remainder(ridx[:, None] * blk
                               + tr.randint(k_d, (R, G), 0, blk), O)
    anywhere = tr.randint(tr.fold_in(k_d, 1), (R, G), 0, O)
    d = torch.where(tr.bernoulli(k_loc, cfg.locality, (R, G)), home_obj,
                    anywhere)
    d_oh = oidx[None, :, None] == d[:, None, :]
    d_bal, d_next, d_base = _at(ballot, d), _at(next_slot, d), _at(base, d)
    A_d = cell.cell_abs(d_base, S)                     # (R, S, G)
    hole = (~_at(log_commit, d) & ~_at(proposed, d)
            & (A_d < d_next[:, None, :]))
    has_re = torch.any(hole, dim=1)
    can_new = d_next - d_base < S                      # window flow control
    prop_slot = torch.where(
        has_re, torch.amin(torch.where(hole, A_d, BIG), dim=1), d_next)
    re_cmd = at_cell(_at(log_cmd, d), prop_slot)
    prop_cmd = torch.where(has_re,
                           torch.where(re_cmd == NO_CMD, NOOP, re_cmd),
                           encode_cmd(d_bal, prop_slot))
    do = _at(active & own, d) & (has_re | can_new)
    p_oh = (do[:, None, None, :] & d_oh[:, :, None, :]
            & (sidx[None, None, :, None]
               == torch.remainder(prop_slot, S)[:, None, None, :]))
    log_bal = torch.where(p_oh, d_bal[:, None, None, :], log_bal)
    log_cmd = torch.where(p_oh & ~log_commit, prop_cmd[:, None, None, :],
                          log_cmd)
    # a slot's first proposal starts its latency clock
    m_prop_t = torch.where(p_oh & ~proposed, t, m_prop_t)
    proposed = proposed | p_oh
    log_acks = log_acks | torch.where(p_oh, self_bit[:, :, None, None], 0)
    next_slot = next_slot + ((do & ~has_re & can_new)[:, None, :]
                             & d_oh).to(I32)
    out_p2a = {"valid": bcast(do), "obj": bcast(d), "bal": bcast(d_bal),
               "slot": bcast(prop_slot), "cmd": bcast(prop_cmd)}

    # ---- 7. stealing: count consecutive misses, fire phase 1 ----
    hits = torch.where(d_oh & ~(active & own), state["hits"] + 1, 0)
    hot_obj = argmax_i32(hits, 1)
    fire = (steal_obj < 0) & (torch.amax(hits, dim=1)
                              >= cfg.steal_threshold)
    new_bal = ((torch.amax(ballot, dim=1) // STRIDE + 1) * STRIDE
               + ridx[:, None])
    f_oh = fire[:, None, :] & (oidx[None, :, None] == hot_obj[:, None, :])
    ballot = torch.where(f_oh, new_bal[:, None, :], ballot)
    active = active & ~f_oh
    steal_obj = torch.where(fire, hot_obj, steal_obj)
    p1_acks = torch.where(fire, self_bit, p1_acks)
    hits = torch.where(f_oh, 0, hits)
    out_p1a = {"valid": bcast(fire), "obj": bcast(hot_obj),
               "bal": bcast(new_bal)}
    steal_timer = torch.where(steal_obj >= 0, state["steal_timer"] + 1, 0)
    timeout = steal_timer >= cfg.election_timeout + tr.randint(
        k_jit, (R, G), 0, cfg.backoff + 1)
    steal_obj = torch.where(timeout, -1, steal_obj)
    steal_timer = torch.where(timeout, 0, steal_timer)

    # ---- 8. execute the committed prefix into the register (a gather
    # of the next cell; the port sums its one-hot cell) ----
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(active)
    for e in range(cfg.exec_window):
        slot_e = execute + e
        held = slot_e < base + S                       # execute >= base
        idx = torch.remainder(slot_e, S).to(torch.int64)[:, :, None, :]
        com = held & torch.gather(log_commit, 2, idx)[:, :, 0]
        running = running & com
        cmd_e = torch.gather(log_cmd, 2, idx)[:, :, 0]
        kv = torch.where(running & (cmd_e >= 0), cmd_e, kv)
        advanced = advanced + running.to(I32)
    new_execute = execute + advanced

    # P3 out: each owner announces its lowest new commit of its demanded
    # object, else a committed slot of its window in turn
    new_d = _at(newly, d)
    my_exec_d = _at(new_execute, d)
    p3_slot = torch.where(
        torch.any(new_d, dim=1),
        torch.amin(torch.where(new_d, A_d, BIG), dim=1),
        d_base + torch.remainder(torch.full_like(d_base, t),
                                 torch.clamp(my_exec_d - d_base, min=1)))
    out_p3 = {
        "valid": bcast(_at(active & own, d)
                       & at_cell(_at(log_commit, d), p3_slot)),
        "obj": bcast(d), "bal": bcast(d_bal), "slot": bcast(p3_slot),
        "cmd": bcast(at_cell(_at(log_cmd, d), p3_slot)),
        "upto": bcast(my_exec_d), "lowslot": bcast(d_base),
    }

    # slide each window, keeping RETAIN slots below the frontier
    new_base = torch.maximum(base, new_execute - RETAIN)
    drop = cell.cell_abs(base, S) < new_base[:, :, None, :]
    log_bal = torch.where(drop, 0, log_bal)
    log_cmd = torch.where(drop, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop
    proposed = proposed & ~drop
    log_acks = torch.where(drop, 0, log_acks)
    m_prop_t = torch.where(drop, 0, m_prop_t)

    # the in-round spot-check over each (replica, object) ring
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], new_execute, state["base"], new_base,
        cell.cell_abs(state["base"], S), cell.cell_abs(new_base, S),
        state["log_cmd"], log_cmd, state["log_commit"], log_commit, kv=kv)

    new_state = dict(
        ballot=ballot, active=active, log_bal=log_bal, log_cmd=log_cmd,
        log_commit=log_commit, log_acks=log_acks, proposed=proposed,
        base=new_base, next_slot=next_slot, execute=new_execute, kv=kv,
        hits=hits, steal_obj=steal_obj, p1_acks=p1_acks,
        steal_timer=steal_timer, steals=steals, m_prop_t=m_prop_t,
        m_lat_local_sum=m_lat_local_sum, m_lat_local_n=m_lat_local_n,
        m_lat_cross_sum=m_lat_cross_sum, m_lat_cross_n=m_lat_cross_n,
        m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
        m_inscan_viol=m_inscan_viol)
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def _i32sum(x):
    return torch.sum(x, dtype=I32)


# the plane each command count reads: each object's most advanced replica
COMMAND_PLANES = {"committed_slots": "execute"}


def command_count(planes, command: str):
    """The command total ``command`` of ``metrics`` from its plane alone."""
    return _i32sum(torch.amax(planes[COMMAND_PLANES[command]], dim=0))


def metrics(state, cfg: Geometry):
    """The port's counters over the trailing group axis (int32 scalars)."""
    return {
        "committed_slots": command_count(state, "committed_slots"),
        "steals": _i32sum(state["steals"]),
        "owned_objects": _i32sum(state["active"]),
        "commit_lat_local_sum": _i32sum(state["m_lat_local_sum"]),
        "commit_lat_local_n": _i32sum(state["m_lat_local_n"]),
        "commit_lat_cross_sum": _i32sum(state["m_lat_cross_sum"]),
        "commit_lat_cross_n": _i32sum(state["m_lat_cross_n"]),
        "commit_lat_sum": _i32sum(state["m_lat_sum"]),
        "commit_lat_n": _i32sum(state["m_lat_hist"]),
        "inscan_violations": _i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: Geometry) -> torch.Tensor:
    """Each group's violations, ``(G,)`` int32, of: 1. agreement per
    absolute (object, slot) on the common window; 2. commit stability
    under the slide (and ``execute >= base``); 3. per-(replica, object)
    ballot monotonicity; 4. executed prefix committed; 5. single
    ownership: no two replicas active on one object at one ballot (a loop
    over the pairs; the port halves its count of ordered pairs)."""
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = cell.cell_abs(base, S)                         # (R, O, S, G)

    vis = c & (A >= torch.amax(base, dim=0)[None, :, None, :])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=0)
    v_agree = group_sum(torch.any(vis, dim=0) & (mx != mn))

    o_c = old["log_commit"] & (cell.cell_abs(old["base"], S)
                               >= base[:, :, None, :])
    v_stable = group_sum(o_c & (~c | (cmd != old["log_cmd"])))
    v_stable = v_stable + group_sum(new["execute"] < base)

    v_bal = group_sum(new["ballot"] < old["ballot"])

    v_exec = group_sum((A < new["execute"][:, :, None, :]) & ~c)

    v_own = torch.zeros_like(v_bal)
    R = cfg.n_replicas
    act, bal = new["active"], new["ballot"]
    for a in range(R):
        for b in range(a + 1, R):
            v_own = v_own + group_sum(act[a] & act[b] & (bal[a] == bal[b]))
    return v_agree + v_stable + v_bal + v_exec + v_own


def invariants(old, new, cfg: Geometry) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)
