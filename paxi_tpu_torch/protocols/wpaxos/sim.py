"""WPaxos — multi-leader WAN Paxos with object stealing, as a lane-major
sim kernel (torch twin of the JAX package's ``protocols/wpaxos/sim.py``).

Every key is a separate Paxos object whose ballot embeds its owner; a
replica steals an object by running phase-1 on that object's ballot when
its demand for it crosses ``steal_threshold``.  Quorums are flexible
grids: phase-1 needs zone-majorities in ``Z - q2 + 1`` zones, phase-2 in
``q2`` zones, so with ``q2 = 1`` steady-state commits stay in the owner's
zone.

Layout, as in the reference:
- State ``(R, O, G)`` / ``(R, O, S, G)`` with the group axis LAST, mailbox
  planes ``(src, dst, G)``; replica ``r`` sits in zone ``r // (R / Z)``.
- Per-object logs on a fixed-cell ring of S slots (``sim/cell.py``):
  absolute slot ``a`` lives at cell ``a % S``; each (replica, object)
  window slides with its execute frontier as a masked clear.
- Ack sets are bit-packed int32 masks; grid quorums are per-zone popcounts.
- The demand is drawn in the kernel from the step key: each replica
  demands one object a step, home-zone-biased by ``cfg.locality``.
- P3 carries the owner's window base (``lowslot``): a replica below it
  adopts the owner's object row (snapshot catch-up).
- Under a workload (``cfg.workload``) each replica demands the object of a
  spec-drawn key (``key % O``) on its own counter channel, the flash-crowd
  gate throttles new proposals, and commits bin into per-class latency
  histograms by their object's class.

Every reduction the
reference takes in int32 is taken with ``dtype=torch.int32`` here, its
one-hot ``einsum`` contractions over the object axis are gathers (exact,
and integer matmuls do not run on the card), and no input plane is
written in place.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.sim import cell, inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32, popcount
from paxi_tpu_torch.sim.lanes import group_sum
from paxi_tpu_torch.sim.ring import dst_major, require_packable
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)
from paxi_tpu_torch.workload import compile as wlc
from paxi_tpu_torch.workload.spec import CLASSES

NO_CMD = -1
NOOP = -2
I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        "p1a": ("obj", "bal"),
        "p1b": ("obj", "bal"),
        "p2a": ("obj", "bal", "slot", "cmd"),
        "p2b": ("obj", "bal", "slot"),
        "p3": ("obj", "bal", "slot", "cmd", "upto", "lowslot"),
    }


def encode_cmd(bal, slot):
    return ((bal & 0x7FFF) << 16) | (slot & 0xFFFF)


def _i32sum(x, dim=None):
    if dim is None:
        return torch.sum(x, dtype=I32)
    return torch.sum(x, dim=dim, dtype=I32)


def _zone_quorums(acks, cfg: SimConfig):
    """acks: (...) int32 bit-packed over replicas -> (...) count of zones
    holding a zone-majority of acks (the flexible-grid primitive)."""
    Z = cfg.n_zones
    npz = cfg.n_replicas // Z
    zmaj = npz // 2 + 1
    cnt = torch.zeros_like(acks)
    for z in range(Z):
        zmask = ((1 << npz) - 1) << (z * npz)
        per = popcount(acks & zmask, cfg.n_replicas)
        cnt = cnt + (per >= zmaj)
    return cnt


def _sel_obj(plane, obj):
    """``plane (R, O, ..., G)`` at each row's object ``obj (M, G)`` ->
    ``(M, R, ..., G)``: the reference's one-hot ``einsum`` over the object
    axis ("ro..g,mog->mr..g"), as a gather."""
    M, G = obj.shape
    rest = plane.shape[2:-1]
    idx = obj.to(torch.int64).reshape((M, 1, 1) + (1,) * len(rest) + (G,))
    idx = idx.expand((M, plane.shape[0], 1) + tuple(rest) + (G,))
    src = plane.unsqueeze(0).expand((M,) + tuple(plane.shape))
    return torch.gather(src, 2, idx).squeeze(2)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    del rng
    device = resolve_device(device)
    R, O, S, G = cfg.n_replicas, cfg.n_objects, cfg.n_slots, n_groups
    require_packable(R)
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)
    ridx = torch.arange(R, **i32)
    oidx = torch.arange(O, **i32)
    owner0 = oidx % R                      # initial round-robin ownership
    st = dict(
        # per-object ballots: round 1, owner0 (everyone agrees at init)
        ballot=(cfg.ballot_stride + owner0)[None, :, None]
        .expand(R, O, G).contiguous(),
        active=(ridx[:, None] == owner0[None, :])[..., None]
        .expand(R, O, G).contiguous(),
        log_bal=torch.zeros((R, O, S, G), **i32),
        log_cmd=torch.full((R, O, S, G), NO_CMD, **i32),
        log_commit=torch.zeros((R, O, S, G), **b),
        log_acks=torch.zeros((R, O, S, G), **i32),   # bit-packed over src
        proposed=torch.zeros((R, O, S, G), **b),
        base=torch.zeros((R, O, G), **i32),          # abs slot of cell 0
        next_slot=torch.zeros((R, O, G), **i32),     # absolute
        execute=torch.zeros((R, O, G), **i32),       # absolute frontier
        kv=torch.zeros((R, O, G), **i32),      # object register (last cmd)
        hits=torch.zeros((R, O, G), **i32),    # policy demand counters
        steal_obj=torch.full((R, G), -1, **i32),
        p1_acks=torch.zeros((R, G), **i32),    # bit-packed, in-flight steal
        steal_timer=torch.zeros((R, G), **i32),
        steals=torch.zeros((G,), **i32),       # completed steals (metric)
        # measurement planes (never read by protocol logic): each slot's
        # first propose step, the zone-local / cross-zone commit-latency
        # split, the latency histogram and the in-scan spot-check count
        m_prop_t=torch.zeros((R, O, S, G), **i32),
        m_lat_local_sum=torch.zeros((G,), **i32),
        m_lat_local_n=torch.zeros((G,), **i32),
        m_lat_cross_sum=torch.zeros((G,), **i32),
        m_lat_cross_n=torch.zeros((G,), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )
    if cfg.workload is not None:
        # global group ids for the workload's demand draws, and the
        # per-key-class latency planes (a commit's class is its object's)
        st["wl_gid"] = torch.arange(G, **i32)
        for nm in CLASSES:
            st[f"m_wl_hist_{nm}"] = lathist.empty_hist(G, device=device)
            st[f"m_wl_sum_{nm}"] = torch.zeros((G,), **i32)
    return st


def step(state, inbox, ctx: StepCtx, q1_full: bool = True):
    """``q1_full=False`` is the seeded bug twin (``PROTOCOL_THINQ1``): the
    steal's phase-1 grid quorum is one zone too thin (``Z - q2`` instead
    of ``Z - q2 + 1``), so a stealer's read set can miss the old owner's
    write zone and re-propose over chosen entries.  Never a correctness
    case."""
    cfg = ctx.cfg
    R, O, S = cfg.n_replicas, cfg.n_objects, cfg.n_slots
    Z, STRIDE = cfg.n_zones, cfg.ballot_stride
    Q1 = Z - cfg.grid_q2 + (1 if q1_full else 0)
    Q2 = cfg.grid_q2
    RETAIN = max(S // 2, 1)
    dev = state["ballot"].device
    ridx = torch.arange(R, dtype=I32, device=dev)
    oidx = torch.arange(O, dtype=I32, device=dev)
    sidx = torch.arange(S, dtype=I32, device=dev)
    self_bit2 = (torch.ones_like(ridx) << ridx)[:, None]  # (R, 1)

    ballot = state["ballot"]          # (R, O, G)
    active = state["active"]
    log_bal = state["log_bal"]        # (R, O, S, G)
    log_cmd = state["log_cmd"]
    log_commit = state["log_commit"]
    log_acks = state["log_acks"]      # (R, O, S, G) packed
    proposed = state["proposed"]
    base = state["base"]              # (R, O, G)
    next_slot = state["next_slot"]
    execute = state["execute"]
    kv = state["kv"]
    hits = state["hits"]
    steal_obj = state["steal_obj"]    # (R, G)
    p1_acks = state["p1_acks"]        # (R, G) packed
    steals = state["steals"]
    m_prop_t = state["m_prop_t"]      # (R, O, S, G) first-propose step
    m_lat_local_sum = state["m_lat_local_sum"]
    m_lat_local_n = state["m_lat_local_n"]
    m_lat_cross_sum = state["m_lat_cross_sum"]
    m_lat_cross_n = state["m_lat_cross_n"]
    G = steal_obj.shape[-1]
    RRG = (R, R, G)

    T = dst_major          # mailbox (src, dst, G) -> (me=dst, src, G)

    def at_obj(plane, obj):
        """plane (R, O, G) selected at obj (R, G) -> (R, G)."""
        oh = oidx[None, :, None] == obj[:, None, :]
        return _i32sum(torch.where(oh, plane, 0), 1)

    def row_at_obj(plane, obj):
        """plane (R, O, S, G) selected at obj (R, G) -> (R, S, G); a bool
        plane's selection stays bool (the reference sums a one-hot
        selection of it into 0/1, which every reader treats as such)."""
        oh = oidx[None, :, None, None] == obj[:, None, None, :]
        if plane.dtype == torch.bool:
            return torch.any(oh & plane, dim=1)
        return _i32sum(torch.where(oh, plane, 0), 1)

    def per_obj_best(m, extra=()):
        """Select, per (dst, obj), the max-ballot message among sources.

        Returns (has, bal, src_best, [extra...]) each (R, O, G)."""
        v = T(m["valid"])                              # (me, src, G)
        ob = T(m["obj"])
        bl = T(m["bal"])
        onehot = v[:, :, None, :] & (ob[:, :, None, :]
                                     == oidx[None, None, :, None])
        b4 = torch.where(onehot, bl[:, :, None, :], -1)  # (me, src, O, G)
        bal_best = torch.amax(b4, dim=1)               # (me, O, G)
        has = bal_best > 0
        # first (lowest-index) source achieving the max, unrolled
        src_best = torch.zeros((R, O, G), dtype=I32, device=dev)
        picks = [torch.zeros((R, O, G), dtype=I32, device=dev)
                 for _ in extra]
        for s in range(R - 1, -1, -1):
            hit = has & (b4[:, s] == bal_best)
            src_best = torch.where(hit, s, src_best)
            for i, f in enumerate(extra):
                picks[i] = torch.where(hit, T(m[f])[:, s][:, None, :],
                                       picks[i])
        return has, bal_best, src_best, picks

    # ---------------- P1a: promise to higher per-object ballots ---------
    m = inbox["p1a"]
    has1, b1, src1, _ = per_obj_best(m)
    promote = has1 & (b1 > ballot)                     # (me, O, G)
    ballot = torch.where(promote, b1, ballot)
    active = active & ~promote
    # a promoted object kills my own in-flight steal of it
    my_steal_oh = steal_obj[:, None, :] == oidx[None, :, None]
    steal_killed = torch.any(promote & my_steal_oh, dim=1)
    steal_obj = torch.where(steal_killed, -1, steal_obj)
    # P1b back to the (single) best stealer per promoted object: reply for
    # the highest-ballot promoted object (stealers retry via steal_timer)
    pb = torch.where(promote, b1, -1)
    best_o = argmax_i32(pb, 1)                         # (me, G)
    any_p = torch.any(promote, dim=1)
    to_src = at_obj(src1, best_o)
    out_p1b = {
        "valid": any_p[:, None, :] & (ridx[None, :, None]
                                      == to_src[:, None, :]),
        "obj": best_o[:, None, :].expand(RRG),
        "bal": at_obj(ballot, best_o)[:, None, :].expand(RRG),
    }

    # ---------------- P1b: stealer tallies grid-quorum acks -------------
    m = inbox["p1b"]
    v = T(m["valid"])                                  # (me, src, G)
    ob = T(m["obj"])
    bl = T(m["bal"])
    so = torch.clamp(steal_obj, 0, O - 1)
    my_bal = at_obj(ballot, so)                        # (me, G)
    ack = (v & (ob == steal_obj[:, None, :])
           & (bl == my_bal[:, None, :])
           & (steal_obj >= 0)[:, None, :])             # (me, src, G)
    p1_acks = p1_acks | _i32sum(
        torch.where(ack, (torch.ones_like(ridx) << ridx)[None, :, None], 0),
        1)
    zq = _zone_quorums(p1_acks, cfg)                   # (me, G)
    p1_win = (steal_obj >= 0) & (zq >= Q1)

    # ---------------- steal win: adopt object, merge ackers' logs -------
    # every replica's row for MY stolen object; fixed cell mapping: all
    # rows are cell-aligned, so the merge is an elementwise in-window mask
    so_oh = oidx[None, :, None] == so[:, None, :]      # (me, O, G)
    amask = ((p1_acks[:, None, :] >> ridx[None, :, None]) & 1
             ).to(torch.bool)                          # (me, src, G)
    lb = _sel_obj(log_bal, so)                         # (me, src, S, G)
    lc = _sel_obj(log_cmd, so)
    lk = _sel_obj(log_commit, so)
    b_src = _sel_obj(base, so)                         # (me, src, G)
    base_so = at_obj(base, so)                         # (me, G)
    base_star = torch.maximum(
        base_so, torch.amax(torch.where(amask, b_src, 0), dim=1))
    A_star = cell.cell_abs(base_star, S)               # (me, S, G) abs
    in_src = (A_star[:, None] >= b_src[:, :, None, :]) \
        & (A_star[:, None] < b_src[:, :, None, :] + S)  # (me, src, S, G)
    sel = amask[:, :, None, :] & in_src
    lbm = torch.where(sel, lb, -1)
    best_bal = torch.amax(lbm, dim=1)                  # (me, S, G)
    cmask = sel & lk
    merged_commit = torch.any(cmask, dim=1)
    merged_cmd = torch.full((R, S, G), NO_CMD, dtype=I32, device=dev)
    committed_cmd = torch.full((R, S, G), NO_CMD, dtype=I32, device=dev)
    for s in range(R - 1, -1, -1):
        merged_cmd = torch.where(lbm[:, s] == best_bal, lc[:, s],
                                 merged_cmd)
        committed_cmd = torch.where(cmask[:, s], lc[:, s], committed_cmd)
    has_acc = (best_bal > 0) | merged_commit
    top = torch.amax(torch.where(has_acc, A_star + 1, 0), dim=1)  # abs
    my_next = at_obj(next_slot, so)
    new_next = torch.maximum(my_next, top)
    in_win = A_star < new_next[:, None, :]             # (me, S, G)
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    win_oh = p1_win[:, None, :] & so_oh                # (me, O, G)
    # raise my stolen object's base to base_star: recycled cells reset in
    # place (the fixed mapping's no-copy move)
    nb_steal = torch.where(win_oh, base_star[:, None, :], base)
    drop4 = cell.cell_abs(base, S) < nb_steal[:, :, None, :]
    log_bal = torch.where(drop4, 0, log_bal)
    log_cmd = torch.where(drop4, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop4
    proposed = proposed & ~drop4
    log_acks = torch.where(drop4, 0, log_acks)
    m_prop_t = torch.where(drop4, 0, m_prop_t)
    w4 = win_oh[:, :, None, :]                         # (me, O, 1, G)
    iw4 = in_win[:, None, :, :]                        # (me, 1, S, G)
    my_bal_so = at_obj(ballot, so)                     # (me, G)
    log_cmd = torch.where(w4 & iw4, adopt_cmd[:, None], log_cmd)
    log_bal = torch.where(w4 & iw4, my_bal_so[:, None, None, :], log_bal)
    log_commit = torch.where(w4 & iw4, merged_commit[:, None] | log_commit,
                             log_commit)
    proposed = torch.where(w4, iw4 & (merged_commit[:, None] | log_commit),
                           proposed)
    log_acks = torch.where(
        w4, torch.where(iw4, self_bit2[:, :, None, None], 0), log_acks)
    # adopted rows restart their latency clocks at the takeover step
    m_prop_t = torch.where(w4, iw4.to(I32) * ctx.t, m_prop_t)
    base = nb_steal
    next_slot = torch.where(win_oh, new_next[:, None, :], next_slot)
    # adopt execute/register from the max-base acker when it is ahead
    e_src = _sel_obj(execute, so)
    k_src = _sel_obj(kv, so)
    e_am = torch.where(amask, e_src, -1)
    f_exec = torch.amax(e_am, dim=1)                   # (me, G)
    f_kv = torch.zeros((R, G), dtype=I32, device=dev)
    for s in range(R - 1, -1, -1):
        f_kv = torch.where(e_am[:, s] == f_exec, k_src[:, s], f_kv)
    my_exec_so = at_obj(execute, so)
    adv_ex = p1_win & (f_exec > my_exec_so)
    execute = torch.where(win_oh & adv_ex[:, None, :],
                          f_exec[:, None, :], execute)
    kv = torch.where(win_oh & adv_ex[:, None, :], f_kv[:, None, :], kv)
    active = active | win_oh
    steals = steals + _i32sum(p1_win, 0)
    steal_obj = torch.where(p1_win, -1, steal_obj)
    p1_acks = torch.where(p1_win, 0, p1_acks)

    # ---------------- P2a: accept from the highest-ballot owner ---------
    m = inbox["p2a"]
    has2, b2, src2, (slot2, cmd2) = per_obj_best(m, ("slot", "cmd"))
    acc_ok = has2 & (b2 >= ballot)                     # (me, O, G)
    demote = acc_ok & (b2 > ballot)
    ballot = torch.where(acc_ok, b2, ballot)
    active = active & ~demote
    sk = torch.any(demote & my_steal_oh, dim=1)
    steal_obj = torch.where(sk, -1, steal_obj)
    inw2 = cell.in_window(slot2, base, S)              # (me, O, G)
    oh = ((acc_ok & inw2)[:, :, None, :]
          & (sidx[None, None, :, None]
             == torch.remainder(slot2, S)[:, :, None, :]))
    writable = oh & (log_bal <= b2[:, :, None, :]) & ~log_commit
    log_bal = torch.where(writable, b2[:, :, None, :], log_bal)
    log_cmd = torch.where(writable, cmd2[:, :, None, :], log_cmd)
    # p2b back to the accepted object's owner, one per edge; ack ONLY what
    # we durably stored (in-window)
    v2 = T(m["valid"])                                 # (me, src, G)
    ob2 = torch.clamp(T(m["obj"]), 0, O - 1)
    acc_in = (acc_ok & inw2).to(I32)
    edge_ok = []
    for s in range(R):
        o_s = ob2[:, s]                                # (me, G)
        acc_s = at_obj(acc_in, o_s) > 0
        src_s = at_obj(src2, o_s)
        edge_ok.append(v2[:, s] & acc_s & (src_s == s))
    win_edge = torch.stack(edge_ok, dim=1)             # (me, src, G)
    out_p2b = {
        "valid": win_edge,
        "obj": T(m["obj"]),
        "bal": T(m["bal"]),
        "slot": T(m["slot"]),
    }

    own = torch.remainder(ballot, STRIDE) == ridx[:, None, None]

    # ---------------- P2b: owner tallies zone-grid acks, commits --------
    m = inbox["p2b"]
    v = T(m["valid"])                                  # (own, src, G)
    ob = torch.clamp(T(m["obj"]), 0, O - 1)
    bl = T(m["bal"])
    sl = T(m["slot"])
    owned = (active & own).to(I32)
    for s in range(R):
        ob_s, bl_s, sl_s = ob[:, s], bl[:, s], sl[:, s]
        ok_s = (v[:, s] & (bl_s == at_obj(ballot, ob_s))
                & (at_obj(owned, ob_s) > 0))
        inw_s = cell.in_window(sl_s[:, None, :], base, S)  # (own, O, G)
        oh_s = (ok_s[:, None, None, :]
                & (ob_s[:, None, None, :] == oidx[None, :, None, None])
                & inw_s[:, :, None, :]
                & (torch.remainder(sl_s, S)[:, None, None, :]
                   == sidx[None, None, :, None]))
        log_acks = log_acks | (oh_s.to(I32) << s)
    zq2 = _zone_quorums(log_acks, cfg)                 # (own, O, S, G)
    newly = ((active & own)[:, :, None, :] & (zq2 >= Q2)
             & ~log_commit & (log_cmd != NO_CMD) & proposed)
    log_commit = log_commit | newly
    # zone-latency split: a commit is ZONE-LOCAL when the owner's own
    # zone's acks alone satisfy the grid quorum
    ZR = R // Z
    zbits = torch.full_like(ridx, (1 << ZR) - 1) << (
        torch.div(ridx, ZR, rounding_mode="floor") * ZR)   # (own,)
    own_zq = _zone_quorums(log_acks & zbits[:, None, None, None], cfg)
    local = newly & (own_zq >= Q2)
    cross = newly & ~(own_zq >= Q2)
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_lat_local_sum = m_lat_local_sum + _i32sum(
        torch.where(local, dt, 0), (0, 1, 2))
    m_lat_local_n = m_lat_local_n + _i32sum(local, (0, 1, 2))
    m_lat_cross_sum = m_lat_cross_sum + _i32sum(
        torch.where(cross, dt, 0), (0, 1, 2))
    m_lat_cross_n = m_lat_cross_n + _i32sum(cross, (0, 1, 2))
    # every newly committed (owner, object, slot) bins its propose->commit
    # delta into the shared log2 histogram
    m_lat_hist = lathist.hist_update(state["m_lat_hist"], dt, newly)
    m_lat_sum = state["m_lat_sum"] + _i32sum(torch.where(newly, dt, 0),
                                             (0, 1, 2))
    # per-key-class latency: demand maps key -> object by key % O, so
    # the object's epoch-0 resident rank classes its commits
    wl = cfg.workload
    wl_planes = {}
    if wl is not None:
        cls = wlc.obj_class_plane(wl, cfg.n_keys, O, newly.device)
        wl_planes = wlc.class_hist_planes(state, cls[None, :, None, None],
                                          newly, dt)

    # ---------------- P3: commit notifications --------------------------
    # zombie fences: a higher-ballot P3 deposes the receiving owner, and
    # the frontier-commit fires only for bal >= my promised ballot
    m = inbox["p3"]
    has3, b3_, src3, (slot3, cmd3, upto3, low3) = per_obj_best(
        m, ("slot", "cmd", "upto", "lowslot"))
    fresh3 = has3 & (b3_ >= ballot)                    # (me, O, G)
    promote3 = has3 & (b3_ > ballot)
    ballot = torch.where(promote3, b3_, ballot)
    active = active & ~promote3
    sk3 = torch.any(promote3 & my_steal_oh, dim=1)
    steal_obj = torch.where(sk3, -1, steal_obj)
    inw3 = cell.in_window(slot3, base, S)
    oh = ((has3 & inw3)[:, :, None, :]
          & (sidx[None, None, :, None]
             == torch.remainder(slot3, S)[:, :, None, :]))
    log_cmd = torch.where(oh, cmd3[:, :, None, :], log_cmd)
    log_bal = torch.where(oh, torch.maximum(log_bal, b3_[:, :, None, :]),
                          log_bal)
    log_commit = log_commit | oh
    abs_ = cell.cell_abs(base, S)                      # (me, O, S, G)
    ohu = (fresh3[:, :, None, :] & (abs_ < upto3[:, :, None, :])
           & (log_bal == b3_[:, :, None, :]) & (log_cmd != NO_CMD))
    log_commit = log_commit | ohu

    # ---------------- P3: snapshot catch-up for deep laggards -----------
    # my frontier for this object fell below the owner's window base: adopt
    # the owner's object row (log, base, execute, register) by reference,
    # keeping my own still-in-window commits
    adopt = (has3 & (execute < low3)
             & ~(ridx[:, None, None] == src3))         # (me, O, G)
    s_cmd = torch.zeros_like(log_cmd)
    s_bal = torch.zeros_like(log_bal)
    s_com = torch.zeros_like(log_commit)
    b_own = torch.zeros_like(base)
    e_own = torch.zeros_like(execute)
    k_own = torch.zeros_like(kv)
    for s in range(R - 1, -1, -1):
        mp = adopt & (src3 == s)                       # (me, O, G)
        mp4 = mp[:, :, None, :]
        s_cmd = torch.where(mp4, log_cmd[s][None], s_cmd)
        s_bal = torch.where(mp4, log_bal[s][None], s_bal)
        s_com = torch.where(mp4, log_commit[s][None], s_com)
        b_own = torch.where(mp, base[s][None], b_own)
        e_own = torch.where(mp, execute[s][None], e_own)
        k_own = torch.where(mp, kv[s][None], k_own)
    # keep my cells still inside the owner's window; everything below was
    # recycled
    keep4 = cell.cell_abs(base, S) >= b_own[:, :, None, :]
    my_bal_s = torch.where(keep4, log_bal, 0)
    my_cmd_s = torch.where(keep4, log_cmd, NO_CMD)
    my_com_s = keep4 & log_commit
    a4 = adopt[:, :, None, :]
    log_bal = torch.where(a4, torch.where(s_com, s_bal, my_bal_s), log_bal)
    log_cmd = torch.where(a4, torch.where(s_com, s_cmd, my_cmd_s), log_cmd)
    log_commit = torch.where(a4, s_com | my_com_s, log_commit)
    proposed = proposed & ~a4
    log_acks = torch.where(a4, 0, log_acks)
    m_prop_t = torch.where(a4, 0, m_prop_t)
    base = torch.where(adopt, b_own, base)
    execute = torch.where(adopt, e_own, execute)
    kv = torch.where(adopt, k_own, kv)
    next_slot = torch.where(adopt, torch.maximum(next_slot, e_own),
                            next_slot)

    # ---------------- workload: demand one object per step --------------
    # locality-skewed demand: each replica mostly touches its own block of
    # "home" objects; k_jit is the steal backoff below.  The split stays
    # under a workload too, so the k_jit chain is the same with and
    # without one.
    k_d, k_loc, k_jit = tr.split(ctx.rng, 3)
    if wl is None:
        blk = max(O // R, 1)
        home = torch.remainder(ridx[:, None] * blk
                               + tr.randint(k_d, (R, G), 0, blk), O)
        anywhere = tr.randint(tr.fold_in(k_d, 1), (R, G), 0, O)
        local_d = tr.bernoulli(k_loc, cfg.locality, (R, G))
        d = torch.where(local_d, home, anywhere)
    else:
        # each replica demands the object of a spec-drawn key on its own
        # channel: a Zipf spec puts every zone's demand on the same hot
        # objects
        key_d = wlc.key_plane(wl, cfg.n_keys, state["wl_gid"][None, :],
                              ctx.t, chan=wlc.CH_DEMAND + ridx[:, None])
        d = torch.remainder(key_d, O)

    # ---------------- owner proposes for the demanded object ------------
    d_oh = oidx[None, :, None] == d[:, None, :]        # (R, O, G)
    is_owner_d = torch.any(d_oh & active & own, dim=1)  # (R, G)
    d_bal = at_obj(ballot, d)
    d_next = at_obj(next_slot, d)
    d_base = at_obj(base, d)
    c_at_d = row_at_obj(log_commit, d)                 # (R, S, G)
    p_at_d = row_at_obj(proposed, d)
    BIG = 2 ** 30
    A_d = cell.cell_abs(d_base, S)                     # (R, S, G) abs
    mask_re = ~c_at_d & ~p_at_d & (A_d < d_next[:, None, :])
    re_abs = torch.amin(torch.where(mask_re, A_d, BIG), dim=1)
    has_re = torch.any(mask_re, dim=1)
    can_new = d_next - d_base < S                      # window flow control
    if wl is not None:
        # flash-crowd gate on NEW proposals only (re-proposals are
        # recovery, never gated)
        gate = wlc.demand_gate(wl, state["wl_gid"][None, :], ctx.t)
        if gate is not None:
            can_new = can_new & gate
    prop_slot = torch.where(has_re, re_abs, d_next)    # absolute
    new_cmd = encode_cmd(d_bal, prop_slot)
    oh_pr = sidx[None, :, None] == torch.remainder(prop_slot, S)[:, None, :]
    re_cmd = _i32sum(torch.where(oh_pr, row_at_obj(log_cmd, d), 0), 1)
    re_cmd = torch.where(re_cmd == NO_CMD, NOOP, re_cmd)
    prop_cmd = torch.where(has_re, re_cmd, new_cmd)
    do = is_owner_d & (has_re | can_new)
    p_oh = (do[:, None, None, :] & d_oh[:, :, None, :]
            & oh_pr[:, None, :, :])
    log_bal = torch.where(p_oh, d_bal[:, None, None, :], log_bal)
    log_cmd = torch.where(p_oh & ~log_commit, prop_cmd[:, None, None, :],
                          log_cmd)
    # latency clock: a slot's FIRST propose starts it
    m_prop_t = torch.where(p_oh & ~proposed, ctx.t, m_prop_t)
    proposed = proposed | p_oh
    log_acks = log_acks | torch.where(p_oh, self_bit2[..., None, None], 0)
    next_slot = next_slot + ((do & ~has_re & can_new)[:, None, :] & d_oh)
    out_p2a = {
        "valid": do[:, None, :].expand(RRG),
        "obj": d[:, None, :].expand(RRG),
        "bal": d_bal[:, None, :].expand(RRG),
        "slot": prop_slot[:, None, :].expand(RRG),
        "cmd": prop_cmd[:, None, :].expand(RRG),
    }

    # ---------------- policy: count misses, fire steals ------------------
    miss = d_oh & ~(active & own)                      # demanded, not owned
    # consecutive policy: the counter survives only while the replica
    # keeps demanding the same unowned object
    hits = torch.where(miss, hits + 1, 0)
    # fire a steal for the hottest over-threshold object when idle
    can_steal = steal_obj < 0
    hot = torch.amax(hits, dim=1)                      # (R, G)
    hot_obj = argmax_i32(hits, 1)
    fire = can_steal & (hot >= cfg.steal_threshold)
    new_bal = ((torch.div(torch.amax(ballot, dim=1), STRIDE,
                          rounding_mode="floor") + 1) * STRIDE
               + ridx[:, None])
    f_oh = fire[:, None, :] & (oidx[None, :, None] == hot_obj[:, None, :])
    ballot = torch.where(f_oh, new_bal[:, None, :], ballot)
    active = active & ~f_oh
    steal_obj = torch.where(fire, hot_obj, steal_obj)
    p1_acks = torch.where(fire, self_bit2, p1_acks)
    hits = torch.where(f_oh, 0, hits)
    out_p1a = {
        "valid": fire[:, None, :].expand(RRG),
        "obj": hot_obj[:, None, :].expand(RRG),
        "bal": new_bal[:, None, :].expand(RRG),
    }
    # stalled steal: retry (rebump) after a timeout
    steal_timer = torch.where(steal_obj >= 0, state["steal_timer"] + 1, 0)
    timeout = steal_timer >= cfg.election_timeout + \
        tr.randint(k_jit, (R, G), 0, cfg.backoff + 1)
    steal_obj = torch.where(timeout, -1, steal_obj)   # give up; re-fire
    steal_timer = torch.where(timeout, 0, steal_timer)

    # ---------------- execute committed prefixes ------------------------
    advanced = torch.zeros((R, O, G), dtype=I32, device=dev)
    running = torch.ones((R, O, G), dtype=torch.bool, device=dev)
    for e in range(cfg.exec_window):
        abs_e = execute + e                            # (R, O, G) absolute
        inb_e = abs_e < base + S                       # execute >= base
        oh_e = (inb_e[:, :, None, :]
                & (sidx[None, None, :, None]
                   == torch.remainder(abs_e, S)[:, :, None, :]))
        com = torch.any(oh_e & log_commit, dim=2)
        running = running & com
        cmd_e = _i32sum(torch.where(oh_e, log_cmd, 0), 2)
        wr = running & (cmd_e >= 0)
        kv = torch.where(wr, cmd_e, kv)
        advanced = advanced + running
    new_execute = execute + advanced

    # ---------------- P3 out: per owner, its demanded object ------------
    new_at_d = row_at_obj(newly, d)                    # (R, S, G)
    any_new_d = torch.any(new_at_d, dim=1)
    low_new = torch.amin(torch.where(new_at_d, A_d, BIG), dim=1)  # abs
    my_exec_d = at_obj(new_execute, d)
    rr = torch.remainder(ctx.t, torch.clamp(my_exec_d - d_base, min=1))
    p3_abs = torch.where(any_new_d, low_new, d_base + rr)
    oh_3 = sidx[None, :, None] == torch.remainder(p3_abs, S)[:, None, :]
    p3_committed = torch.any(oh_3 & row_at_obj(log_commit, d), dim=1)
    p3_cmd = _i32sum(torch.where(oh_3, row_at_obj(log_cmd, d), 0), 1)
    p3_do = (at_obj((active & own).to(I32), d) > 0) & p3_committed
    out_p3 = {
        "valid": p3_do[:, None, :].expand(RRG),
        "obj": d[:, None, :].expand(RRG),
        "bal": d_bal[:, None, :].expand(RRG),
        "slot": p3_abs[:, None, :].expand(RRG),
        "cmd": p3_cmd[:, None, :].expand(RRG),
        "upto": my_exec_d[:, None, :].expand(RRG),
        "lowslot": d_base[:, None, :].expand(RRG),
    }

    # ---------------- slide the ring windows (slot recycling) -----------
    new_base = torch.maximum(base, new_execute - RETAIN)
    drop_s = cell.cell_abs(base, S) < new_base[:, :, None, :]
    log_bal = torch.where(drop_s, 0, log_bal)
    log_cmd = torch.where(drop_s, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop_s
    proposed = proposed & ~drop_s
    log_acks = torch.where(drop_s, 0, log_acks)
    m_prop_t = torch.where(drop_s, 0, m_prop_t)

    # in-scan linearizability spot-check, per (replica, object) lane over
    # the per-object rings
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], new_execute, state["base"], new_base,
        cell.cell_abs(state["base"], S), cell.cell_abs(new_base, S),
        state["log_cmd"], log_cmd,
        state["log_commit"], log_commit, kv=kv)

    new_state = dict(
        ballot=ballot, active=active, log_bal=log_bal, log_cmd=log_cmd,
        log_commit=log_commit, log_acks=log_acks, proposed=proposed,
        base=new_base, next_slot=next_slot, execute=new_execute, kv=kv,
        hits=hits, steal_obj=steal_obj, p1_acks=p1_acks,
        steal_timer=steal_timer, steals=steals,
        m_prop_t=m_prop_t, m_lat_local_sum=m_lat_local_sum,
        m_lat_local_n=m_lat_local_n, m_lat_cross_sum=m_lat_cross_sum,
        m_lat_cross_n=m_lat_cross_n, m_lat_hist=m_lat_hist,
        m_lat_sum=m_lat_sum, m_inscan_viol=m_inscan_viol,
        **wl_planes,
    )
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    return {
        "committed_slots": _i32sum(torch.amax(state["execute"], dim=0)),
        "steals": _i32sum(state["steals"]),
        "owned_objects": _i32sum(state["active"]),
        # zone-local vs cross-zone commit-latency split (propose ->
        # commit, in lock-step rounds)
        "commit_lat_local_sum": _i32sum(state["m_lat_local_sum"]),
        "commit_lat_local_n": _i32sum(state["m_lat_local_n"]),
        "commit_lat_cross_sum": _i32sum(state["m_lat_cross_sum"]),
        "commit_lat_cross_n": _i32sum(state["m_lat_cross_n"]),
        "commit_lat_sum": _i32sum(state["m_lat_sum"]),
        "commit_lat_n": _i32sum(state["m_lat_hist"]),
        "inscan_violations": _i32sum(state["m_inscan_viol"]),
        # per-key-class sample counts (workload runs; the histograms ride
        # in state: workload.class_split)
        **{f"wl_{nm}_n": _i32sum(state[f"m_wl_hist_{nm}"])
           for nm in CLASSES if f"m_wl_hist_{nm}" in state},
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Agreement per absolute (object, slot) on the common window;
    2. commit stability under the slide; 3. per-(replica, object) ballot
    monotonicity; 4. executed prefix committed; 5. single ownership: at
    most one active owner per object and ballot.  Each group's
    violations, ``(G,)`` int32 (the owner pairs halve per group)."""
    BIG = 2 ** 30
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = cell.cell_abs(base, S)                         # (R, O, S, G)

    vis = c & (A >= torch.amax(base, dim=0)[None, :, None, :])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=0)
    n_c = _i32sum(vis, 0)
    v_agree = group_sum((n_c >= 1) & (mx != mn))

    o_c = old["log_commit"] \
        & (cell.cell_abs(old["base"], S) >= base[:, :, None, :])
    v_stable = group_sum(o_c & (~c | (cmd != old["log_cmd"])))
    v_stable = v_stable + group_sum(new["execute"] < base)

    v_bal = group_sum(new["ballot"] < old["ballot"])

    v_exec = group_sum((A < new["execute"][:, :, None, :]) & ~c)

    # two active replicas owning the same object at the same ballot would
    # be a stolen-twice bug; different ballots are a transient
    own = new["active"]
    bal = torch.where(own, new["ballot"], -1)
    r = torch.arange(cfg.n_replicas, device=own.device)
    same = (own[:, None] & own[None, :]
            & (bal[:, None] == bal[None, :])
            & (r[:, None, None, None] != r[None, :, None, None]))
    v_own = torch.div(group_sum(same), 2, rounding_mode="floor")

    return v_agree + v_stable + v_bal + v_exec + v_own


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="wpaxos",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)

# the seeded thin-read-quorum bug twin (see ``step``): registered as
# ``wpaxos_thinq1``; never a correctness case
PROTOCOL_THINQ1 = SimProtocol(
    name="wpaxos_thinq1",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=functools.partial(step, q1_full=False),
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
