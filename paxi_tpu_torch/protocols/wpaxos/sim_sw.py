"""The frozen sliding-window WPaxos kernel (torch twin of the JAX
package's ``protocols/wpaxos/sim_sw.py``): the fixed-cell kernel
(``sim.py``) before its per-object rings moved to fixed cells, kept as its
equivalence counterpart and for the layout A/B (``python -m
paxi_tpu_torch.bench --kernel wpaxos_sw``).

Ring position ``i`` of an object's ring holds absolute slot ``base + i``:
the steal merge base-aligns every acker's row, and every base advance and
snapshot adoption moves the rows with ``ring.shift_window``.  The demand
is the locality-skewed draw only: ``cfg.workload`` is ignored, as in the
reference.  The planes, the mailbox and the metrics are the fixed-cell
kernel's.  Not in the ``sim_protocol`` registry; ``profiling.SW_TWINS``
names it.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.protocols.paxos.sim_sw import log_invariants, window_abs
from paxi_tpu_torch.protocols.wpaxos import sim as _fc
from paxi_tpu_torch.protocols.wpaxos.sim import (
    I32, NO_CMD, NOOP, _i32sum, _sel_obj, _zone_quorums, encode_cmd,
    mailbox_spec, metrics)
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.lanes import group_sum
from paxi_tpu_torch.sim.ring import dst_major
from paxi_tpu_torch.sim.ring import shift_window as _shift
from paxi_tpu_torch.sim.types import SimConfig, SimProtocol, StepCtx


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The fixed-cell kernel's initial state (position ``i`` of a ring
    plane is cell ``i`` there).  A workload is ignored."""
    return _fc.init_state(cfg.with_(workload=None), rng, n_groups, device)


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, O, S = cfg.n_replicas, cfg.n_objects, cfg.n_slots
    Z, STRIDE = cfg.n_zones, cfg.ballot_stride
    Q1 = Z - cfg.grid_q2 + 1
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
    # every replica's row for MY stolen object, base-aligned (with my own)
    # to the max acker base so no resident entry is dropped
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
    adv_s = base_star[:, None, :] - b_src              # (me, src, G) >= 0
    lb = _shift(lb, adv_s, 0)
    lc = _shift(lc, adv_s, NO_CMD)
    lk = _shift(lk, adv_s, False)
    lbm = torch.where(amask[:, :, None, :], lb, -1)
    best_bal = torch.amax(lbm, dim=1)                  # (me, S, G)
    cmask = amask[:, :, None, :] & lk
    merged_commit = torch.any(cmask, dim=1)
    merged_cmd = torch.full((R, S, G), NO_CMD, dtype=I32, device=dev)
    committed_cmd = torch.full((R, S, G), NO_CMD, dtype=I32, device=dev)
    for s in range(R - 1, -1, -1):
        merged_cmd = torch.where(lbm[:, s] == best_bal, lc[:, s],
                                 merged_cmd)
        committed_cmd = torch.where(cmask[:, s], lc[:, s], committed_cmd)
    has_acc = (best_bal > 0) | merged_commit
    abs_m = window_abs(base_star, S)                   # (me, S, G) abs
    top = torch.amax(torch.where(has_acc, abs_m + 1, 0), dim=1)   # abs
    my_next = at_obj(next_slot, so)
    new_next = torch.maximum(my_next, top)
    in_win = abs_m < new_next[:, None, :]              # (me, S, G)
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    win_oh = p1_win[:, None, :] & so_oh                # (me, O, G)
    # shift my own object row to the base_star frame before overwriting
    adv_me = torch.where(win_oh, (base_star - base_so)[:, None, :], 0)
    log_bal = _shift(log_bal, adv_me, 0)
    log_cmd = _shift(log_cmd, adv_me, NO_CMD)
    log_commit = _shift(log_commit, adv_me, False)
    proposed = _shift(proposed, adv_me, False)
    log_acks = _shift(log_acks, adv_me, 0)
    m_prop_t = _shift(m_prop_t, adv_me, 0)
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
    base = torch.where(win_oh, base_star[:, None, :], base)
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
    rel2 = slot2 - base                                # (me, O, G)
    inw2 = (rel2 >= 0) & (rel2 < S)
    oh = ((acc_ok & inw2)[:, :, None, :]
          & (sidx[None, None, :, None] == rel2[:, :, None, :]))
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
        rel_s = sl_s[:, None, :] - base                # (own, O, G)
        oh_s = (ok_s[:, None, None, :]
                & (ob_s[:, None, None, :] == oidx[None, :, None, None])
                & (rel_s[:, :, None, :] == sidx[None, None, :, None]))
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
    rel3 = slot3 - base
    inw3 = (rel3 >= 0) & (rel3 < S)
    oh = ((has3 & inw3)[:, :, None, :]
          & (sidx[None, None, :, None] == rel3[:, :, None, :]))
    log_cmd = torch.where(oh, cmd3[:, :, None, :], log_cmd)
    log_bal = torch.where(oh, torch.maximum(log_bal, b3_[:, :, None, :]),
                          log_bal)
    log_commit = log_commit | oh
    abs_ = window_abs(base, S)                         # (me, O, S, G)
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
    # align my row to the owner's frame (adv > 0: adopt requires my
    # execute, hence my base, below the owner's base)
    adv_a = torch.where(adopt, b_own - base, 0)
    my_bal_s = _shift(log_bal, adv_a, 0)
    my_cmd_s = _shift(log_cmd, adv_a, NO_CMD)
    my_com_s = _shift(log_commit, adv_a, False)
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
    # "home" objects; k_jit is the steal backoff below
    k_d, k_loc, k_jit = tr.split(ctx.rng, 3)
    blk = max(O // R, 1)
    home = torch.remainder(ridx[:, None] * blk
                           + tr.randint(k_d, (R, G), 0, blk), O)
    anywhere = tr.randint(tr.fold_in(k_d, 1), (R, G), 0, O)
    local_d = tr.bernoulli(k_loc, cfg.locality, (R, G))
    d = torch.where(local_d, home, anywhere)

    # ---------------- owner proposes for the demanded object ------------
    d_oh = oidx[None, :, None] == d[:, None, :]        # (R, O, G)
    is_owner_d = torch.any(d_oh & active & own, dim=1)  # (R, G)
    d_bal = at_obj(ballot, d)
    d_next = at_obj(next_slot, d)
    d_base = at_obj(base, d)
    c_at_d = row_at_obj(log_commit, d)                 # (R, S, G)
    p_at_d = row_at_obj(proposed, d)
    abs_d = window_abs(d_base, S)                      # (R, S, G) abs
    mask_re = ~c_at_d & ~p_at_d & (abs_d < d_next[:, None, :])
    first_re = torch.argmin(torch.where(mask_re, sidx[None, :, None], S),
                            dim=1).to(I32)
    has_re = torch.any(mask_re, dim=1)
    can_new = d_next - d_base < S                      # window flow control
    rel_next = torch.clamp(d_next - d_base, 0, S - 1)
    prop_rel = torch.where(has_re, first_re, rel_next)
    prop_slot = d_base + prop_rel                      # absolute
    new_cmd = encode_cmd(d_bal, prop_slot)
    oh_pr = sidx[None, :, None] == prop_rel[:, None, :]
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
        rel_e = execute + e - base                     # (R, O, G)
        oh_e = sidx[None, None, :, None] == rel_e[:, :, None, :]
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
    low_new = torch.argmin(torch.where(new_at_d, sidx[None, :, None], S),
                           dim=1).to(I32)
    my_exec_d = at_obj(new_execute, d)
    rr = torch.remainder(ctx.t, torch.clamp(my_exec_d - d_base, min=1))
    p3_rel = torch.clamp(torch.where(any_new_d, low_new, rr), 0, S - 1)
    oh_3 = sidx[None, :, None] == p3_rel[:, None, :]
    p3_committed = torch.any(oh_3 & row_at_obj(log_commit, d), dim=1)
    p3_cmd = _i32sum(torch.where(oh_3, row_at_obj(log_cmd, d), 0), 1)
    p3_do = (at_obj((active & own).to(I32), d) > 0) & p3_committed
    out_p3 = {
        "valid": p3_do[:, None, :].expand(RRG),
        "obj": d[:, None, :].expand(RRG),
        "bal": d_bal[:, None, :].expand(RRG),
        "slot": (d_base + p3_rel)[:, None, :].expand(RRG),
        "cmd": p3_cmd[:, None, :].expand(RRG),
        "upto": my_exec_d[:, None, :].expand(RRG),
        "lowslot": d_base[:, None, :].expand(RRG),
    }

    # ---------------- slide the ring windows (slot recycling) -----------
    new_base = torch.maximum(base, new_execute - RETAIN)
    adv = new_base - base                              # (R, O, G)
    log_bal = _shift(log_bal, adv, 0)
    log_cmd = _shift(log_cmd, adv, NO_CMD)
    log_commit = _shift(log_commit, adv, False)
    proposed = _shift(proposed, adv, False)
    log_acks = _shift(log_acks, adv, 0)
    m_prop_t = _shift(m_prop_t, adv, 0)

    # in-scan linearizability spot-check, per (replica, object) lane over
    # the per-object rings
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], new_execute, state["base"], new_base,
        window_abs(state["base"], S), window_abs(new_base, S),
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
    )
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox



def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Agreement per absolute (object, slot) on the base-aligned common
    window; 2. commit stability under the slide; 3. per-(replica, object)
    ballot monotonicity; 4. executed prefix committed; 5. single
    ownership: at most one active owner per object and ballot.  Each
    group's violations, ``(G,)`` int32."""
    v_bal = group_sum(new["ballot"] < old["ballot"])
    own = new["active"]
    bal = torch.where(own, new["ballot"], -1)
    r = torch.arange(cfg.n_replicas, device=own.device)
    same = (own[:, None] & own[None, :]
            & (bal[:, None] == bal[None, :])
            & (r[:, None, None, None] != r[None, :, None, None]))
    v_own = torch.div(group_sum(same), 2, rounding_mode="floor")
    return log_invariants(old, new, cfg) + v_bal + v_own


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations (an int32 scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="wpaxos_sw",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
