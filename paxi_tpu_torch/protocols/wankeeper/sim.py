"""WanKeeper — hierarchical token coordination, as a lane-major sim kernel
(torch twin of the JAX package's ``protocols/wankeeper/sim.py``).

A replicated root grants per-object tokens to zones; an object is written
only in the zone that holds its token, and token moves are serialized by
the root.  Layout and rules, as in the reference:

- The root log is the shared fixed-cell Multi-Paxos core
  (``sim/cell_ring.py``) over token-transfer commands, replicated across
  every replica; applying the committed prefix IS the token table.
- A transfer is ``revoke(o)`` then ``grant(o, z, v)``: the releasing
  zone's leader reports its final zone-committed version (``rel``, tagged
  with the revoke's slot as its generation) and the root proposes the
  grant only after that report, so the receiving zone resumes where the
  releasing zone committed.  A stale grant (below the last applied grant
  version ``gver``) is inert.
- Zone replication is frontier-shaped: the zone leader (lowest replica id
  of its zone) bumps its demanded object's version once a step, members
  apply in order and ack; the zone-committed version is the zone-majority
  order statistic of the acked versions.
- The demand is drawn in the kernel from the step key,
  ``cfg.locality``-skewed towards home objects (``o % Z``).
- ``m_`` planes measure zone-local (write -> zone commit) and cross-zone
  (token request -> grant landing) latency, and the root log's
  propose -> commit histogram.

``PROTOCOL_NOFLOOR`` is the seeded-bug twin (``gver_floor=False``): the
release report is not floored at ``gver`` and stale grants apply, so a
dropped grant can regress committed writes.

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.sim import cell
from paxi_tpu_torch.sim import cell_ring as br
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.cell_ring import NO_CMD
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import dst_major, require_packable
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

I32 = torch.int32

# root command encoding: kind(1) | obj(7) | zone(6) | ver(16), positive
K_REVOKE = 0
K_GRANT = 1


def enc_revoke(obj):
    return (K_REVOKE << 29) | (obj << 22)


def enc_grant(obj, zone, ver):
    return (K_GRANT << 29) | (obj << 22) | (zone << 16) | ver


def dec_kind(cmd):
    return (cmd >> 29) & 1


def dec_obj(cmd):
    return (cmd >> 22) & 0x7F


def dec_zone(cmd):
    return (cmd >> 16) & 0x3F


def dec_ver(cmd):
    return cmd & 0xFFFF


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        # zone plane: in-order object writes + cumulative acks
        "zrep": ("obj", "ver"),
        "zack": ("obj", "ver"),
        # root plane: token requests and release reports (``gen``: the
        # root-log slot of the revoke being answered)
        "treq": ("obj",),
        "rel": ("obj", "ver", "gen"),
        # the root log (shared Multi-Paxos core)
        "p1a": ("bal",),
        "p1b": ("bal",),
        "p2a": ("bal", "slot", "cmd"),
        "p2b": ("bal", "slot"),
        "p3": ("bal", "slot", "cmd", "upto"),
    }


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, S, O, G = cfg.n_replicas, cfg.n_slots, cfg.n_objects, n_groups
    Z = cfg.n_zones
    assert R % Z == 0, "wankeeper: n_replicas must be divisible by n_zones"
    # the root command's field widths (enc_revoke/enc_grant)
    assert O <= 128, "wankeeper: n_objects > 128 overflows the 7-bit field"
    assert Z <= 64, "wankeeper: n_zones > 64 overflows the 6-bit field"
    del rng
    require_packable(R)
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)
    home = (torch.arange(O, **i32) % Z)[None, :, None].expand(R, O, G)
    timer = (torch.arange(R, **i32) * cfg.election_timeout)[:, None]
    return dict(
        # ---- token table + zone replication (derived from the root log)
        token_zone=home.contiguous(),
        prev_zone=home.contiguous(),
        ver=torch.zeros((R, O, G), **i32),      # my applied object versions
        aver=torch.zeros((R, R, O, G), **i32),  # [ldr, member] acked vers
        want=torch.full((R, O, G), -1, **i32),  # [root ldr] requesting zone
        relv=torch.full((R, O, G), -1, **i32),  # reported rel ver
        pend=torch.zeros((R, O, G), **b),       # [root ldr] revoke proposed
        pgen=torch.full((R, O, G), -1, **i32),  # executed-revoke generation
        rgen=torch.full((R, O, G), -1, **i32),  # my zone's release gen
        gver=torch.zeros((R, O, G), **i32),     # oracle: last granted ver
        viol_acc=torch.zeros((G,), **i32),      # oracle: grant regressions
        writes=torch.zeros((R, G), **i32),      # leader write count
        transfers=torch.zeros((R, G), **i32),
        # ---- root log (shared ballot-ring planes) ----
        ballot=torch.zeros((R, G), **i32),
        active=torch.zeros((R, G), **b),
        p1_acks=torch.zeros((R, G), **i32),
        base=torch.zeros((R, G), **i32),
        log_bal=torch.zeros((R, S, G), **i32),
        log_cmd=torch.full((R, S, G), NO_CMD, **i32),
        log_commit=torch.zeros((R, S, G), **b),
        log_acks=torch.zeros((R, S, G), **i32),
        proposed=torch.zeros((R, S, G), **b),
        next_slot=torch.zeros((R, G), **i32),
        execute=torch.zeros((R, G), **i32),
        timer=timer.expand(R, G).contiguous(),
        stuck=torch.zeros((R, G), **i32),
        # ---- zone-latency accounting (measurement planes, never read by
        # protocol logic): LOCAL = a leader's write until its zone-majority
        # commit, CROSS = a token request until the grant lands; one
        # outstanding sample per (leader, object)
        m_wr_t=torch.zeros((R, O, G), **i32),
        m_wr_p=torch.zeros((R, O, G), **b),
        m_acq_t=torch.zeros((R, O, G), **i32),
        m_acq_p=torch.zeros((R, O, G), **b),
        m_lat_local_sum=torch.zeros((G,), **i32),
        m_lat_local_n=torch.zeros((G,), **i32),
        m_lat_cross_sum=torch.zeros((G,), **i32),
        m_lat_cross_n=torch.zeros((G,), **i32),
        # root-log commit-latency histogram + in-scan spot-check
        m_prop_t=torch.zeros((R, S, G), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )


_EXTRAS = ("token_zone", "prev_zone", "ver", "want", "relv", "pend", "pgen",
           "rgen", "gver")


def step(state, inbox, ctx: StepCtx, gver_floor: bool = True):
    """One lock-step round; ``gver_floor=False`` is the seeded-bug twin
    (``PROTOCOL_NOFLOOR``)."""
    cfg = ctx.cfg
    R, S, O = cfg.n_replicas, cfg.n_slots, cfg.n_objects
    Z = cfg.n_zones
    ZR = R // Z
    ZMAJ = ZR // 2 + 1
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    dev = state["ballot"].device
    ridx, sidx, oidx = iota(R, dev), iota(S, dev), iota(O, dev)
    my_zone = torch.div(ridx, ZR, rounding_mode="floor")   # (R,)
    is_zldr = (ridx % ZR) == 0
    T = dst_major

    st = {k: state[k] for k in br.KEYS}
    token_zone = state["token_zone"]
    prev_zone = state["prev_zone"]
    ver = state["ver"]
    aver = state["aver"]
    want = state["want"]
    relv = state["relv"]
    pend = state["pend"]
    pgen = state["pgen"]
    rgen = state["rgen"]
    gver = state["gver"]
    writes = state["writes"]
    transfers = state["transfers"]
    G = writes.shape[-1]
    RRG = (R, R, G)

    same_zone = my_zone[:, None] == my_zone[None, :]      # (me, src)

    # ============ zone plane: apply leader writes, cumulative acks ======
    m = inbox["zrep"]
    zv = T(m["valid"]) & same_zone[:, :, None]            # (me, ldr, G)
    zo = torch.clamp(T(m["obj"]), 0, O - 1)
    zn = T(m["ver"])
    hit = (zv[:, :, None, :]
           & (zo[:, :, None, :] == oidx[None, None, :, None])
           & (zn[:, :, None, :] == ver[:, None, :, :] + 1))
    ver = ver + torch.any(hit, dim=1)
    got_rep = torch.any(zv, dim=1)                        # (me, G)
    rcv_obj = torch.amax(torch.where(zv, zo, 0), dim=1)   # (me, G)

    # leaders collect acks per object (max over time = cumulative)
    m = inbox["zack"]
    av = T(m["valid"]) & same_zone[:, :, None] & is_zldr[:, None, None]
    ao = torch.clamp(T(m["obj"]), 0, O - 1)
    an = T(m["ver"])
    ahit = av[:, :, None, :] & (ao[:, :, None, :]
                                == oidx[None, None, :, None])
    aver = torch.maximum(aver, torch.where(ahit, an[:, :, None, :], 0))
    # my own store is always current
    self_d = (ridx[:, None, None] == ridx[None, :, None])[..., None]
    aver = torch.where(self_d, ver[:, None], aver)
    # zone-committed version: the ZMAJ-th largest over my zone's members
    avz = torch.where(same_zone[:, :, None, None], aver, -1)
    committed_v = torch.clamp(
        torch.sort(avz, dim=1).values[:, R - ZMAJ], min=0)  # (ldr, O, G)

    # ---- zone-latency accounting: settle LOCAL write samples ----------
    m_wr_t, m_wr_p = state["m_wr_t"], state["m_wr_p"]
    m_acq_t, m_acq_p = state["m_acq_t"], state["m_acq_p"]
    m_lat_local_sum = state["m_lat_local_sum"]
    m_lat_local_n = state["m_lat_local_n"]
    m_lat_cross_sum = state["m_lat_cross_sum"]
    m_lat_cross_n = state["m_lat_cross_n"]
    settled = m_wr_p & (committed_v >= ver)               # (ldr, O, G)
    wdt = torch.clamp(ctx.t - m_wr_t, min=0)
    m_lat_local_sum = m_lat_local_sum + i32sum(
        torch.where(settled, wdt, 0), (0, 1))
    m_lat_local_n = m_lat_local_n + i32sum(settled, (0, 1))
    m_wr_p = m_wr_p & ~settled

    # ============ root log: shared Multi-Paxos core =====================
    st, out_p1b, promote = br.promise_p1a(st, inbox["p1a"])
    st, p1_win, amask = br.tally_p1b(st, inbox["p1b"], MAJ, STRIDE)
    # token_zone/prev_zone travel with (execute) by replacement; ver/gver
    # are zone-local monotone counters, so state transfer max-merges them
    extras = dict(zip(_EXTRAS, (token_zone, prev_zone, ver, want, relv,
                                pend, pgen, rgen, gver)))
    b0 = st["base"]
    st, ex = br.adopt_best_acker(st, amask, p1_win, extras)
    token_zone, prev_zone, want, relv, pend, pgen, rgen = (
        ex["token_zone"], ex["prev_zone"], ex["want"], ex["relv"],
        ex["pend"], ex["pgen"], ex["rgen"])
    ver = torch.maximum(ver, ex["ver"])
    gver = torch.maximum(gver, ex["gver"])
    # m_prop_t follows the core's recycled cells
    m_prop_t = cell.advance_clear(state["m_prop_t"], b0, st["base"], 0)
    st = br.merge_acker_logs(st, amask, p1_win)
    # a takeover restarts the adopted slots' latency clocks
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    # a fresh root starts with a clean proposal-dedup slate
    pend = torch.where(p1_win[:, None, :], False, pend)
    st, out_p2b, acc_ok, _ = br.accept_p2a(st, inbox["p2a"])
    st, newly = br.tally_p2b(st, inbox["p2b"], MAJ, STRIDE)
    # propose -> commit step delta of every newly committed (leader, slot)
    rdt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_lat_hist = lathist.hist_update(state["m_lat_hist"], rdt, newly)
    m_lat_sum = state["m_lat_sum"] + i32sum(torch.where(newly, rdt, 0),
                                             (0, 1))
    extras = dict(zip(_EXTRAS, (token_zone, prev_zone, ver, want, relv,
                                pend, pgen, rgen, gver)))
    b0 = st["base"]
    st, ex, c_has, c_bal = br.apply_p3(st, inbox["p3"], extras)
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)
    token_zone, prev_zone, want, relv, pend, pgen, rgen = (
        ex["token_zone"], ex["prev_zone"], ex["want"], ex["relv"],
        ex["pend"], ex["pgen"], ex["rgen"])
    ver = torch.maximum(ver, ex["ver"])
    gver = torch.maximum(gver, ex["gver"])

    is_root = st["active"] & br.own_bal_mask(st, STRIDE)

    # ---------------- root intake: token requests + release reports -----
    m = inbox["treq"]
    tv = T(m["valid"])                                    # (root, src, G)
    to = torch.clamp(T(m["obj"]), 0, O - 1)
    for s in range(R):
        oh = tv[:, s, None, :] & (to[:, s, None, :] == oidx[None, :, None])
        want = torch.where(oh, s // ZR, want)     # src s's zone
    m = inbox["rel"]
    rv = T(m["valid"])                                    # (root, src, G)
    ro = torch.clamp(T(m["obj"]), 0, O - 1)
    rn = T(m["ver"])
    rg = T(m["gen"])
    for s in range(R):
        oh = (rv[:, s, None, :]
              & (ro[:, s, None, :] == oidx[None, :, None])
              & (rg[:, s, None, :] == pgen) & (pgen >= 0))
        relv = torch.where(oh, torch.maximum(relv, rn[:, s, None, :]), relv)

    # ---------------- root proposes: revoke, then grant -----------------
    has_re, can_new, prop_cell, prop_slot, oh_p, re_cmd = \
        br.repropose_target(st)
    # grant only for the executed revoke generation with an accepted,
    # gen-matching release report
    g_ready = (pgen >= 0) & (relv >= 0) & (want >= 0)
    r_need = (~pend) & (pgen < 0) & (want >= 0) \
        & (want != token_zone) & (token_zone >= 0)
    pick_g = argmax_i32(g_ready, 1)                       # (root, G)
    any_g = torch.any(g_ready, dim=1)
    pick_r = argmax_i32(r_need, 1)
    any_r = torch.any(r_need, dim=1)
    pick_o = torch.where(any_g, pick_g, pick_r)
    sel = oidx[None, :, None] == pick_o[:, None, :]       # (root, O, G)
    sel_want = i32sum(torch.where(sel, want, 0), 1)
    sel_relv = i32sum(torch.where(sel, relv, 0), 1)
    new_cmd = torch.where(
        any_g, enc_grant(pick_o, torch.clamp(sel_want, 0, Z - 1),
                         torch.clamp(sel_relv, 0, 0xFFFF)),
        enc_revoke(pick_o))
    is_new = ~has_re & can_new & (any_g | any_r)
    prop_cmd = torch.where(is_new, new_cmd, re_cmd)
    do = is_root & (has_re | is_new)
    # latency clock: a slot's FIRST propose starts it
    m_prop_t = torch.where(do[:, None, :] & oh_p & ~st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2a = br.propose_write(st, do, is_new, prop_cmd, prop_slot,
                                   oh_p)
    # soft bookkeeping for the entry just proposed
    bump = (is_new & do)[:, None, :] & sel
    pend = torch.where(bump, ~any_g[:, None, :], pend)
    want = torch.where(bump & any_g[:, None, :], -1, want)

    # ---------------- execute the committed root prefix -----------------
    execute = st["execute"]
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(st["active"])
    viol_gv = torch.zeros((G,), dtype=I32, device=dev)
    zone3 = my_zone[:, None, None]
    for e in range(cfg.exec_window):
        abs_e = execute + e                               # absolute
        inb_e = abs_e < st["base"] + S                    # execute >= base
        oh_e = inb_e[:, None, :] & (sidx[None, :, None]
                                    == torch.remainder(abs_e, S)[:, None, :])
        com = torch.any(oh_e & st["log_commit"], dim=1)
        running = running & com
        cmd_e = i32sum(torch.where(oh_e, st["log_cmd"], 0), 1)
        wr = running & (cmd_e >= 0)
        kind = dec_kind(cmd_e)
        obj = torch.clamp(dec_obj(cmd_e), 0, O - 1)
        zon = dec_zone(cmd_e)
        v = dec_ver(cmd_e)
        ohh = wr[:, None, :] & (oidx[None, :, None] == obj[:, None, :])
        slot_e = (execute + e)[:, None, :]
        # revoke: token in transit; remember the releasing zone and the
        # generation (this revoke's agreed slot)
        rv_ = ohh & (kind == K_REVOKE)[:, None, :]
        live = rv_ & (token_zone >= 0)
        prev_zone = torch.where(live, token_zone, prev_zone)
        rgen = torch.where(live, slot_e, rgen)
        pgen = torch.where(live, slot_e, pgen)
        token_zone = torch.where(rv_, -1, token_zone)
        # grant: new holder zone, whose members adopt the handoff version;
        # a stale grant (below the last applied grant) is inert
        gr_all = ohh & (kind == K_GRANT)[:, None, :]
        gr = gr_all & (v[:, None, :] >= gver) if gver_floor else gr_all
        token_zone = torch.where(gr, zon[:, None, :], token_zone)
        pgen = torch.where(gr, -1, pgen)
        relv = torch.where(gr, -1, relv)
        in_new = gr & (zone3 == zon[:, None, :])
        ver = torch.where(in_new, torch.maximum(ver, v[:, None, :]), ver)
        # applied grants regressing gver: unreachable while the guard
        # above stands
        viol_gv = viol_gv + i32sum(gr & (v[:, None, :] < gver), (0, 1))
        gver = torch.where(gr_all, torch.maximum(gver, v[:, None, :]), gver)
        transfers = transfers + i32sum(gr, 1)
        advanced = advanced + running
    new_execute = execute + advanced
    viol_acc = state["viol_acc"] + viol_gv

    # ============ zone leaders: demand, write, request ==================
    k1 = tr.fold_in(ctx.rng, 23)
    k2 = tr.fold_in(ctx.rng, 29)
    u = tr.uniform(k1, (R, G))
    n_home = max(O // Z, 1)
    pick_local = (tr.randint(k2, (R, G), 0, n_home) * Z
                  + my_zone[:, None]) % O
    pick_any = tr.randint(k2, (R, G), 0, O)
    loc = torch.tensor(cfg.locality, dtype=torch.float32, device=dev)
    demand = torch.clamp(torch.where(u < loc, pick_local, pick_any),
                         0, O - 1).to(I32)

    dsel = oidx[None, :, None] == demand[:, None, :]      # (R, O, G)
    d_holder = i32sum(torch.where(dsel, token_zone, 0), 1)
    held = d_holder == my_zone[:, None]
    # write: bump my demanded object's version, gated on the previous
    # version being zone-committed
    d_ver = i32sum(torch.where(dsel, ver, 0), 1)
    d_cv = i32sum(torch.where(dsel, committed_v, 0), 1)
    w_do = is_zldr[:, None] & held & (d_ver - d_cv < 2)
    ver = ver + (w_do[:, None, :] & dsel)
    writes = writes + w_do
    # latency clock: the OLDEST outstanding write keeps its start
    start_w = w_do[:, None, :] & dsel & ~m_wr_p
    m_wr_t = torch.where(start_w, ctx.t, m_wr_t)
    m_wr_p = m_wr_p | start_w

    # zrep out: per-destination go-back-N — each zone member gets the
    # NEXT version it has not acked of my demanded object
    z_ver = i32sum(torch.where(dsel, ver, 0), 1)         # (ldr, G)
    av_d = i32sum(torch.where(dsel[:, None, :, :], aver, 0), 2)
    send_ver = torch.minimum(av_d + 1, z_ver[:, None, :])  # (ldr, dst, G)
    zmask_out = is_zldr[:, None, None] & same_zone[:, :, None]
    out_zrep = {
        "valid": zmask_out & (av_d < z_ver[:, None, :]),
        "obj": demand[:, None, :].expand(RRG),
        "ver": send_ver,
    }
    # zack out: echo what my leader just replicated, else rotate through
    # the objects so every object's acks keep refreshing
    ack_obj = torch.where(got_rep, rcv_obj,
                          (ctx.t + ridx[:, None]) % O).to(I32)
    ack_sel = oidx[None, :, None] == ack_obj[:, None, :]
    ack_ver = i32sum(torch.where(ack_sel, ver, 0), 1)
    zldr_of_mine = (my_zone * ZR)[:, None]                # (R, 1)
    out_zack = {
        # the same for every group: its own plane, groups at stride 1
        "valid": (ridx[None, :] == zldr_of_mine)[:, :, None]
        .expand(RRG).contiguous(),
        "obj": ack_obj[:, None, :].expand(RRG),
        "ver": ack_ver[:, None, :].expand(RRG),
    }

    # ---- zone-latency accounting: CROSS (token-acquisition) samples ----
    arrived = m_acq_p & (token_zone == zone3)
    adt = torch.clamp(ctx.t - m_acq_t, min=0)
    m_lat_cross_sum = m_lat_cross_sum + i32sum(
        torch.where(arrived, adt, 0), (0, 1))
    m_lat_cross_n = m_lat_cross_n + i32sum(arrived, (0, 1))
    m_acq_p = m_acq_p & ~arrived

    # treq out: a zone leader demanding a non-held object asks the root
    t_do = is_zldr[:, None] & ~held & (d_holder != my_zone[:, None])
    start_a = t_do[:, None, :] & dsel & ~m_acq_p
    m_acq_t = torch.where(start_a, ctx.t, m_acq_t)
    m_acq_p = m_acq_p | start_a
    out_treq = {
        "valid": t_do[:, None, :].expand(RRG),
        "obj": demand[:, None, :].expand(RRG),
    }
    # rel out: the releasing zone's leader reports its final committed
    # version for an in-transit object it held, every step until the
    # grant lands, floored at the version the token was granted at
    in_transit_mine = (token_zone == -1) & (prev_zone == zone3) \
        & is_zldr[:, None, None]
    rel_obj = argmax_i32(in_transit_mine, 1)
    any_rel = torch.any(in_transit_mine, dim=1)           # (R, G)
    rsel = oidx[None, :, None] == rel_obj[:, None, :]
    rel_ver = i32sum(torch.where(rsel, committed_v, 0), 1)
    if gver_floor:
        rel_ver = torch.maximum(
            rel_ver, i32sum(torch.where(rsel, gver, 0), 1))
    rel_gen = i32sum(torch.where(rsel, rgen, 0), 1)
    out_rel = {
        "valid": any_rel[:, None, :].expand(RRG),
        "obj": rel_obj[:, None, :].expand(RRG),
        "ver": rel_ver[:, None, :].expand(RRG),
        "gen": rel_gen[:, None, :].expand(RRG),
    }

    # self-delivery: the exchange has no loopback edge, so my own treq/rel
    # fold into my registries (landing next step, as a delivery would)
    self_treq = t_do[:, None, :] & dsel                   # (R, O, G)
    want = torch.where(self_treq, zone3, want)
    self_rel = any_rel[:, None, :] & rsel & (rgen == pgen) & (pgen >= 0)
    relv = torch.where(self_rel,
                       torch.maximum(relv, rel_ver[:, None, :]), relv)

    # ---------------- wrap-up: P3 out, retry, election, slide -----------
    out_p3 = br.p3_out(st, newly, new_execute, is_root, ctx.t)
    st = br.retry_stuck(st, new_execute, is_root, cfg.retry_timeout)
    heard = promote | acc_ok | (c_has & (c_bal >= st["ballot"]))
    st, out_p1a = br.election_tick(st, heard, ctx.rng, cfg)
    b0 = st["base"]
    st = br.slide_window(st, new_execute, RETAIN)
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)

    # in-scan spot-check over the root log (no register plane: ver/gver
    # are zone-local views, not a function of the root frontier alone)
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], st["execute"], state["base"], st["base"],
        cell.cell_abs(state["base"], S), cell.cell_abs(st["base"], S),
        state["log_cmd"], st["log_cmd"],
        state["log_commit"], st["log_commit"], kv=None)

    new_state = dict(
        st, token_zone=token_zone, prev_zone=prev_zone, ver=ver,
        aver=aver, want=want, relv=relv, pend=pend, pgen=pgen,
        rgen=rgen, gver=gver, viol_acc=viol_acc, writes=writes,
        transfers=transfers,
        m_wr_t=m_wr_t, m_wr_p=m_wr_p, m_acq_t=m_acq_t, m_acq_p=m_acq_p,
        m_lat_local_sum=m_lat_local_sum, m_lat_local_n=m_lat_local_n,
        m_lat_cross_sum=m_lat_cross_sum, m_lat_cross_n=m_lat_cross_n,
        m_prop_t=m_prop_t, m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
        m_inscan_viol=m_inscan_viol)
    outbox = {"zrep": out_zrep, "zack": out_zack, "treq": out_treq,
              "rel": out_rel, "p1a": out_p1a, "p1b": out_p1b,
              "p2a": out_p2a, "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    return {
        "committed_slots": i32sum(state["writes"]),
        "transfers": i32sum(torch.amax(state["transfers"], dim=0)),
        "root_execute": i32sum(torch.amax(state["execute"], dim=0)),
        "has_root": i32sum(torch.any(state["active"], dim=0)),
        # zone-latency split: LOCAL = write -> zone-majority commit; CROSS
        # = treq -> grant landing, in lock-step rounds
        "commit_lat_local_sum": i32sum(state["m_lat_local_sum"]),
        "commit_lat_local_n": i32sum(state["m_lat_local_n"]),
        "commit_lat_cross_sum": i32sum(state["m_lat_cross_sum"]),
        "commit_lat_cross_n": i32sum(state["m_lat_cross_n"]),
        "commit_lat_sum": i32sum(state["m_lat_sum"]),
        "commit_lat_n": i32sum(state["m_lat_hist"]),
        "inscan_violations": i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The root-log oracle (agreement, stability, ballot monotonicity,
    executed prefix committed; token exclusivity is a function of the
    agreed log), object version monotonicity, the in-kernel grant
    regression counter and grant-frontier monotonicity.  Each group's
    violations, ``(G,)`` int32."""
    BIG = 2 ** 30
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = cell.cell_abs(base, S)

    vis = c & (A >= torch.amax(base, dim=0)[None, None, :])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=0)
    n_c = i32sum(vis, 0)
    v_agree = group_sum((n_c >= 1) & (mx != mn))

    o_c = old["log_commit"] \
        & (cell.cell_abs(old["base"], S) >= base[:, None, :])
    v_stable = group_sum(o_c & (~c | (cmd != old["log_cmd"])))
    v_stable = v_stable + group_sum(new["execute"] < base)

    v_bal = group_sum(new["ballot"] < old["ballot"])
    v_exec = group_sum((A < new["execute"][:, None, :]) & ~c)
    v_ver = group_sum(new["ver"] < old["ver"])
    v_grant = new["viol_acc"] - old["viol_acc"]
    v_gmono = group_sum(new["gver"] < old["gver"])
    return (v_agree + v_stable + v_bal + v_exec + v_ver + v_grant
            + v_gmono)


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="wankeeper",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)

# the seeded-bug twin: violates under fault schedules that revoke a token
# before the receiving zone's acks catch up (never a correctness case)
PROTOCOL_NOFLOOR = SimProtocol(
    name="wankeeper_nofloor",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=functools.partial(step, gver_floor=False),
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
