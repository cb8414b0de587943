"""Multi-Paxos with the group axis LEADING: the per-group kernel (torch
twin of the JAX package's ``protocols/paxos/sim_pg.py``).

The reference writes this kernel for one group and ``vmap``s it over a
leading group axis; here the batch dimension is written out, so every
plane has the layout of the reference's vmapped state: state ``(G, R)`` /
``(G, R, S)``, mailbox planes ``(G, src, dst)``, the latency histograms
``(G, N_BUCKETS)``.  Semantics and the safety oracle are those of the
lane-major kernel (``paxos/sim.py``); under one workload spec the two give
the same command planes (the draws key on global group id and absolute
slot, not on the layout).

- A fixed ring of S slots a replica, absolute slot ``a`` in cell ``a %
  S``; the window ``[base, base + S)`` slides with the execute frontier,
  keeping the last ``S // 2`` executed slots for laggards; sliding is a
  masked clear.
- Every handler runs every step on every replica as a masked update.
- Ballots are ``round * ballot_stride + replica``; ack sets are bit-packed
  int32 masks, ``p1_acks (G, R)`` and ``log_acks (G, R, S)``.
- Messages carry absolute slots; receivers mask them against their window.
- P1b log payloads pass by reference: a phase-1 winner merges its ackers'
  logs, and a laggard winner first adopts its most advanced acker's (kv,
  execute, base).  P3 carries a commit frontier ``upto``; a follower below
  the sender's window adopts the sender's (kv, execute, base).
- Client load: the leader proposes one new command a step while the
  window has room.

Each group has its own PRNG key (``ctx.rng`` is ``(G, 2)``): the election
jitter is drawn per group, as the reference's vmap draws it.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
# one definition of the wire and command encoding for both layouts
from paxi_tpu_torch.protocols.paxos.sim import (NO_CMD, NOOP, cmd_key,
                                                encode_cmd, mailbox_spec)
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32, popcount
from paxi_tpu_torch.sim.ring import require_packable
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)
from paxi_tpu_torch.workload import compile as wlc
from paxi_tpu_torch.workload.spec import CLASSES

I32 = torch.int32
BIG = 2 ** 30


def _i32sum(x, dim):
    return torch.sum(x, dim=dim, dtype=I32)


def _cell_abs(base, S: int):
    """The absolute slot cell ``c`` holds at each replica, ``(G, R, S)``:
    the element of ``[base, base + S)`` congruent to ``c`` (mod S)."""
    sidx = torch.arange(S, dtype=I32, device=base.device)
    return base[..., None] + torch.remainder(sidx - base[..., None], S)


def _rows(x, idx):
    """``x[g, idx[g, r]]`` for every group and replica: replica rows of
    ``x (G, R, ...)`` picked by ``idx (G, R)`` (the reference's ``x[idx]``
    within a group)."""
    g = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[g, idx.long()]


def _from_src(plane, src):
    """``plane[g, src[g, d], d]``: each receiver's field from its chosen
    sender, ``(G, dst)`` (the reference's ``m[f][src, ridx]``)."""
    return torch.gather(plane, 1, src[:, None, :].long())[:, 0]


def _at_cell(plane, cell):
    """``plane[g, r, cell[g, r]]``: ``(G, R)``."""
    return torch.gather(plane, 2, cell[..., None].long())[..., 0]


def _bcast(x):
    """A ``(G, R)`` value sent from each replica to every replica:
    ``(G, src, dst)``."""
    return x[:, :, None].expand(x.shape + x.shape[-1:])


def class_hist_planes(state, cls, newly, dt):
    """Per-key-class latency planes after a step's commits, group axis
    leading (``m_wl_hist_*`` ``(G, N_BUCKETS)``): each newly committed
    cell bins its delta ``dt`` into its class's histogram."""
    out = {"wl_gid": state["wl_gid"]}
    for ci, nm in enumerate(CLASSES):
        mask = newly & (cls == ci)
        out[f"m_wl_hist_{nm}"] = lathist.hist_update_pg(
            state[f"m_wl_hist_{nm}"], dt, mask)
        out[f"m_wl_sum_{nm}"] = state[f"m_wl_sum_{nm}"] + _i32sum(
            torch.where(mask, dt, 0), (1, 2))
    return out


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The per-group initial state of ``n_groups`` groups on ``device``
    (the card unless ``"cpu"`` is asked for); ``rng`` is unused (as in the
    reference).  Under a workload, ``wl_gid`` holds the groups' global ids
    ``0..n_groups-1`` (the reference's runner patches its vmapped
    placeholder to the same); a sharded rank offsets it."""
    del rng
    device = resolve_device(device)
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    require_packable(R)
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)

    def hist():
        return torch.zeros((G, lathist.N_BUCKETS), **i32)

    st = dict(
        ballot=torch.zeros((G, R), **i32),
        active=torch.zeros((G, R), **b),
        p1_acks=torch.zeros((G, R), **i32),
        base=torch.zeros((G, R), **i32),
        log_bal=torch.zeros((G, R, S), **i32),
        log_cmd=torch.full((G, R, S), NO_CMD, **i32),
        log_commit=torch.zeros((G, R, S), **b),
        log_acks=torch.zeros((G, R, S), **i32),
        proposed=torch.zeros((G, R, S), **b),
        next_slot=torch.zeros((G, R), **i32),
        execute=torch.zeros((G, R), **i32),
        kv=torch.zeros((G, R, K), **i32),
        # replica 0's timer fires at step 0 => immediate first election
        timer=(torch.arange(R, **i32) * cfg.election_timeout)[None]
        .expand(G, R).contiguous(),
        stuck=torch.zeros((G, R), **i32),
        # measurement planes (never read by protocol logic), as in the
        # lane-major kernel
        m_prop_t=torch.zeros((G, R, S), **i32),
        m_commit_dt=torch.zeros((G, R, S), **i32),
        m_lat_hist=hist(),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )
    if cfg.workload is not None:
        st["wl_gid"] = torch.arange(G, **i32)
        for nm in CLASSES:
            st[f"m_wl_hist_{nm}"] = hist()
            st[f"m_wl_sum_{nm}"] = torch.zeros((G,), **i32)
    return st


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    t = ctx.t
    dev = state["ballot"].device
    ridx = torch.arange(R, dtype=I32, device=dev)
    sidx = torch.arange(S, dtype=I32, device=dev)
    bit = torch.ones_like(ridx) << ridx              # ack bit per source

    ballot = state["ballot"]
    active = state["active"]
    p1_acks = state["p1_acks"]
    base = state["base"]
    log_bal = state["log_bal"]
    log_cmd = state["log_cmd"]
    log_commit = state["log_commit"]
    log_acks = state["log_acks"]
    proposed = state["proposed"]
    next_slot = state["next_slot"]
    execute = state["execute"]
    kv = state["kv"]
    m_prop_t = state["m_prop_t"]
    m_lat_hist = state["m_lat_hist"]
    m_lat_sum = state["m_lat_sum"]

    def own_of(bal):
        return (bal > 0) & (torch.remainder(bal, STRIDE) == ridx)

    # ---------------- P1a: promise to the highest proposer --------------
    m = inbox["p1a"]
    b_in = torch.where(m["valid"], m["bal"], 0)          # (G, src, dst)
    p1a_bal = torch.amax(b_in, dim=1)                    # per dst
    p1a_src = argmax_i32(b_in, dim=1)
    promote = p1a_bal > ballot
    ballot = torch.maximum(ballot, p1a_bal)
    active = active & ~promote
    p1_acks = torch.where(promote, 0, p1_acks)           # my old round died
    # P1b out (log payload by reference)
    p1b_valid = promote[:, :, None] & (ridx == p1a_src[:, :, None])
    out_p1b = {"valid": p1b_valid, "bal": _bcast(ballot)}

    own_bal = own_of(ballot)

    # ---------------- P1b: collect phase-1 acks -------------------------
    m = inbox["p1b"]
    ack = (m["valid"].transpose(1, 2)
           & (m["bal"].transpose(1, 2) == ballot[:, :, None])
           & own_bal[:, :, None])                        # (G, ldr, src)
    p1_acks = p1_acks | _i32sum(torch.where(ack, bit, 0), 2)
    p1_win = own_bal & ~active & (popcount(p1_acks, R) >= MAJ)
    amask = ((p1_acks[:, :, None] >> ridx) & 1) != 0     # (G, ldr, src)

    # ---------------- phase-1 win: state transfer from best acker -------
    exec_am = torch.where(amask, execute[:, None, :], -1)  # (G, ldr, src)
    f_src = argmax_i32(exec_am, dim=2)
    front = torch.amax(exec_am, dim=2)
    el_ad = p1_win & (front > execute)
    kv = torch.where(el_ad[:, :, None], _rows(kv, f_src), kv)
    execute = torch.where(el_ad, front, execute)
    next_slot = torch.where(el_ad, torch.maximum(next_slot, front),
                            next_slot)
    # never adopt a LOWER base; recycled cells reset in place
    A_old = _cell_abs(base, S)
    base = torch.where(el_ad, torch.maximum(_rows(base, f_src), base), base)
    drop = A_old < base[:, :, None]
    log_bal = torch.where(drop, 0, log_bal)
    log_cmd = torch.where(drop, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop
    proposed = proposed & ~drop
    log_acks = torch.where(drop, 0, log_acks)
    m_prop_t = torch.where(drop, 0, m_prop_t)

    # ---------------- phase-1 win: merge ackers' logs -------------------
    # leader cell c and acker cell c hold the same absolute slot exactly
    # when the leader's slot is inside the acker's window
    A = _cell_abs(base, S)
    Al = A[:, :, None, :]                                # (G, ldr, 1, S)
    in_src = ((Al >= base[:, None, :, None])
              & (Al < base[:, None, :, None] + S))       # (G, ldr, src, S)
    sel = amask[..., None] & in_src
    lb = torch.where(sel, log_bal[:, None], -1)
    src_best = argmax_i32(lb, dim=2)                     # (G, ldr, S)
    best_bal = torch.amax(lb, dim=2)
    oh_best = ridx[:, None] == src_best[:, :, None, :]
    merged_cmd = _i32sum(torch.where(oh_best, log_cmd[:, None], 0), 2)
    cmask = sel & log_commit[:, None]
    merged_commit = torch.any(cmask, dim=2)              # (G, ldr, S)
    csrc = argmax_i32(cmask, dim=2)
    oh_csrc = ridx[:, None] == csrc[:, :, None, :]
    committed_cmd = _i32sum(torch.where(oh_csrc, log_cmd[:, None], 0), 2)
    has_acc = (best_bal > 0) | merged_commit
    top = torch.amax(torch.where(has_acc, A + 1, 0), dim=2)   # (G, ldr)
    new_next = torch.maximum(next_slot, top)
    in_win = A < new_next[:, :, None]                    # slots to own
    w = p1_win[:, :, None]
    # committed slots adopt the committed value; accepted adopt merged;
    # holes below the frontier become NOOP re-proposals
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    log_cmd = torch.where(w & in_win, adopt_cmd, log_cmd)
    log_bal = torch.where(w & in_win, ballot[:, :, None], log_bal)
    log_commit = torch.where(w & in_win, merged_commit | log_commit,
                             log_commit)
    proposed = torch.where(w, in_win & (merged_commit | log_commit),
                           proposed)
    log_acks = torch.where(w, torch.where(in_win, bit[:, None], 0),
                           log_acks)
    next_slot = torch.where(p1_win, new_next, next_slot)
    active = active | p1_win
    # a takeover restarts the adopted slots' latency clocks
    m_prop_t = torch.where(w & proposed & (m_prop_t == 0), t, m_prop_t)

    # ---------------- P2a: accept from the highest-ballot leader --------
    m = inbox["p2a"]
    b_in = torch.where(m["valid"], m["bal"], -1)
    a_src = argmax_i32(b_in, dim=1)                      # per dst
    a_bal = torch.amax(b_in, dim=1)
    a_has = a_bal > 0
    a_slot = _from_src(m["slot"], a_src)                 # absolute
    a_cmd = _from_src(m["cmd"], a_src)
    acc_ok = a_has & (a_bal >= ballot)
    demote = acc_ok & (a_bal > ballot)                   # someone else leads
    ballot = torch.where(acc_ok, a_bal, ballot)
    active = active & ~demote
    p1_acks = torch.where(demote, 0, p1_acks)
    a_inw = (a_slot >= base) & (a_slot < base + S)
    oh = ((acc_ok & a_inw)[:, :, None]
          & (sidx == torch.remainder(a_slot, S)[:, :, None]))
    writable = oh & (log_bal <= a_bal[:, :, None]) & ~log_commit
    log_bal = torch.where(writable, a_bal[:, :, None], log_bal)
    log_cmd = torch.where(writable, a_cmd[:, :, None], log_cmd)
    # ack ONLY what we durably stored (an out-of-window slot was dropped)
    out_p2b = {
        "valid": (acc_ok & a_inw)[:, :, None] & (ridx == a_src[:, :, None]),
        "bal": _bcast(a_bal),
        "slot": _bcast(a_slot),
    }

    own_bal = own_of(ballot)

    # ---------------- P2b: leader tallies acks, commits -----------------
    m = inbox["p2b"]
    lead = active & own_bal
    okb = (m["valid"].transpose(1, 2)
           & (m["bal"].transpose(1, 2) == ballot[:, :, None])
           & lead[:, :, None])                           # (G, ldr, src)
    bslot = m["slot"].transpose(1, 2)                    # absolute
    okb = okb & (bslot >= base[:, :, None]) & (bslot < base[:, :, None] + S)
    oh3 = okb[..., None] & (sidx == torch.remainder(bslot, S)[..., None])
    log_acks = log_acks | _i32sum(torch.where(oh3, bit[:, None], 0), 2)
    acks_n = popcount(log_acks, R)
    newly = (lead[:, :, None] & (acks_n >= MAJ) & ~log_commit
             & (log_cmd != NO_CMD) & proposed)
    log_commit = log_commit | newly
    # commit latency: the delta waits in the pending plane for the
    # runner's deferred flush
    lat_dt = torch.clamp(t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly, lat_dt, state["m_commit_dt"])
    m_lat_sum = m_lat_sum + _i32sum(torch.where(newly, lat_dt, 0), (1, 2))
    # per-key-class latency: the committed cell's class derives from
    # (group, absolute slot), the executor's draw
    wl = cfg.workload
    wl_planes = {}
    if wl is not None:
        gid = state["wl_gid"]                            # (G,) global ids
        cls = wlc.class_plane(wl, K, gid[:, None, None], A)
        wl_planes = class_hist_planes(state, cls, newly, lat_dt)

    # ---------------- P3: commit notifications --------------------------
    # zombie fences: a higher-ballot P3 deposes the receiver, and the
    # frontier commit fires only for bal >= my promised ballot
    m = inbox["p3"]
    b_in = torch.where(m["valid"], m["bal"], -1)
    c_src = argmax_i32(b_in, dim=1)
    c_bal = torch.amax(b_in, dim=1)
    c_has = c_bal > 0
    c_slot = _from_src(m["slot"], c_src)                 # absolute
    c_cmd = _from_src(m["cmd"], c_src)
    c_upto = _from_src(m["upto"], c_src)
    fresh3 = c_has & (c_bal >= ballot)
    promote3 = c_has & (c_bal > ballot)
    ballot = torch.where(promote3, c_bal, ballot)
    active = active & ~promote3
    p1_acks = torch.where(promote3, 0, p1_acks)
    c_inw = (c_slot >= base) & (c_slot < base + S)
    oh = ((c_has & c_inw)[:, :, None]
          & (sidx == torch.remainder(c_slot, S)[:, :, None]))
    log_cmd = torch.where(oh, c_cmd[:, :, None], log_cmd)
    log_bal = torch.where(oh, torch.maximum(log_bal, c_bal[:, :, None]),
                          log_bal)
    log_commit = log_commit | oh
    # frontier commit: slots < upto accepted at the leader's exact ballot
    ohu = (fresh3[:, :, None] & (A < c_upto[:, :, None])
           & (log_bal == c_bal[:, :, None]) & (log_cmd != NO_CMD))
    log_commit = log_commit | ohu

    # ---------------- P3: snapshot catch-up for deep laggards -----------
    # my frontier fell below the sender's window base: adopt the sender's
    # (kv, execute, base) and keep my own in-window commits
    src_base = _rows(base, c_src)
    adopt = c_has & (execute < src_base)
    keep = A >= src_base[:, :, None]
    my_bal = torch.where(keep, log_bal, 0)
    my_cmd = torch.where(keep, log_cmd, NO_CMD)
    my_com = keep & log_commit
    s_bal = _rows(log_bal, c_src)
    s_cmd = _rows(log_cmd, c_src)
    s_com = _rows(log_commit, c_src)
    a2 = adopt[:, :, None]
    log_bal = torch.where(a2, torch.where(s_com, s_bal, my_bal), log_bal)
    log_cmd = torch.where(a2, torch.where(s_com, s_cmd, my_cmd), log_cmd)
    log_commit = torch.where(a2, s_com | my_com, log_commit)
    proposed = proposed & ~a2
    log_acks = torch.where(a2, 0, log_acks)
    m_prop_t = torch.where(a2, 0, m_prop_t)
    kv = torch.where(a2, _rows(kv, c_src), kv)
    execute = torch.where(adopt, _rows(execute, c_src), execute)
    next_slot = torch.where(adopt, torch.maximum(next_slot, execute),
                            next_slot)
    base = torch.where(adopt, src_base, base)
    A = _cell_abs(base, S)

    # ---------------- leader proposes (new cmd or re-proposal) ----------
    is_leader = active & own_bal
    mask_re = ~log_commit & ~proposed & (A < next_slot[:, :, None])
    re_abs = torch.amin(torch.where(mask_re, A, BIG), dim=2)
    has_re = torch.any(mask_re, dim=2)
    can_new = (next_slot - base) < S                     # window flow control
    if wl is not None:
        # flash-crowd gate on NEW commands only (re-proposals are
        # recovery and always proceed)
        gate = wlc.demand_gate(wl, state["wl_gid"][:, None], t)
        if gate is not None:
            can_new = can_new & gate
    prop_slot = torch.where(has_re, re_abs, next_slot)   # absolute
    prop_cell = torch.remainder(prop_slot, S)
    is_new = ~has_re & can_new
    new_cmd = encode_cmd(ballot, prop_slot)
    re_cmd = _at_cell(log_cmd, prop_cell)
    re_cmd = torch.where(re_cmd == NO_CMD, NOOP, re_cmd)
    prop_cmd = torch.where(is_new, new_cmd, re_cmd)
    do = is_leader & (has_re | can_new)
    oh = do[:, :, None] & (sidx == prop_cell[:, :, None])
    log_bal = torch.where(oh, ballot[:, :, None], log_bal)
    log_cmd = torch.where(oh & ~log_commit, prop_cmd[:, :, None], log_cmd)
    # a slot's FIRST propose starts its latency clock
    m_prop_t = torch.where(oh & ~proposed & (m_prop_t == 0), t, m_prop_t)
    proposed = proposed | oh
    log_acks = log_acks | torch.where(oh, bit[:, None], 0)   # self ack
    next_slot = next_slot + (is_new & do).to(I32)
    out_p2a = {"valid": _bcast(do), "bal": _bcast(ballot),
               "slot": _bcast(prop_slot), "cmd": _bcast(prop_cmd)}

    # ---------------- execute committed prefix, apply to KV -------------
    E = cfg.exec_window
    absE = execute[:, :, None] + torch.arange(E, dtype=I32, device=dev)
    inbE = absE < base[:, :, None] + S                   # execute >= base
    cellE = torch.remainder(absE, S).long()
    comE = torch.gather(log_commit, 2, cellE) & inbE
    cmdE = torch.gather(log_cmd, 2, cellE)
    running = torch.cumprod(comE.to(I32), dim=2) != 0    # (G, R, E) prefix
    advanced = _i32sum(running, 2)
    kidx = torch.arange(K, dtype=I32, device=dev)
    for e in range(E):
        cmd_e = cmdE[:, :, e]
        if wl is None:
            key_e = cmd_key(cmd_e, K)
            wr = running[:, :, e] & (cmd_e >= 0)
        else:
            # the workload's command plane: key id and read flag from
            # (global group id, absolute slot); reads never write the KV
            gidb = state["wl_gid"][:, None]
            key_e = wlc.key_plane(wl, K, gidb, absE[:, :, e])
            wr = (running[:, :, e] & (cmd_e >= 0)
                  & ~wlc.read_plane(wl, gidb, absE[:, :, e]))
        ohk = wr[:, :, None] & (kidx == key_e[:, :, None])
        kv = torch.where(ohk, cmd_e[:, :, None], kv)
    new_execute = execute + advanced

    # ---------------- P3 out: newly committed + frontier retransmit -----
    low_new = torch.amin(torch.where(newly, A, BIG), dim=2)
    any_new = torch.any(newly, dim=2)
    span = torch.clamp(new_execute - base, min=1)
    rr = torch.remainder(t, span)
    p3_abs = torch.where(any_new, low_new, base + rr)
    p3_cell = torch.remainder(p3_abs, S)
    p3_committed = _at_cell(log_commit, p3_cell)
    p3_cmd = _at_cell(log_cmd, p3_cell)
    p3_do = is_leader & p3_committed
    out_p3 = {"valid": _bcast(p3_do), "bal": _bcast(ballot),
              "slot": _bcast(p3_abs), "cmd": _bcast(p3_cmd),
              "upto": _bcast(new_execute)}

    # ---------------- stuck-frontier retry (lost P2a/P2b) ---------------
    stalled = is_leader & (new_execute == execute) & (next_slot > new_execute)
    stuck = torch.where(stalled, state["stuck"] + 1, 0)
    retry = stuck >= cfg.retry_timeout
    ohr = retry[:, :, None] & (sidx == torch.remainder(new_execute, S)
                               [:, :, None])
    proposed = proposed & ~ohr
    stuck = torch.where(retry, 0, stuck)

    # ---------------- election timer ------------------------------------
    heard = promote | acc_ok | (c_has & (c_bal >= ballot))
    k_jit = tr.fold_in(ctx.rng, 17)                      # (G, 2)
    jitter = tr.randint(k_jit, (R,), 0, cfg.backoff + 1)  # (G, R)
    timer = torch.where(heard | active, cfg.election_timeout + jitter,
                        state["timer"] - 1)
    fire = ~active & (timer <= 0)
    top_bal = torch.amax(ballot, dim=1, keepdim=True)
    new_bal = (torch.div(top_bal, STRIDE, rounding_mode="floor") + 1) \
        * STRIDE + ridx
    ballot = torch.where(fire, new_bal, ballot)
    p1_acks = torch.where(fire, bit, p1_acks)            # self-ack only
    timer = torch.where(fire, cfg.election_timeout + jitter, timer)
    out_p1a = {"valid": _bcast(fire), "bal": _bcast(ballot)}

    # ---------------- slide the ring window (slot recycling) ------------
    new_base = torch.maximum(base, new_execute - RETAIN)
    drop = A < new_base[:, :, None]
    log_bal = torch.where(drop, 0, log_bal)
    log_cmd = torch.where(drop, NO_CMD, log_cmd)
    log_commit = log_commit & ~drop
    proposed = proposed & ~drop
    log_acks = torch.where(drop, 0, log_acks)
    m_prop_t = torch.where(drop, 0, m_prop_t)

    # in-scan linearizability spot-check: the lane-major checker over the
    # planes with the group axis moved last (views, no copies)
    def lane(x):
        return torch.movedim(x, 0, -1)
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        lane(state["execute"]), lane(new_execute), lane(state["base"]),
        lane(new_base), lane(_cell_abs(state["base"], S)),
        lane(_cell_abs(new_base, S)), lane(state["log_cmd"]),
        lane(log_cmd), lane(state["log_commit"]), lane(log_commit),
        kv=lane(kv))

    new_state = dict(
        ballot=ballot, active=active, p1_acks=p1_acks, base=new_base,
        log_bal=log_bal, log_cmd=log_cmd, log_commit=log_commit,
        log_acks=log_acks, proposed=proposed, next_slot=next_slot,
        execute=new_execute, kv=kv, timer=timer, stuck=stuck,
        m_prop_t=m_prop_t, m_commit_dt=m_commit_dt,
        m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
        m_inscan_viol=m_inscan_viol, **wl_planes,
    )
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    """Each group's metrics, ``(G,)`` int32 apiece (the reference's vmapped
    per-group metrics; the runner sums them over groups): committed slots
    = executed prefix at the most advanced replica."""
    return {
        "committed_slots": torch.amax(state["execute"], dim=1),
        "min_execute": torch.amin(state["execute"], dim=1),
        "has_leader": torch.any(state["active"], dim=1).to(I32),
        "commit_lat_sum": state["m_lat_sum"],
        "commit_lat_n": (_i32sum(state["m_lat_hist"], 1)
                         + _i32sum(state["m_commit_dt"] > 0, (1, 2))),
        "inscan_violations": state["m_inscan_viol"],
        **{f"wl_{nm}_n": _i32sum(state[f"m_wl_hist_{nm}"], 1)
           for nm in CLASSES if f"m_wl_hist_{nm}" in state},
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Per-step safety oracle, each group's violations ``(G,)`` int32:
    agreement on committed commands over the common window, stability of
    commits while in the window (and execute >= base), ballot
    monotonicity, executed prefix committed."""
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = _cell_abs(base, S)                               # (G, R, S)

    # 1. agreement on the common window [max(base), max(base)+S)
    vis = c & (A >= torch.amax(base, dim=1)[:, None, None])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=1)  # (G, S)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=1)
    n_c = _i32sum(vis, 1)
    v_agree = _i32sum((n_c >= 1) & (mx != mn), 1)

    # 2. stability: old commits still in-window live in the same cell
    o_c = old["log_commit"] & (_cell_abs(old["base"], S)
                               >= base[:, :, None])
    v_stable = _i32sum(o_c & (~c | (cmd != old["log_cmd"])), (1, 2))
    v_stable = v_stable + _i32sum(new["execute"] < base, 1)

    # 3. ballot monotonicity
    v_bal = _i32sum(new["ballot"] < old["ballot"], 1)

    # 4. executed prefix committed (cells below the frontier)
    v_exec = _i32sum((A < new["execute"][:, :, None]) & ~c, (1, 2))

    return v_agree + v_stable + v_bal + v_exec


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="paxos_pg",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=False,
)
