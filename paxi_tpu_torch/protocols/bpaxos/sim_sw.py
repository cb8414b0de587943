"""The frozen sliding-window Bipartisan Paxos kernel (torch twin of the
JAX package's ``protocols/bpaxos/sim_sw.py``): the fixed-cell kernel
(``sim.py``) before its slot ring moved to fixed cells, kept as its
equivalence counterpart and for the layout A/B (``python -m
paxi_tpu_torch.bench --kernel bpaxos_sw``).

Ring position ``i`` holds absolute slot ``base + i``: every base advance,
and every snapshot adoption, moves each ring plane with
``ring.shift_window``.  The planes, the mailbox, the grid geometry and the
metrics are the fixed-cell kernel's.  Not in the ``sim_protocol``
registry; ``profiling.SW_TWINS`` names it.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.protocols.bpaxos.sim import (
    I32, NO_CMD, NOOP, R_COLS, W_ROWS, _col_quorums, _geometry,
    _row_quorums, encode_cmd, init_state, mailbox_spec, metrics)
from paxi_tpu_torch.protocols.paxos.sim_sw import log_invariants, window_abs
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import shift_window as _shift
from paxi_tpu_torch.sim.types import SimConfig, SimProtocol, StepCtx


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    P, GR, GC, A, E = _geometry(cfg)
    STRIDE = cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    dev = state["execute"].device
    ridx, sidx, kidx = iota(R, dev), iota(S, dev), iota(K, dev)
    G = state["execute"].shape[-1]
    RRG = (R, R, G)

    is_proxy = (ridx < P)[:, None]                        # (R, 1)
    is_acc = ((ridx >= P) & (ridx < P + A))[:, None]
    acc_row = torch.where(ridx >= P, torch.div(ridx - P, GC,
                                               rounding_mode="floor"), -1)
    acc_col = torch.where(ridx >= P, torch.remainder(ridx - P, GC), -1)
    bal0 = (STRIDE + ridx)[:, None]                       # proxy base ballot

    st = state
    abal, vbal = st["abal"], st["vbal"]
    vcmd, vbsz = st["vcmd"], st["vbsz"]
    committed = st["committed"]
    base, execute = st["base"], st["execute"]

    def at_slot(plane, oh):
        """Value of an (R, S, G) ring plane at a per-(R, G) one-hot."""
        return i32sum(torch.where(oh, plane, 0), 1)

    def slot_oh(slot):
        rel = slot - base                  # reads the current ``base``
        inw = (rel >= 0) & (rel < S)
        return sidx[None, :, None] == rel[:, None, :], inw

    def out_planes(fields):
        z = torch.zeros(RRG, dtype=I32, device=dev)
        out = {"valid": torch.zeros(RRG, dtype=torch.bool, device=dev)}
        out.update({f: z for f in fields})
        return out

    def reply_to(out, dst, src_mask, **fields):
        """A reply from every node where ``src_mask`` (src, G) holds to the
        one node ``dst``; field values are per-sender ``(src, G)``."""
        dst_oh = (ridx == dst)[None, :, None]             # (1, R, 1)
        m = src_mask[:, None, :] & dst_oh
        out["valid"] = out["valid"] | m
        for k, v in fields.items():
            out[k] = torch.where(m, v[:, None, :], out[k])
        return out

    # ------------- acceptors: P1a (column-read probes) ------------------
    out_p1b = out_planes(("bal", "slot", "vbal", "vcmd", "vbsz"))
    for s in range(P):
        m = inbox["p1a"]
        ok = m["valid"][s] & is_acc                       # (dst=R, G)
        bal, slot = m["bal"][s], m["slot"][s]
        oh, inw = slot_oh(slot)
        cur = at_slot(abal, oh)
        grant = ok & inw & (bal >= cur)
        abal = torch.where(grant[:, None, :] & oh,
                           torch.maximum(abal, bal[:, None, :]), abal)
        out_p1b = reply_to(
            out_p1b, s, grant, bal=bal, slot=slot,
            vbal=at_slot(vbal, oh), vcmd=at_slot(vcmd, oh),
            vbsz=at_slot(vbsz, oh))

    # ------------- acceptors: P2a (row-write accepts) -------------------
    out_p2b = out_planes(("bal", "slot"))
    for s in range(P):
        m = inbox["p2a"]
        ok = m["valid"][s] & is_acc
        bal, slot = m["bal"][s], m["slot"][s]
        cmd, bsz = m["cmd"][s], m["bsz"][s]
        oh, inw = slot_oh(slot)
        cur = at_slot(abal, oh)
        acc = ok & inw & (bal >= cur)
        w = acc[:, None, :] & oh
        abal = torch.where(w, torch.maximum(abal, bal[:, None, :]), abal)
        vbal = torch.where(w, bal[:, None, :], vbal)
        vcmd = torch.where(w, cmd[:, None, :], vcmd)
        vbsz = torch.where(w, bsz[:, None, :], vbsz)
        out_p2b = reply_to(out_p2b, s, acc, bal=bal, slot=slot)

    # ------------- proxies: P1b (recovery-read tally) -------------------
    rec_slot, rec_bal = st["rec_slot"], st["rec_bal"]
    rec_phase, rec_acks = st["rec_phase"], st["rec_acks"]
    rec_vbal, rec_vcmd = st["rec_vbal"], st["rec_vcmd"]
    rec_vbsz = st["rec_vbsz"]
    for a in range(P, P + A):
        m = inbox["p1b"]
        ok = (m["valid"][a] & is_proxy & (rec_phase == 1)
              & (m["bal"][a] == rec_bal) & (m["slot"][a] == rec_slot))
        rec_acks = torch.where(ok, rec_acks | (1 << a), rec_acks)
        better = ok & (m["vbal"][a] > rec_vbal)
        rec_vbal = torch.where(better, m["vbal"][a], rec_vbal)
        rec_vcmd = torch.where(better, m["vcmd"][a], rec_vcmd)
        rec_vbsz = torch.where(better, m["vbsz"][a], rec_vbsz)

    # read quorum: ONE FULL COLUMN seen -> write the value (or NOOP)
    colq = _col_quorums(rec_acks, cfg)
    read_done = is_proxy & (rec_phase == 1) & (colq >= R_COLS)
    rec_vcmd = torch.where(read_done & (rec_vbal <= 0), NOOP, rec_vcmd)
    rec_vbsz = torch.where(read_done & (rec_vbal <= 0), 0, rec_vbsz)
    rec_phase = torch.where(read_done, 2, rec_phase)
    rec_acks = torch.where(read_done, 0, rec_acks)

    # ------------- proxies: P2b (normal + recovery tallies) -------------
    p2_acks = st["p2_acks"]
    for a in range(P, P + A):
        m = inbox["p2b"]
        ok = m["valid"][a] & is_proxy
        bal, slot = m["bal"][a], m["slot"][a]
        oh, inw = slot_oh(slot)
        norm = ok & (bal == bal0) & inw
        p2_acks = p2_acks | ((norm[:, None, :] & oh).to(I32) << a)
        rec = (ok & (rec_phase == 2) & (bal == rec_bal)
               & (slot == rec_slot))
        rec_acks = torch.where(rec, rec_acks | (1 << a), rec_acks)

    # write quorum: ONE FULL ROW of acks commits the slot
    rowq = _row_quorums(p2_acks, cfg)
    newly = (is_proxy[:, None, :] & st["proposed"] & ~committed
             & (rowq >= W_ROWS) & (vcmd != NO_CMD))
    committed = committed | newly
    # propose -> commit step delta of every newly committed (proxy, slot)
    m_prop_t = st["m_prop_t"]
    lat_dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_lat_hist = lathist.hist_update(st["m_lat_hist"], lat_dt, newly)
    m_lat_sum = st["m_lat_sum"] + i32sum(torch.where(newly, lat_dt, 0),
                                          (0, 1))

    rowq_rec = _row_quorums(rec_acks, cfg)
    rec_done = is_proxy & (rec_phase == 2) & (rowq_rec >= W_ROWS)
    oh_rec, rec_inw = slot_oh(rec_slot)
    w = (rec_done & rec_inw)[:, None, :] & oh_rec
    vcmd = torch.where(w, rec_vcmd[:, None, :], vcmd)
    vbsz = torch.where(w, rec_vbsz[:, None, :], vbsz)
    vbal = torch.where(w, rec_bal[:, None, :], vbal)
    committed = committed | w
    recovered = st["recovered"] + rec_done
    rec_phase = torch.where(rec_done, 0, rec_phase)
    rec_slot = torch.where(rec_done, -1, rec_slot)

    # ------------- everyone: P3 (commit learn + laggard healing) --------
    kv, cum_cmds = st["kv"], st["cum_cmds"]
    proposed = st["proposed"]
    next_slot = st["next_slot"]
    for s in range(P):
        m = inbox["p3"]
        ok = m["valid"][s]
        bal, slot = m["bal"][s], m["slot"][s]
        cmd, bsz = m["cmd"][s], m["bsz"][s]
        # deep-laggard healing: my frontier fell below the sender's window
        # -> take the sender's live window base and executed state by
        # reference, keep my entries (shifted, promises included) where
        # it has no commit
        low = base[s][None, :]
        adopt = ok & (execute < low)
        a2 = adopt[:, None, :]
        adv_a = torch.where(adopt, low - base, 0)
        my_abal = _shift(abal, adv_a, 0)
        my_vbal = _shift(vbal, adv_a, 0)
        my_vcmd = _shift(vcmd, adv_a, NO_CMD)
        my_vbsz = _shift(vbsz, adv_a, 0)
        my_com = _shift(committed, adv_a, False)
        s_com = committed[s][None]
        abal = torch.where(a2, torch.maximum(abal[s][None], my_abal), abal)
        vbal = torch.where(a2, torch.where(s_com, vbal[s][None], my_vbal),
                           vbal)
        vcmd = torch.where(a2, torch.where(s_com, vcmd[s][None], my_vcmd),
                           vcmd)
        vbsz = torch.where(a2, torch.where(s_com, vbsz[s][None], my_vbsz),
                           vbsz)
        committed = torch.where(a2, s_com | my_com, committed)
        proposed = torch.where(a2, False, proposed)
        p2_acks = torch.where(a2, 0, p2_acks)
        m_prop_t = torch.where(a2, 0, m_prop_t)  # adopted rows: new clocks
        kv = torch.where(adopt[:, None, :], kv[s][None], kv)
        cum_cmds = torch.where(adopt, cum_cmds[s][None], cum_cmds)
        execute = torch.where(adopt, execute[s][None, :], execute)
        base = torch.where(adopt, low, base)
        # keep proxy stripes aligned after a frontier jump
        nxt = execute + torch.remainder(ridx[:, None] - execute, P)
        next_slot = torch.where(adopt & is_proxy,
                                torch.maximum(next_slot, nxt), next_slot)
        # the message's own slot: commit exactly what it says (the
        # promise rises with it)
        oh, inw = slot_oh(slot)
        w = (ok & inw)[:, None, :] & oh
        vcmd = torch.where(w, cmd[:, None, :], vcmd)
        vbsz = torch.where(w, bsz[:, None, :], vbsz)
        vbal = torch.where(w, torch.maximum(vbal, bal[:, None, :]), vbal)
        abal = torch.where(w, torch.maximum(abal, bal[:, None, :]), abal)
        committed = committed | w

    # ------------- recovery abort: the slot got committed ---------------
    oh_rec, rec_inw = slot_oh(rec_slot)
    rec_com = torch.any(oh_rec & committed, dim=1)
    drop_rec = (rec_phase > 0) & (rec_com | (rec_slot < base))
    rec_phase = torch.where(drop_rec, 0, rec_phase)
    rec_slot = torch.where(drop_rec, -1, rec_slot)

    # ------------- execute the contiguous committed prefix --------------
    abs_ = window_abs(base, S)            # abs slot a ring position
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(execute, dtype=torch.bool)
    for e in range(cfg.exec_window):
        rel = execute + e - base                          # ring position
        oh_e = sidx[None, :, None] == rel[:, None, :]
        com = torch.any(oh_e & committed, dim=1)
        running = running & com
        cmd_e = at_slot(vcmd, oh_e)
        bsz_e = at_slot(vbsz, oh_e)
        wr = running & (cmd_e >= 0)
        key_e = fib_key(cmd_e, K)
        ohk = wr[:, None, :] & (kidx[None, :, None] == key_e[:, None, :])
        kv = torch.where(ohk, cmd_e[:, None, :], kv)
        cum_cmds = cum_cmds + torch.where(wr, bsz_e, 0)
        advanced = advanced + running
    new_execute = execute + advanced

    # ------------- proxies: propose (fresh batch or re-proposal) --------
    stuck = torch.where(is_proxy & (advanced == 0), st["stuck"] + 1, 0)
    own = torch.remainder(abs_, P) == ridx[:, None, None]
    # go-back-N reopen: on a stall re-open every own in-flight slot; the
    # counter keeps growing while stalled (it also arms the takeover)
    retry = (stuck > 0) & (torch.remainder(stuck, cfg.retry_timeout) == 0)
    reopen = (retry[:, None, :] & own & proposed & ~committed
              & (abs_ < next_slot[:, None, :]))
    proposed = proposed & ~reopen

    mask_re = (is_proxy[:, None, :] & own & ~proposed & ~committed
               & (abs_ < next_slot[:, None, :]))
    first_re = torch.argmin(torch.where(mask_re, sidx[None, :, None], S),
                            dim=1).to(I32)
    has_re = torch.any(mask_re, dim=1)
    can_new = (next_slot - base) < S
    rel_new = torch.clamp(next_slot - base, 0, S - 1)
    prop_rel = torch.where(has_re, first_re, rel_new)
    prop_slot = base + prop_rel
    oh_p = sidx[None, :, None] == prop_rel[:, None, :]
    # skip own fresh slots someone else already recovered (NOOP-filled)
    fresh_com = torch.any(oh_p & committed, dim=1)
    is_new = ~has_re & can_new
    skip = is_proxy & is_new & fresh_com
    next_slot = next_slot + skip.to(I32) * P
    # the HT-Paxos batch: one grid round commits bsz commands
    draw = tr.randint(tr.fold_in(ctx.rng, 23), (R, G), 1,
                      cfg.batch_max + 1)
    new_cmd = encode_cmd(bal0, prop_slot)
    prop_cmd = torch.where(is_new, new_cmd, at_slot(vcmd, oh_p))
    prop_cmd = torch.where(prop_cmd == NO_CMD, NOOP, prop_cmd)
    prop_bsz = torch.where(is_new, draw, at_slot(vbsz, oh_p))
    do = (is_proxy & (has_re | is_new) & ~skip & ~(rec_phase == 2)
          & ~(is_new & fresh_com))
    ohw = do[:, None, :] & oh_p & ~committed
    vcmd = torch.where(ohw, prop_cmd[:, None, :], vcmd)
    vbsz = torch.where(ohw, prop_bsz[:, None, :], vbsz)
    vbal = torch.where(ohw, bal0[:, None, :], vbal)
    # latency clock: a slot's FIRST propose starts it
    m_prop_t = torch.where(do[:, None, :] & oh_p & ~proposed
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    proposed = proposed | (do[:, None, :] & oh_p)
    next_slot = next_slot + (is_new & do).to(I32) * P

    # ------------- outgoing P2a: thrifty row-targeted -------------------
    do_recw = is_proxy & (rec_phase == 2)
    p2a_bal = torch.where(do_recw, rec_bal, bal0)
    p2a_slot = torch.where(do_recw, rec_slot, prop_slot)
    p2a_cmd = torch.where(do_recw, rec_vcmd, prop_cmd)
    p2a_bsz = torch.where(do_recw, rec_vbsz, prop_bsz)
    row_t = torch.where(do_recw, torch.remainder(st["rec_round"], GR),
                        torch.remainder(p2a_slot, GR))
    p2a_do = do | do_recw
    row_hit = (acc_row[None, :, None] == row_t[:, None, :]) \
        & is_acc[None, :, :]
    out_p2a = {
        "valid": p2a_do[:, None, :] & row_hit,
        "bal": p2a_bal[:, None, :].expand(RRG),
        "slot": p2a_slot[:, None, :].expand(RRG),
        "cmd": p2a_cmd[:, None, :].expand(RRG),
        "bsz": p2a_bsz[:, None, :].expand(RRG),
    }

    # ------------- outgoing P1a: thrifty column-targeted ----------------
    do_read = is_proxy & (rec_phase == 1)
    col_t = torch.remainder(st["rec_round"], GC)
    col_hit = (acc_col[None, :, None] == col_t[:, None, :]) \
        & is_acc[None, :, :]
    out_p1a = {
        "valid": do_read[:, None, :] & col_hit,
        "bal": rec_bal[:, None, :].expand(RRG),
        "slot": rec_slot[:, None, :].expand(RRG),
    }

    # ------------- outgoing P3: fresh commit else retransmit ------------
    low_new = torch.argmin(torch.where(newly, sidx[None, :, None], S),
                           dim=1).to(I32)
    any_new = torch.any(newly, dim=1)
    span = torch.clamp(new_execute - base, min=1)
    p3_rel = torch.where(any_new, low_new, torch.remainder(ctx.t, span))
    p3_rel = torch.where(rec_done & rec_inw,
                         torch.clamp(rec_slot - base, 0, S - 1), p3_rel)
    p3_rel = torch.clamp(p3_rel, 0, S - 1)
    oh_3 = sidx[None, :, None] == p3_rel[:, None, :]
    p3_commit = torch.any(oh_3 & committed, dim=1)
    p3_do = is_proxy & p3_commit
    out_p3 = {
        "valid": p3_do[:, None, :].expand(RRG),
        "bal": at_slot(vbal, oh_3)[:, None, :].expand(RRG),
        "slot": (base + p3_rel)[:, None, :].expand(RRG),
        "cmd": at_slot(vcmd, oh_3)[:, None, :].expand(RRG),
        "bsz": at_slot(vbsz, oh_3)[:, None, :].expand(RRG),
    }

    # ------------- takeover trigger + recovery restart ------------------
    hole_oh = sidx[None, :, None] == (new_execute - base)[:, None, :]
    hole_com = torch.any(hole_oh & committed, dim=1)
    evid = torch.any(committed & (abs_ > new_execute[:, None, :]), dim=1)
    owner = torch.remainder(new_execute, P)
    stag = torch.remainder(ridx[:, None] - owner, P)
    fire = (is_proxy & (rec_phase == 0) & evid & ~hole_com
            & (stuck >= cfg.election_timeout + 3 * stag))
    rec_round = st["rec_round"]
    # an in-flight recovery stalls (dropped probes, dead row/column
    # members): bump the ballot round and rotate row + column
    restart = (rec_phase > 0) & (st["rec_timer"] >= cfg.election_timeout)
    rec_timer = torch.where((rec_phase > 0) & ~restart,
                            st["rec_timer"] + 1, 0)
    go = fire | restart
    rec_round = torch.where(go, rec_round + 1, rec_round)
    rec_slot = torch.where(fire, new_execute, rec_slot)
    rec_bal = torch.where(go, STRIDE * (1 + rec_round) + ridx[:, None],
                          rec_bal)
    rec_phase = torch.where(go, 1, rec_phase)
    rec_acks = torch.where(go, 0, rec_acks)
    rec_vbal = torch.where(go, 0, rec_vbal)
    rec_vcmd = torch.where(go, NO_CMD, rec_vcmd)
    rec_vbsz = torch.where(go, 0, rec_vbsz)

    # a committed value's ballot is done: the promise rises with every
    # commit path, keeping accepted <= promised
    abal = torch.maximum(abal, torch.where(committed, vbal, 0))

    # ------------- slide the ring past the executed prefix --------------
    new_base = torch.maximum(base, new_execute - RETAIN)
    adv = new_base - base
    new_committed = _shift(committed, adv, False)
    new_vcmd = _shift(vcmd, adv, NO_CMD)

    # in-scan linearizability spot-check, accumulated per group
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], new_execute, state["base"], new_base,
        window_abs(state["base"], S), window_abs(new_base, S),
        state["vcmd"], new_vcmd,
        state["committed"], new_committed, kv=kv)

    new_state = dict(
        abal=_shift(abal, adv, 0), vbal=_shift(vbal, adv, 0),
        vcmd=new_vcmd, vbsz=_shift(vbsz, adv, 0),
        committed=new_committed,
        proposed=_shift(proposed, adv, False),
        p2_acks=_shift(p2_acks, adv, 0),
        next_slot=next_slot, base=new_base, execute=new_execute,
        kv=kv, cum_cmds=cum_cmds, stuck=stuck,
        rec_slot=rec_slot, rec_bal=rec_bal, rec_phase=rec_phase,
        rec_acks=rec_acks, rec_vbal=rec_vbal, rec_vcmd=rec_vcmd,
        rec_vbsz=rec_vbsz, rec_round=rec_round, rec_timer=rec_timer,
        recovered=recovered,
        m_prop_t=_shift(m_prop_t, adv, 0), m_lat_hist=m_lat_hist,
        m_lat_sum=m_lat_sum, m_inscan_viol=m_inscan_viol,
    )
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox



def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Agreement on committed (batch id, size) per slot on the aligned
    window; 2. stability while in-window, recycled slots executed;
    3. promise monotonicity and accepted <= promised at the acceptors;
    4. executed prefix committed; 5. committed batch sizes in
    0..batch_max.  Each group's violations, ``(G,)`` int32."""
    base, c, bsz = new["base"], new["committed"], new["vbsz"]
    v_log = log_invariants(old, new, cfg, commit="committed",
                           values=("vcmd", "vbsz"))
    o_abal = _shift(old["abal"], base - old["base"], 0)
    v_bal = group_sum(new["abal"] < o_abal)
    P, GR, GC, A, E = _geometry(cfg)
    ridx = iota(cfg.n_replicas, base.device)
    is_acc = ((ridx >= P) & (ridx < P + A))[:, None, None]
    v_bal = v_bal + group_sum(is_acc & (new["vbal"] > new["abal"]))
    v_bsz = group_sum(c & ((bsz < 0) | (bsz > cfg.batch_max)))
    return v_log + v_bal + v_bsz


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations (an int32 scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="bpaxos_sw",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
