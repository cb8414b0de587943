"""The frozen sliding-window SDPaxos kernel (torch twin of the JAX
package's ``protocols/sdpaxos/sim_sw.py``): the fixed-cell kernel
(``sim.py``) before its O-log moved to fixed cells, kept as its
equivalence counterpart and for the layout A/B (``python -m
paxi_tpu_torch.bench --kernel sdpaxos_sw``).

The O-log runs on the sliding half of ``sim/ballot_ring.py``: ring position
``i`` holds absolute slot ``base + i`` and every base advance moves each
ring plane with ``ring.shift_window``.  The C-plane, the planes, the
mailbox and the metrics are the fixed-cell kernel's.  Not in the
``sim_protocol`` registry; ``profiling.SW_TWINS`` names it.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch.protocols.paxos.sim_sw import log_invariants, window_abs
from paxi_tpu_torch.protocols.sdpaxos.sim import (I32, _i32sum, cmd_key,
                                                  encode_cmd, init_state,
                                                  mailbox_spec, metrics)
from paxi_tpu_torch.sim import ballot_ring as br
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.lanes import group_sum
from paxi_tpu_torch.sim.ring import diag2, dst_major, pick_src
from paxi_tpu_torch.sim.ring import shift_window as _shift
from paxi_tpu_torch.sim.types import SimConfig, SimProtocol, StepCtx


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    dev = state["ballot"].device
    ridx = torch.arange(R, dtype=I32, device=dev)
    sidx = torch.arange(S, dtype=I32, device=dev)
    kidx = torch.arange(K, dtype=I32, device=dev)
    own_diag = ridx[:, None, None] == ridx[None, :, None]   # (R, R, 1)

    st = {k: state[k] for k in br.KEYS}
    m_prop_t = state["m_prop_t"]
    m_lat_hist = state["m_lat_hist"]
    m_lat_sum = state["m_lat_sum"]
    c_next = state["c_next"]
    c_stored = state["c_stored"]
    c_ack = state["c_ack"]
    o_seen = state["o_seen"]
    o_enq = state["o_enq"]
    exec_c = state["exec_c"]
    kv = state["kv"]
    G = c_next.shape[-1]
    RRG = (R, R, G)

    T = dst_major                         # (src, dst, G) -> (me, src, G)

    # ================= C-plane: decentralized replication ===============
    # receive command bodies, in order (cumulative take)
    m = inbox["ca"]
    take = T(m["valid"]) & (T(m["cidx"]) == c_stored)    # (me, owner, G)
    c_stored = c_stored + take

    # receive relayed bodies (any src may relay any owner's next-needed
    # body, dedup'd by the cumulative-take rule)
    m = inbox["cr"]
    rv, ro, rc = T(m["valid"]), T(m["owner"]), T(m["cidx"])  # (me, src, G)
    rhit = (rv[:, :, None, :]
            & (ro[:, :, None, :] == ridx[None, None, :, None])
            & (rc[:, :, None, :] == c_stored[:, None, :, :]))
    c_stored = c_stored + torch.any(rhit, dim=1)         # (me, owner, G)

    # serve body-need requests: respond if I hold the asked index
    m = inbox["cneed"]
    nv = T(m["valid"])                                   # (me, staller, G)
    no = torch.clamp(T(m["owner"]), 0, R - 1)
    nc = T(m["cidx"])
    stored_at = torch.zeros_like(nc)
    for o in range(R):
        stored_at = torch.where(no == o, c_stored[:, o, :][:, None, :],
                                stored_at)
    # (me, staller, G) is already the (src, dst, G) outbox orientation
    out_cr = {
        "valid": nv & (nc >= 0) & (nc < stored_at),
        "owner": no,
        "cidx": nc,
    }

    # receive cumulative store-acks for my commands
    m = inbox["cack"]
    c_ack = torch.maximum(
        c_ack, torch.where(T(m["valid"]), T(m["n"]), 0))  # (owner, dst, G)

    # chosen = MAJ-th largest of my ack row (self-store included)
    ack_row = torch.where(own_diag, c_next[:, None, :], c_ack)
    chosen = torch.sort(ack_row, dim=1).values[:, R - MAJ, :]  # (owner, G)

    # learn everyone's chosen frontiers (cumulative, crash-survivable)
    m = inbox["oreq"]
    o_seen = torch.maximum(
        o_seen, torch.where(T(m["valid"]), T(m["n"]), 0))  # (me, owner, G)
    o_seen = torch.maximum(o_seen,
                           torch.where(own_diag, chosen[:, None, :], 0))

    # propose a new command of my own (closed-loop, bounded backlog)
    my_exec = diag2(exec_c)                              # (R, G)
    c_do = (c_next - my_exec) < S
    c_next = c_next + c_do
    c_stored = c_stored + (own_diag & c_do[:, None, :])  # self-store

    # C-accept out: per-destination go-back-N (what I think dst needs)
    out_ca = {
        "valid": c_ack < c_next[:, None, :],             # (owner, dst, G)
        "cidx": torch.clamp(torch.minimum(c_ack, c_next[:, None, :] - 1),
                            min=0),
    }
    # cumulative acks + chosen-frontier gossip, every step; c_stored[me,
    # owner] is exactly the (src=me, dst=owner) plane
    out_cack = {
        "valid": torch.ones(RRG, dtype=torch.bool, device=dev),
        "n": c_stored,
    }
    out_oreq = {
        "valid": torch.ones(RRG, dtype=torch.bool, device=dev),
        "n": chosen[:, None, :].expand(RRG),
    }

    # ============ O-log: shared Multi-Paxos core over owner tokens ======
    st, out_p1b, promote = br.promise_p1a(st, inbox["p1a"])
    st, p1_win, amask = br.tally_p1b(st, inbox["p1b"], MAJ, STRIDE)
    b0 = st["base"]
    st, ex = br.adopt_best_acker(st, amask, p1_win,
                                 {"kv": kv, "exec_c": exec_c})
    kv, exec_c = ex["kv"], ex["exec_c"]
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)
    st = br.merge_acker_logs(st, amask, p1_win)
    # a takeover restarts the adopted slots' latency clocks
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)

    # ---------------- phase-1 win: rebuild per-owner token counts -------
    # tokens ordered for owner o = tokens executed (exec_c) + o's tokens
    # in my window at or above the execute frontier
    A = window_abs(st["base"], S)
    at_or_above = (A >= st["execute"][:, None, :]) \
        & (A < st["next_slot"][:, None, :])
    rebuilt = torch.zeros_like(o_enq)
    for o in range(R):
        cnt = _i32sum(at_or_above & (st["log_cmd"] == o), 1)   # (R, G)
        rebuilt = torch.where(ridx[None, :, None] == o,
                              (exec_c[:, o, :] + cnt)[:, None, :], rebuilt)
    o_enq = torch.where(p1_win[:, None, :], rebuilt, o_enq)

    st, out_p2b, acc_ok, _ = br.accept_p2a(st, inbox["p2a"])
    st, newly = br.tally_p2b(st, inbox["p2b"], MAJ, STRIDE)
    # every newly committed (seqr, slot) stores its propose->commit delta
    # in the pending plane; the runner's deferred flush bins it
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly, dt, state["m_commit_dt"])
    m_lat_sum = m_lat_sum + _i32sum(torch.where(newly, dt, 0), (0, 1))
    b0 = st["base"]
    st, ex, c_has, c_bal = br.apply_p3(st, inbox["p3"],
                                       {"kv": kv, "exec_c": exec_c})
    kv, exec_c = ex["kv"], ex["exec_c"]
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)

    # ---------------- sequencer proposes (backlog or re-proposal) -------
    # ordering queue: the deepest-backlog owner's token
    is_leader = st["active"] & br.own_bal_mask(st, STRIDE)
    has_re, can_new, prop_rel, prop_slot, oh_p, re_cmd = \
        br.repropose_target(st)
    backlog = torch.clamp(o_seen - o_enq, min=0)         # (seqr, owner, G)
    pick_o = argmax_i32(backlog, 1)                      # (seqr, G)
    has_bl = torch.any(backlog > 0, dim=1)
    is_new = ~has_re & can_new & has_bl
    prop_cmd = torch.where(is_new, pick_o, re_cmd)
    do = is_leader & (has_re | is_new)
    # latency clock: a slot's FIRST propose starts it
    m_prop_t = torch.where(do[:, None, :] & oh_p & ~st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2a = br.propose_write(st, do, is_new, prop_cmd, prop_slot,
                                   oh_p)
    enq_bump = (is_new & do)[:, None, :] \
        & (ridx[None, :, None] == pick_o[:, None, :])
    o_enq = o_enq + enq_bump

    # ---------------- execute committed O-prefix (body-gated) -----------
    execute = st["execute"]
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(st["active"])
    need_own = torch.full_like(execute, -1)
    need_idx = torch.zeros_like(execute)
    for e in range(cfg.exec_window):
        rel = execute + e - st["base"]                   # ring position
        oh_e = sidx[None, :, None] == rel[:, None, :]
        com = torch.any(oh_e & st["log_commit"], dim=1)
        cmd_e = _i32sum(torch.where(oh_e, st["log_cmd"], 0), 1)
        is_tok = cmd_e >= 0
        own_e = torch.clamp(cmd_e, 0, R - 1)
        stored_e = pick_src(c_stored.transpose(0, 1), own_e)
        ec_e = pick_src(exec_c.transpose(0, 1), own_e)
        body_ok = ec_e < stored_e
        # first body-stall of this step: ask everyone for my next-NEEDED
        # body (cumulative c_stored, not exec_c)
        blk = running & com & is_tok & ~body_ok
        first_blk = blk & (need_own < 0)
        need_own = torch.where(first_blk, own_e, need_own)
        need_idx = torch.where(first_blk, stored_e, need_idx)
        runnable = com & (~is_tok | body_ok)
        running = running & runnable
        wr = running & is_tok
        full_e = encode_cmd(own_e, ec_e)   # (owner, position) -> command
        bump = wr[:, None, :] & (ridx[None, :, None] == own_e[:, None, :])
        exec_c = exec_c + bump
        key_e = cmd_key(full_e, K)
        ohk = wr[:, None, :] & (kidx[None, :, None] == key_e[:, None, :])
        kv = torch.where(ohk, full_e[:, None, :], kv)
        advanced = advanced + running
    new_execute = execute + advanced
    out_cneed = {
        "valid": (need_own >= 0)[:, None, :].expand(RRG),
        "owner": need_own[:, None, :].expand(RRG),
        "cidx": need_idx[:, None, :].expand(RRG),
    }

    # ---------------- wrap-up: P3 out, retry, election, slide -----------
    out_p3 = br.p3_out(st, newly, new_execute, is_leader, ctx.t)
    st = br.retry_stuck(st, new_execute, is_leader, cfg.retry_timeout)
    heard = promote | acc_ok | (c_has & (c_bal >= st["ballot"]))
    st, out_p1a = br.election_tick(st, heard, ctx.rng, cfg)
    b0 = st["base"]
    st = br.slide_window(st, new_execute, RETAIN)
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)

    # in-scan linearizability spot-check, accumulated per group
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], st["execute"], state["base"], st["base"],
        window_abs(state["base"], S), window_abs(st["base"], S),
        state["log_cmd"], st["log_cmd"],
        state["log_commit"], st["log_commit"], kv=kv)

    new_state = dict(st, c_next=c_next, c_stored=c_stored, c_ack=c_ack,
                     o_seen=o_seen, o_enq=o_enq, exec_c=exec_c, kv=kv,
                     m_prop_t=m_prop_t, m_commit_dt=m_commit_dt,
                     m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
                     m_inscan_viol=m_inscan_viol)
    outbox = {"ca": out_ca, "cack": out_cack, "oreq": out_oreq,
              "cneed": out_cneed, "cr": out_cr,
              "p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox



def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The paxos O-log oracle on the sliding ring (agreement, stability,
    ballot monotonicity, executed prefix committed) plus monotone C-plane
    frontiers: each group's violations, ``(G,)`` int32."""
    v_bal = group_sum(new["ballot"] < old["ballot"])
    v_cmono = group_sum(new["c_stored"] < old["c_stored"])
    v_cmono = v_cmono + group_sum(new["c_next"] < old["c_next"])
    v_cmono = v_cmono + group_sum(new["exec_c"] < old["exec_c"])
    return log_invariants(old, new, cfg) + v_bal + v_cmono


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations (an int32 scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="sdpaxos_sw",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
