"""SDPaxos (semi-decentralized Paxos) as a lane-major sim kernel (torch
twin of the JAX package's ``protocols/sdpaxos/sim.py``).

Command replication is decentralized: every replica leads the commands it
receives and replicates them itself (a C-instance per command).  Ordering
is centralized: one elected sequencer assigns global sequence slots
(O-instances).  A command executes once its body is durable on a majority
and its O-instance is committed, in O-log order.

Layout, as in the reference:
- The O-log is the shared fixed-cell Multi-Paxos core (``sim/cell_ring.py``,
  the paxos kernel's): ballot election, P1 merge, P2 acceptance under
  bit-packed ack masks, P3 commit, snapshot catch-up, go-back-N retry.
- An O-entry carries only its owner id; the t-th committed token of owner
  ``o`` binds to o's t-th command, so ordering is idempotent across
  sequencer failovers.
- C-replication is frontier-shaped: a replica's copy of owner ``o``'s
  command log is the cumulative count ``c_stored[me, o]``; ``chosen`` is
  the MAJ-th order statistic of the owner's cumulative ack row.
- Execution walks the committed O-prefix and stalls (never reorders) on a
  missing body, broadcasting a ``cneed`` request that any holder answers
  with ``cr``.

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim import cell
from paxi_tpu_torch.sim import cell_ring as br
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.cell_ring import NO_CMD
from paxi_tpu_torch.sim.ring import diag2, dst_major, pick_src
from paxi_tpu_torch.sim.ring import require_packable
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

IDX_BITS = 20  # cidx field width in the executed command id
I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        # decentralized command replication (cumulative go-back-N)
        "ca": ("cidx",),      # owner -> all: body of my command #cidx
        "cack": ("n",),       # all -> owner: stored your [0, n)
        "oreq": ("n",),       # owner -> all: my chosen frontier is n
        # pull-side body recovery
        "cneed": ("owner", "cidx"),   # staller -> all: I need (o, i)
        "cr": ("owner", "cidx"),      # holder -> staller: relayed body
        # centralized ordering: Multi-Paxos on owner tokens
        "p1a": ("bal",),
        "p1b": ("bal",),
        "p2a": ("bal", "slot", "cmd"),
        "p2b": ("bal", "slot"),
        "p3": ("bal", "slot", "cmd", "upto"),
    }


def encode_cmd(owner, cidx):
    """Executed command id for owner's cidx-th command (KV payload)."""
    return (owner << IDX_BITS) | cidx


def cmd_key(cmd, n_keys: int):
    return fib_key(cmd, n_keys)


def _i32sum(x, dim=None):
    if dim is None:
        return torch.sum(x, dtype=I32)
    return torch.sum(x, dim=dim, dtype=I32)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    del rng
    device = resolve_device(device)
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    require_packable(R)
    i32 = dict(dtype=I32, device=device)
    b = dict(dtype=torch.bool, device=device)
    timer = (torch.arange(R, **i32) * cfg.election_timeout)[:, None]
    return dict(
        # ---- C-plane (decentralized command replication) ----
        c_next=torch.zeros((R, G), **i32),       # my proposed command count
        c_stored=torch.zeros((R, R, G), **i32),  # [me, owner] stored count
        c_ack=torch.zeros((R, R, G), **i32),     # [owner, dst] acked count
        o_seen=torch.zeros((R, R, G), **i32),    # [me, owner] chosen frontier
        o_enq=torch.zeros((R, R, G), **i32),     # [seqr, owner] tokens ordered
        exec_c=torch.zeros((R, R, G), **i32),    # [me, owner] tokens executed
        # ---- O-log (centralized ordering; shared ring machinery) ----
        ballot=torch.zeros((R, G), **i32),
        active=torch.zeros((R, G), **b),
        p1_acks=torch.zeros((R, G), **i32),
        base=torch.zeros((R, G), **i32),
        log_bal=torch.zeros((R, S, G), **i32),
        log_cmd=torch.full((R, S, G), NO_CMD, **i32),   # owner token / NOOP
        log_commit=torch.zeros((R, S, G), **b),
        log_acks=torch.zeros((R, S, G), **i32),
        proposed=torch.zeros((R, S, G), **b),
        next_slot=torch.zeros((R, G), **i32),
        execute=torch.zeros((R, G), **i32),
        kv=torch.zeros((R, K, G), **i32),
        timer=timer.expand(R, G).contiguous(),
        stuck=torch.zeros((R, G), **i32),
        # measurement planes (never read by protocol logic): each O-slot's
        # first propose step at the sequencer, pending propose->commit
        # deltas, the latency histogram and the in-scan spot-check count
        m_prop_t=torch.zeros((R, S, G), **i32),
        m_commit_dt=torch.zeros((R, S, G), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )


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
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)
    st = br.merge_acker_logs(st, amask, p1_win)
    # a takeover restarts the adopted slots' latency clocks
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)

    # ---------------- phase-1 win: rebuild per-owner token counts -------
    # tokens ordered for owner o = tokens executed (exec_c) + o's tokens
    # in my window at or above the execute frontier
    A = cell.cell_abs(st["base"], S)
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
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)

    # ---------------- sequencer proposes (backlog or re-proposal) -------
    # ordering queue: the deepest-backlog owner's token
    is_leader = st["active"] & br.own_bal_mask(st, STRIDE)
    has_re, can_new, prop_cell, prop_slot, oh_p, re_cmd = \
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
        abs_e = execute + e                              # absolute
        inb_e = abs_e < st["base"] + S                   # execute >= base
        oh_e = inb_e[:, None, :] & (sidx[None, :, None]
                                    == torch.remainder(abs_e, S)[:, None, :])
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
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)

    # in-scan linearizability spot-check, accumulated per group
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], st["execute"], state["base"], st["base"],
        cell.cell_abs(state["base"], S), cell.cell_abs(st["base"], S),
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


def metrics(state, cfg: SimConfig):
    """Committed slots = executed O-prefix at the most advanced replica,
    summed over the trailing group axis (int32 scalars)."""
    return {
        "committed_slots": _i32sum(torch.amax(state["execute"], dim=0)),
        "min_execute": _i32sum(torch.amin(state["execute"], dim=0)),
        "commands_proposed": _i32sum(state["c_next"]),
        "has_sequencer": _i32sum(torch.any(state["active"], dim=0)),
        "commit_lat_sum": _i32sum(state["m_lat_sum"]),
        "commit_lat_n": (_i32sum(state["m_lat_hist"])
                         + _i32sum(state["m_commit_dt"] > 0)),
        "inscan_violations": _i32sum(state["m_inscan_viol"]),
    }


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The paxos O-log oracle (agreement, stability, ballot monotonicity,
    executed prefix committed) plus monotone C-plane frontiers.  Returns
    an int32 scalar."""
    BIG = 2 ** 30
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = cell.cell_abs(base, S)

    vis = c & (A >= torch.amax(base, dim=0)[None, None, :])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=0)
    n_c = _i32sum(vis, 0)
    v_agree = _i32sum((n_c >= 1) & (mx != mn))

    o_c = old["log_commit"] \
        & (cell.cell_abs(old["base"], S) >= base[:, None, :])
    v_stable = _i32sum(o_c & (~c | (cmd != old["log_cmd"])))
    v_stable = v_stable + _i32sum(new["execute"] < base)

    v_bal = _i32sum(new["ballot"] < old["ballot"])

    v_exec = _i32sum((A < new["execute"][:, None, :]) & ~c)

    v_cmono = _i32sum(new["c_stored"] < old["c_stored"])
    v_cmono = v_cmono + _i32sum(new["c_next"] < old["c_next"])
    v_cmono = v_cmono + _i32sum(new["exec_c"] < old["exec_c"])

    return v_agree + v_stable + v_bal + v_exec + v_cmono


PROTOCOL = SimProtocol(
    name="sdpaxos",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    batched=True,
)
