"""SwitchPaxos as a lane-major sim kernel (torch twin of the JAX package's
``protocols/switchpaxos/sim.py``).

The network fabric runs acceptor and sequencer logic ("Paxos Made
Switch-y", NOPaxos), removing one message round from every commit.  The
switch lives in the carry (``switchnet/plane.py``): a frame passes the
switch at the step its outbox is built, and the vote and sequence stamp it
produces are visible one step later — one fabric delivery where the
classic P2a->P2b path costs two.

On the sliding-window ballot ring (``sim/ballot_ring.py``) this kernel
adds:

- **the in-network vote plane**: the leader fast-commits any slot whose
  register carries a vote at its own ballot; the majority-P2b tally still
  runs underneath, the fall-back for register overflow and down windows;
- **the sequencer plane**: frames carry monotone (session, sequence)
  stamps; replicas track ``expect`` and detect drops from stamp gaps,
  asking the leader (``gapreq``) to retransmit the missing frame at once
  (committed: a targeted P3; in flight: a re-proposal with its ORIGINAL
  stamp) instead of waiting out ``retry_timeout``;
- **recovery through the switch**: a phase-1 winner folds the register
  file into its log before the P1b merge (``recovery_fold``);
- **sequencer churn** (``cfg.sw_down_*``): down windows pause votes and
  stamps, window ends bump the session epoch, and replicas resync
  ``expect`` on the first stamp of a new session.

The seeded twin ``PROTOCOL_NOGAP`` replaces gap agreement with the classic
ordered-multicast mistake: on a detected gap the replica NOOP-commits its
empty slots below the arriving frame, holes the leader meanwhile commits
real commands into, so drops diverge committed values across replicas.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim import ballot_ring as br
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import NO_CMD, argmax_i32
from paxi_tpu_torch.sim.lanes import group_sum, i32sum
from paxi_tpu_torch.sim.ring import dst_major as T
from paxi_tpu_torch.sim.ring import pick_src, require_packable
from paxi_tpu_torch.sim.ring import shift_window as _shift
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)
from paxi_tpu_torch.switchnet import plane as swp
from paxi_tpu_torch.switchnet.plane import NO_SEQ

BR_KEYS = br.KEYS
GAP_SCAN = 4   # contiguous expect-advance hops per step (bounded state)
BIG = 2 ** 30


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        "p1a": ("bal",),
        "p1b": ("bal",),
        # ordered-multicast frames: the switch stamps sess/seq in flight
        "p2a": ("bal", "slot", "cmd", "sess", "seq"),
        "p2b": ("bal", "slot"),
        "p3": ("bal", "slot", "cmd", "upto", "sess", "seq"),
        # gap agreement: replica -> leader, "retransmit sequence n"
        "gapreq": ("n",),
    }


def encode_cmd(bal, slot):
    """Command id per (ballot, slot); doubles as the KV write payload."""
    return ((bal & 0x7FFF) << 16) | (slot & 0xFFFF)


def cmd_key(cmd, n_keys: int):
    """Hash the command id onto the KV key space."""
    return fib_key(cmd, n_keys)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    del rng
    device = resolve_device(device)
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    require_packable(R)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    timer = (torch.arange(R, **i32) * cfg.election_timeout)[:, None]
    return dict(
        # ---- ballot-ring core (sim/ballot_ring.py) ----
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
        kv=torch.zeros((R, K, G), **i32),
        # replica 0's timer fires at step 0 => immediate first election
        timer=timer.expand(R, G).contiguous(),
        stuck=torch.zeros((R, G), **i32),
        # ---- the in-fabric switch (switchnet/plane.py) ----
        **swp.init_planes(cfg, G, device),
        # ---- sequencer bookkeeping at the replicas ----
        # the proposer's record of its frames' stamps (gap lookups, P3
        # stamps); shifted with the ring like the log planes
        seq_ring=torch.full((R, S, G), NO_SEQ, **i32),
        # stamps of frames RECEIVED per ring slot (p2a or p3): what the
        # contiguous expect advance walks
        slot_seq=torch.full((R, S, G), NO_SEQ, **i32),
        expect=torch.zeros((R, G), **i32),   # next expected sequence
        r_sess=torch.zeros((R, G), **i32),   # session last seen
        # ---- measurement planes (never read by protocol logic; the
        # m_ prefix keeps them out of the witness hash) ----
        m_prop_t=torch.zeros((R, S, G), **i32),
        m_commit_dt=torch.zeros((R, S, G), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
        # switchnet accounting: fast-path commits, detected gaps,
        # register-file overflows (fall-backs)
        m_fast_commits=torch.zeros((G,), **i32),
        m_gap_events=torch.zeros((G,), **i32),
        m_sw_overflow=torch.zeros((G,), **i32),
    )


def _step(state, inbox, ctx: StepCtx, nogap: bool):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    dev = state["ballot"].device
    sidx = torch.arange(S, dtype=torch.int32, device=dev)
    kidx = torch.arange(K, dtype=torch.int32, device=dev)
    ridx = torch.arange(R, dtype=torch.int32, device=dev)

    st = {k: state[k] for k in BR_KEYS}
    sw = {k: state[k] for k in swp.KEYS}
    G = state["ballot"].shape[-1]
    kv = state["kv"]
    seq_ring = state["seq_ring"]
    slot_seq = state["slot_seq"]
    expect = state["expect"]
    r_sess = state["r_sess"]
    m_prop_t = state["m_prop_t"]
    m_lat_hist = state["m_lat_hist"]
    m_lat_sum = state["m_lat_sum"]
    m_fast = state["m_fast_commits"]
    m_gap = state["m_gap_events"]
    m_over = state["m_sw_overflow"]

    def realign(b0):
        """Re-align the ring-shaped extras after a base move."""
        nonlocal m_prop_t, seq_ring, slot_seq
        d = st["base"] - b0
        m_prop_t = _shift(m_prop_t, d, 0)
        seq_ring = _shift(seq_ring, d, NO_SEQ)
        slot_seq = _shift(slot_seq, d, NO_SEQ)

    # ---------- phase 1 + switch-assisted recovery ----------------
    st, out_p1b, promote = br.promise_p1a(st, inbox["p1a"])
    st, p1_win, amask = br.tally_p1b(st, inbox["p1b"], MAJ, STRIDE)
    b0 = st["base"]
    st, ex = br.adopt_best_acker(st, amask, p1_win, {"kv": kv})
    kv = ex["kv"]
    realign(b0)
    # the {switch} x recovery intersection: fold the register file into
    # the winner's log BEFORE the merge
    st = swp.recovery_fold(sw, st, p1_win, S)
    st = br.merge_acker_logs(st, amask, p1_win)
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)

    # ---------- replicas accept frames (classic path) -------------
    m2 = inbox["p2a"]
    st, out_p2b, acc_ok, _ = br.accept_p2a(st, m2)
    a_src = argmax_i32(torch.where(m2["valid"], m2["bal"], -1), 0)
    a_slot = pick_src(m2["slot"], a_src)
    f_seq = pick_src(m2["seq"], a_src)
    f_sess = pick_src(m2["sess"], a_src)
    stamped2 = acc_ok & (f_seq >= 0)

    # ---------- leader commits: fast path + fall-back -------------
    is_leader = st["active"] & br.own_bal_mask(st, STRIDE)
    # in-network acceptance: votes the switch cast LAST step
    st, newly_fast = swp.apply_fast_commits(sw, st, is_leader, S)
    m_fast = m_fast + i32sum(newly_fast, (0, 1))
    st, newly_cls = br.tally_p2b(st, inbox["p2b"], MAJ, STRIDE)
    newly = newly_fast | newly_cls
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly, dt, state["m_commit_dt"])
    m_lat_sum = m_lat_sum + i32sum(torch.where(newly, dt, 0), (0, 1))

    # ---------- P3 commit spread + snapshot catch-up --------------
    m3 = inbox["p3"]
    b0 = st["base"]
    st, ex, c_has, c_bal = br.apply_p3(st, m3, {"kv": kv})
    kv = ex["kv"]
    realign(b0)
    c_src = argmax_i32(torch.where(m3["valid"], m3["bal"], -1), 0)
    c_slot = pick_src(m3["slot"], c_src)
    p3_seq_in = pick_src(m3["seq"], c_src)
    p3_sess_in = pick_src(m3["sess"], c_src)
    stamped3 = c_has & (p3_seq_in >= 0)

    # ---------- sequencer: session bumps, stamps, gap detect ------
    s2 = torch.where(stamped2, f_sess, -1)
    s3 = torch.where(stamped3, p3_sess_in, -1)
    arr_sess = torch.maximum(s2, s3)
    newer = arr_sess > r_sess
    cand = torch.maximum(
        torch.where(stamped2 & (f_sess == arr_sess), f_seq, -1),
        torch.where(stamped3 & (p3_sess_in == arr_sess), p3_seq_in, -1))
    # sequencer failover: resync past the first stamp of the new session;
    # max(): a resync may only ever raise the cursor
    expect = torch.where(newer, torch.maximum(expect, cand + 1), expect)
    r_sess = torch.maximum(r_sess, arr_sess)
    gap = stamped2 & (f_sess == r_sess) & (f_seq > expect)
    m_gap = m_gap + i32sum(gap, 0)
    # record received stamps at their slots, then advance expect over the
    # contiguous known prefix (bounded walk)
    oh2 = stamped2[:, None, :] \
        & (sidx[None, :, None] == (a_slot - st["base"])[:, None, :])
    slot_seq = torch.where(oh2, f_seq[:, None, :], slot_seq)
    oh3w = stamped3[:, None, :] \
        & (sidx[None, :, None] == (c_slot - st["base"])[:, None, :])
    slot_seq = torch.where(oh3w, p3_seq_in[:, None, :], slot_seq)
    for _ in range(GAP_SCAN):
        hit = torch.any(slot_seq == expect[:, None, :], dim=1)
        expect = expect + hit.to(torch.int32)

    if nogap:
        # the seeded twin: gap agreement replaced by unilateral
        # NOOP-commits; the gapreq planes stay real (R, R, G) planes
        st = swp.noop_commit_holes(st, gap, a_slot, sidx)
        out_gapreq = {
            "valid": torch.zeros((R, R, G), dtype=torch.bool, device=dev),
            "n": torch.zeros((R, R, G), dtype=torch.int32, device=dev),
        }
    else:
        # the real slow path: ask the frame's sender to retransmit the
        # first missing sequence number
        out_gapreq = {
            "valid": gap[:, None, :]
            & (ridx[None, :, None] == a_src[:, None, :]),
            "n": expect[:, None, :].expand(R, R, G),
        }

    # ---------- leader answers gap requests -----------------------
    mg = inbox["gapreq"]
    gv = T(mg["valid"])                                  # (me, src, G)
    gn = T(mg["n"])
    gr_n = torch.amin(torch.where(gv, gn, BIG), dim=1)
    has_gr = torch.any(gv, dim=1) & is_leader & (gr_n < BIG)
    oh_gr = (seq_ring == gr_n[:, None, :]) & (seq_ring >= 0) \
        & has_gr[:, None, :]
    com_gr = torch.any(oh_gr & st["log_commit"], dim=1)
    gap_rel = argmax_i32(oh_gr, 1)
    # an in-flight missing frame re-opens for immediate re-proposal (it
    # keeps its original stamp: the register remembers)
    st = swp.gap_reopen(st, oh_gr)

    # ---------- leader proposes (closed-loop client) --------------
    has_re, can_new, prop_rel, prop_slot, oh_p, re_cmd = \
        br.repropose_target(st)
    is_new = ~has_re & can_new
    prop_cmd = torch.where(is_new, encode_cmd(st["ballot"], prop_slot),
                           re_cmd)
    do = is_leader & (has_re | can_new)
    m_prop_t = torch.where(do[:, None, :] & oh_p & ~st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2a = br.propose_write(st, do, is_new, prop_cmd, prop_slot,
                                   oh_p)

    # ---------- the switch observes the outgoing frames -----------
    sw, stamp = swp.observe_p2a(sw, out_p2a, cfg, ctx.t)
    out_p2a = dict(out_p2a,
                   sess=stamp["sess"][:, None, :].expand(R, R, G),
                   seq=stamp["seq"][:, None, :].expand(R, R, G))
    # the proposer learns its frame's stamp (the vote's return leg)
    seq_ring = torch.where((stamp["seq"] >= 0)[:, None, :] & oh_p,
                           stamp["seq"][:, None, :], seq_ring)
    m_over = m_over + stamp["overflow"].to(torch.int32)

    # ---------- execute committed prefix, apply to KV -------------
    execute = st["execute"]
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(st["active"])
    for e in range(cfg.exec_window):
        rel = execute + e - st["base"]
        oh_e = sidx[None, :, None] == rel[:, None, :]
        com = torch.any(oh_e & st["log_commit"], dim=1)
        running = running & com
        cmd_e = i32sum(torch.where(oh_e, st["log_cmd"], 0), 1)
        key_e = cmd_key(cmd_e, K)
        wr = running & (cmd_e >= 0)
        ohk = wr[:, None, :] & (kidx[None, :, None] == key_e[:, None, :])
        kv = torch.where(ohk, cmd_e[:, None, :], kv)
        advanced = advanced + running.to(torch.int32)
    new_execute = execute + advanced

    # ---------- stamped P3 out (gap-override target) --------------
    low_new = torch.argmin(torch.where(newly, sidx[None, :, None], S),
                           dim=1).to(torch.int32)
    any_new = torch.any(newly, dim=1)
    span = torch.clamp(new_execute - st["base"], min=1)
    rr = torch.remainder(ctx.t, span)
    gap_p3 = has_gr & com_gr & ~any_new
    p3_rel = torch.where(any_new, low_new, torch.where(gap_p3, gap_rel, rr))
    p3_rel = torch.clamp(p3_rel, 0, S - 1)
    oh_3 = sidx[None, :, None] == p3_rel[:, None, :]
    p3_committed = torch.any(oh_3 & st["log_commit"], dim=1)
    p3_cmd = i32sum(torch.where(oh_3, st["log_cmd"], 0), 1)
    p3_seq = i32sum(torch.where(oh_3, seq_ring, 0), 1)
    p3_seq = torch.where(torch.any(oh_3 & (seq_ring >= 0), dim=1), p3_seq,
                         NO_SEQ)
    p3_do = is_leader & p3_committed
    p3_sess = swp.stamp_where(p3_seq >= 0, swp.session_t(cfg, ctx.t))
    out_p3 = {
        "valid": p3_do[:, None, :].expand(R, R, G),
        "bal": st["ballot"][:, None, :].expand(R, R, G),
        "slot": (st["base"] + p3_rel)[:, None, :].expand(R, R, G),
        "cmd": p3_cmd[:, None, :].expand(R, R, G),
        "upto": new_execute[:, None, :].expand(R, R, G),
        "sess": p3_sess[:, None, :].expand(R, R, G),
        "seq": p3_seq[:, None, :].expand(R, R, G),
    }

    # ---------- wrap-up: retry, election, slide, evict ------------
    st = br.retry_stuck(st, new_execute, is_leader, cfg.retry_timeout)
    heard = promote | acc_ok | (c_has & (c_bal >= st["ballot"]))
    st, out_p1a = br.election_tick(st, heard, ctx.rng, cfg)
    # phase-1 passes the switch too: the promise fence that stops stale
    # leaders collecting votes after a recovery read
    sw = swp.observe_p1a(sw, out_p1a)
    b0 = st["base"]
    st = br.slide_window(st, new_execute, RETAIN)
    realign(b0)
    sw = swp.evict(sw, st["execute"])

    # ---------- in-scan spot-check --------------------------------
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], st["execute"], state["base"], st["base"],
        state["base"][:, None, :] + sidx[None, :, None],
        st["base"][:, None, :] + sidx[None, :, None],
        state["log_cmd"], st["log_cmd"],
        state["log_commit"], st["log_commit"], kv=kv)

    new_state = dict(st, **sw, kv=kv, seq_ring=seq_ring,
                     slot_seq=slot_seq, expect=expect, r_sess=r_sess,
                     m_prop_t=m_prop_t, m_commit_dt=m_commit_dt,
                     m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
                     m_inscan_viol=m_inscan_viol,
                     m_fast_commits=m_fast, m_gap_events=m_gap,
                     m_sw_overflow=m_over)
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3, "gapreq": out_gapreq}
    return new_state, outbox


def step(state, inbox, ctx: StepCtx):
    return _step(state, inbox, ctx, nogap=False)


def step_nogap(state, inbox, ctx: StepCtx):
    return _step(state, inbox, ctx, nogap=True)


def metrics(state, cfg: SimConfig):
    """Committed slots = executed prefix at the most advanced replica,
    summed over the trailing group axis, with the switchnet accounting
    (int32 scalars)."""
    return {
        "committed_slots": i32sum(torch.amax(state["execute"], dim=0)),
        "min_execute": i32sum(torch.amin(state["execute"], dim=0)),
        "has_leader": i32sum(torch.any(state["active"], dim=0)),
        "fast_commits": i32sum(state["m_fast_commits"]),
        "gap_events": i32sum(state["m_gap_events"]),
        "sw_overflows": i32sum(state["m_sw_overflow"]),
        "commit_lat_sum": i32sum(state["m_lat_sum"]),
        "commit_lat_n": (i32sum(state["m_lat_hist"])
                         + i32sum(state["m_commit_dt"] > 0)),
        "inscan_violations": i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Per-step safety oracle, each group's violations ``(G,)`` int32: the
    paxos oracle on the sliding ring (agreement on committed commands over
    the base-aligned window, stability, ballot monotonicity, executed
    prefix committed) plus the sequencer's monotone contract: ``expect``
    and the seen session never regress."""
    S = cfg.n_slots
    sidx = torch.arange(S, dtype=torch.int32, device=new["base"].device)
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]

    align = torch.amax(base, dim=0)[None, :] - base
    a_c = _shift(c, align, False)
    a_cmd = _shift(cmd, align, NO_CMD)
    mx = torch.amax(torch.where(a_c, a_cmd, -BIG), dim=0)
    mn = torch.amin(torch.where(a_c, a_cmd, BIG), dim=0)
    n_c = i32sum(a_c, 0)
    v_agree = group_sum((n_c >= 1) & (mx != mn))

    adv = base - old["base"]
    o_c = _shift(old["log_commit"], adv, False)
    o_cmd = _shift(old["log_cmd"], adv, NO_CMD)
    v_stable = group_sum(o_c & (~c | (cmd != o_cmd)))
    v_stable = v_stable + group_sum(new["execute"] < base)

    v_bal = group_sum(new["ballot"] < old["ballot"])

    abs_ = base[:, None, :] + sidx[None, :, None]
    v_exec = group_sum((abs_ < new["execute"][:, None, :]) & ~c)

    v_seq = group_sum(new["expect"] < old["expect"]) \
        + group_sum(new["r_sess"] < old["r_sess"])

    return v_agree + v_stable + v_bal + v_exec + v_seq


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="switchpaxos",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)

# the seeded drop-the-gap-agreement twin (module docstring)
PROTOCOL_NOGAP = SimProtocol(
    name="switchpaxos_nogap",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step_nogap,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
