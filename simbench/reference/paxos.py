"""Multi-Paxos, the plain reference: a frozen copy of the port's
lane-major kernel (``protocols/paxos/sim.py``) without the client workload
model.

Single stable leader, phase-1 ballot election with log recovery from P1b
payloads, per-slot phase-2 acceptance under a majority quorum, P3 commit
broadcast, in-order execution into a KV store.  The group axis is LAST on
every plane — state ``(R, G)`` / ``(R, S, G)``, mailbox planes
``(src, dst, G)`` — and every handler runs every step on every replica as
a masked update.  The ballot/ring consensus core lives in
``cell_ring.py``; this module adds the client load model (the leader
proposes one new command per step while the window has room) and
execution.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from simbench.reference import cell
from simbench.reference import cell_ring as br
from simbench.reference import common as lathist
from simbench.reference import common as inscan
from simbench.reference.cell_ring import NO_CMD, NOOP  # noqa: F401
from simbench.reference.common import Geometry as SimConfig
from simbench.reference.common import StepCtx, fib_key, group_sum
from simbench.reference.ring import require_packable


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        "p1a": ("bal",),
        "p1b": ("bal",),
        "p2a": ("bal", "slot", "cmd"),
        "p2b": ("bal", "slot"),
        "p3": ("bal", "slot", "cmd", "upto"),
    }


def encode_cmd(bal, slot):
    """Command id per (ballot, slot); doubles as the KV write payload."""
    return ((bal & 0x7FFF) << 16) | (slot & 0xFFFF)


def cmd_key(cmd, n_keys: int):
    """Hash the command id onto the KV key space."""
    return fib_key(cmd, n_keys)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device``; ``rng`` is unused."""
    del rng
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    require_packable(R)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    timer = (torch.arange(R, **i32) * cfg.election_timeout)[:, None]
    st = dict(
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
        # measurement planes (never read by protocol logic): first
        # propose step, pending propose->commit deltas, the latency
        # histogram and the in-scan spot-check count
        m_prop_t=torch.zeros((R, S, G), **i32),
        m_commit_dt=torch.zeros((R, S, G), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )
    return st


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    RETAIN = max(S // 2, 1)
    dev = state["ballot"].device
    sidx = torch.arange(S, dtype=torch.int32, device=dev)
    kidx = torch.arange(K, dtype=torch.int32, device=dev)

    st = {k: state[k] for k in br.KEYS}
    kv = state["kv"]
    m_prop_t = state["m_prop_t"]
    m_lat_hist = state["m_lat_hist"]
    m_lat_sum = state["m_lat_sum"]

    # ---------------- ballot/ring consensus core (shared) ---------------
    st, out_p1b, promote = br.promise_p1a(st, inbox["p1a"])
    st, p1_win, amask = br.tally_p1b(st, inbox["p1b"], MAJ, STRIDE)
    b0 = st["base"]
    st, ex = br.adopt_best_acker(st, amask, p1_win, {"kv": kv})
    kv = ex["kv"]
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)
    st = br.merge_acker_logs(st, amask, p1_win)
    # a takeover restarts the adopted slots' latency clocks
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2b, acc_ok, _ = br.accept_p2a(st, inbox["p2a"])
    st, newly = br.tally_p2b(st, inbox["p2b"], MAJ, STRIDE)
    # every newly committed (leader, slot) stores its propose->commit
    # delta in the pending plane; the runner's deferred flush bins it
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly, dt, state["m_commit_dt"])
    m_lat_sum = m_lat_sum + torch.sum(torch.where(newly, dt, 0),
                                      dim=(0, 1), dtype=torch.int32)
    b0 = st["base"]
    st, ex, c_has, c_bal = br.apply_p3(st, inbox["p3"], {"kv": kv})
    kv = ex["kv"]
    m_prop_t = cell.advance_clear(m_prop_t, b0, st["base"], 0)

    # ---------------- leader proposes (new cmd or re-proposal) ----------
    is_leader = st["active"] & br.own_bal_mask(st, STRIDE)
    has_re, can_new, prop_cell, prop_slot, oh_p, re_cmd = \
        br.repropose_target(st)
    is_new = ~has_re & can_new
    prop_cmd = torch.where(is_new, encode_cmd(st["ballot"], prop_slot),
                           re_cmd)
    do = is_leader & (has_re | can_new)
    # a slot's FIRST propose starts its latency clock
    m_prop_t = torch.where(do[:, None, :] & oh_p & ~st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2a = br.propose_write(st, do, is_new, prop_cmd, prop_slot,
                                   oh_p)

    # ---------------- execute committed prefix, apply to KV -------------
    execute = st["execute"]
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(st["active"])
    for e in range(cfg.exec_window):
        abs_e = execute + e                              # (R, G) absolute
        inb_e = abs_e < st["base"] + S                   # execute >= base
        oh_e = inb_e[:, None, :] & (sidx[None, :, None]
                                    == torch.remainder(abs_e, S)[:, None, :])
        com = torch.any(oh_e & st["log_commit"], dim=1)
        running = running & com
        cmd_e = torch.sum(torch.where(oh_e, st["log_cmd"], 0), dim=1,
                          dtype=torch.int32)
        key_e = cmd_key(cmd_e, K)
        wr = running & (cmd_e >= 0)
        ohk = wr[:, None, :] & (kidx[None, :, None] == key_e[:, None, :])
        kv = torch.where(ohk, cmd_e[:, None, :], kv)
        advanced = advanced + running.to(torch.int32)
    new_execute = execute + advanced

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

    new_state = dict(st, kv=kv, m_prop_t=m_prop_t,
                     m_commit_dt=m_commit_dt, m_lat_hist=m_lat_hist,
                     m_lat_sum=m_lat_sum, m_inscan_viol=m_inscan_viol)
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def _i32sum(x):
    return torch.sum(x, dtype=torch.int32)


# the plane each command count reads: its most advanced replica's value
COMMAND_PLANES = {"committed_slots": "execute"}


def command_count(planes, command: str):
    """The command total ``command`` of ``metrics`` from its plane alone."""
    return _i32sum(torch.amax(planes[COMMAND_PLANES[command]], dim=0))


def metrics(state, cfg: SimConfig):
    """Committed slots = executed prefix at the most advanced replica,
    summed over the trailing group axis (int32 scalars)."""
    return {
        "committed_slots": command_count(state, "committed_slots"),
        "min_execute": _i32sum(torch.amin(state["execute"], dim=0)),
        "has_leader": _i32sum(torch.any(state["active"], dim=0)),
        "commit_lat_sum": _i32sum(state["m_lat_sum"]),
        "commit_lat_n": (_i32sum(state["m_lat_hist"])
                         + _i32sum(state["m_commit_dt"] > 0)),
        "inscan_violations": _i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Per-step safety oracle: agreement on committed commands, stability
    of commits while in the window (and execute >= base), ballot
    monotonicity, executed prefix committed.  Returns each group's
    violations, ``(G,)`` int32."""
    BIG = 2 ** 30
    S = cfg.n_slots
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]
    A = cell.cell_abs(base, S)                           # (R, S, G)

    # 1. agreement on the common window [max(base), max(base)+S)
    vis = c & (A >= torch.amax(base, dim=0)[None, None, :])
    mx = torch.amax(torch.where(vis, cmd, -BIG), dim=0)  # (S, G)
    mn = torch.amin(torch.where(vis, cmd, BIG), dim=0)
    n_c = torch.sum(vis, dim=0, dtype=torch.int32)
    v_agree = group_sum((n_c >= 1) & (mx != mn))

    # 2. stability: old commits still in-window live in the same cell
    o_c = old["log_commit"] \
        & (cell.cell_abs(old["base"], S) >= base[:, None, :])
    v_stable = group_sum(o_c & (~c | (cmd != old["log_cmd"])))
    v_stable = v_stable + group_sum(new["execute"] < base)

    # 3. ballot monotonicity
    v_bal = group_sum(new["ballot"] < old["ballot"])

    # 4. executed prefix committed (cells below the frontier)
    v_exec = group_sum((A < new["execute"][:, None, :]) & ~c)

    return v_agree + v_stable + v_bal + v_exec


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)
