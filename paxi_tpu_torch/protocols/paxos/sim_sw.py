"""The frozen sliding-window Multi-Paxos kernel (torch twin of the JAX
package's ``protocols/paxos/sim_sw.py``): the layout the fixed-cell kernel
(``sim.py``) replaced, kept as its equivalence counterpart and as the
``paxos_sw`` side of the layout A/B (``python -m paxi_tpu_torch.bench
--kernel paxos_sw``).

Ring position ``i`` holds absolute slot ``base + i``; every base advance
moves each ring plane with ``ring.shift_window``.  The fixed-cell kernel
holds slot ``a`` at cell ``a % S`` and must equal this one after
``cell.window_view_np``: the same draws, outboxes, counters and state.
No workload: ``cfg.workload`` is ignored, as in the reference.  Not in the
``sim_protocol`` registry; ``profiling.SW_TWINS`` names it.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch.protocols.paxos import sim as _fc
from paxi_tpu_torch.protocols.paxos.sim import (cmd_key, encode_cmd,
                                                mailbox_spec, metrics)
from paxi_tpu_torch.sim import ballot_ring as br
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.lanes import group_sum
from paxi_tpu_torch.sim.ring import shift_window as _shift
from paxi_tpu_torch.sim.types import SimConfig, SimProtocol, StepCtx


def window_abs(base, S: int):
    """Absolute slot of each ring position: ``base + i``, ``(..., S, G)``."""
    sidx = torch.arange(S, dtype=torch.int32, device=base.device)
    return base.unsqueeze(-2) + sidx[:, None]


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The fixed-cell kernel's initial state (the same planes; position
    ``i`` of a ring plane is cell ``i`` there).  A workload is ignored."""
    return _fc.init_state(cfg.with_(workload=None), rng, n_groups, device)


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
    # m_prop_t is realigned by the same delta after every base move
    m_prop_t = state["m_prop_t"]
    m_lat_hist = state["m_lat_hist"]
    m_lat_sum = state["m_lat_sum"]

    # ---------------- ballot/ring consensus core (shared) ---------------
    st, out_p1b, promote = br.promise_p1a(st, inbox["p1a"])
    st, p1_win, amask = br.tally_p1b(st, inbox["p1b"], MAJ, STRIDE)
    b0 = st["base"]
    st, ex = br.adopt_best_acker(st, amask, p1_win, {"kv": kv})
    kv = ex["kv"]
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)
    st = br.merge_acker_logs(st, amask, p1_win)
    m_prop_t = torch.where(p1_win[:, None, :] & st["proposed"]
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    st, out_p2b, acc_ok, _ = br.accept_p2a(st, inbox["p2a"])
    st, newly = br.tally_p2b(st, inbox["p2b"], MAJ, STRIDE)
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly, dt, state["m_commit_dt"])
    m_lat_sum = m_lat_sum + torch.sum(torch.where(newly, dt, 0),
                                      dim=(0, 1), dtype=torch.int32)
    b0 = st["base"]
    st, ex, c_has, c_bal = br.apply_p3(st, inbox["p3"], {"kv": kv})
    kv = ex["kv"]
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)

    # ---------------- leader proposes (new cmd or re-proposal) ----------
    is_leader = st["active"] & br.own_bal_mask(st, STRIDE)
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

    # ---------------- execute committed prefix, apply to KV -------------
    execute = st["execute"]
    advanced = torch.zeros_like(execute)
    running = torch.ones_like(st["active"])
    for e in range(cfg.exec_window):
        rel = execute + e - st["base"]                   # ring position
        oh_e = sidx[None, :, None] == rel[:, None, :]    # no hit if >= S
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
    m_prop_t = _shift(m_prop_t, st["base"] - b0, 0)

    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["execute"], st["execute"], state["base"], st["base"],
        window_abs(state["base"], S), window_abs(st["base"], S),
        state["log_cmd"], st["log_cmd"],
        state["log_commit"], st["log_commit"], kv=kv)

    new_state = dict(st, kv=kv, m_prop_t=m_prop_t,
                     m_commit_dt=m_commit_dt, m_lat_hist=m_lat_hist,
                     m_lat_sum=m_lat_sum, m_inscan_viol=m_inscan_viol)
    outbox = {"p1a": out_p1a, "p1b": out_p1b, "p2a": out_p2a,
              "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def log_invariants(old, new, cfg: SimConfig, commit: str = "log_commit",
                   values=("log_cmd",)) -> torch.Tensor:
    """Agreement and stability of a sliding ring log, and the executed
    prefix committed, each group's count ``(G,)``: the part of the oracle
    the sliding-window kernels share.  ``commit`` names the commit plane,
    ``values`` the planes a committed slot must agree on and keep (planes
    ``(R, ..., S, G)``, base ``(R, ..., G)``)."""
    BIG = 2 ** 30
    S = cfg.n_slots
    base, c = new["base"], new[commit]

    # 1. agreement on the aligned window [max(base), max(base)+S)
    align = torch.amax(base, dim=0)[None] - base
    a_c = _shift(c, align, False)
    n_c = torch.sum(a_c, dim=0, dtype=torch.int32)
    differ = torch.zeros_like(n_c, dtype=torch.bool)
    for k in values:
        a_v = _shift(new[k], align, 0)
        mx = torch.amax(torch.where(a_c, a_v, -BIG), dim=0)
        mn = torch.amin(torch.where(a_c, a_v, BIG), dim=0)
        differ = differ | (mx != mn)
    v_agree = group_sum((n_c >= 1) & differ)

    # 2. stability: old commits still in-window must match; the window
    # may only recycle executed slots (base <= execute)
    adv = base - old["base"]
    o_c = _shift(old[commit], adv, False)
    changed = ~c
    for k in values:
        changed = changed | (new[k] != _shift(old[k], adv, 0))
    v_stable = group_sum(o_c & changed)
    v_stable = v_stable + group_sum(new["execute"] < base)

    # 4. executed prefix committed (ring positions below the frontier)
    v_exec = group_sum((window_abs(base, S)
                        < new["execute"].unsqueeze(-2)) & ~c)
    return v_agree + v_stable + v_exec


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Per-step safety oracle, each group's violations ``(G,)`` int32:
    agreement on the base-aligned common window, stability of in-window
    commits (and execute >= base), ballot monotonicity, executed prefix
    committed."""
    v_bal = group_sum(new["ballot"] < old["ballot"])
    return log_invariants(old, new, cfg) + v_bal


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations (an int32 scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="paxos_sw",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
