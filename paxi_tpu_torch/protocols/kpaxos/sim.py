"""KPaxos — statically key-partitioned Multi-Paxos, as a lane-major sim
kernel (torch twin of the JAX package's ``protocols/kpaxos/sim.py``).

The key space is split into R static partitions, each owned by a fixed
leader (partition index == leader index) running its own log; there are
no elections.  A replica's inbox holds up to R concurrent P2a messages,
one a partition, applied in one masked scatter.  As in the reference:

- State ``(R, P, S, G)`` rings a (replica, partition), position ``i``
  holding absolute slot ``base + i``; each window slides with its execute
  frontier (``ring.shift_window``), retaining the last S//2 executed
  slots.  Messages carry absolute slots; an acceptor acks only what it
  stored in-window.
- The leader's acks are a bit-packed int32 mask a (leader, slot).
- P3 carries the commit frontier ``upto`` and the leader's window base
  ``lowslot``: a replica below ``lowslot`` adopts the leader's partition
  row and KV stripe (snapshot catch-up).
- Keys are partition-striped (``key = part + R * hash``).

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim.ballot_ring import popcount
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import (diag2, dst_major, require_packable,
                                     shift_window)
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

NO_CMD = -1
I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    # partition is implicit: == src for p2a/p3, == dst for p2b
    return {
        "p2a": ("slot", "cmd"),
        "p2b": ("slot",),
        "p3": ("slot", "cmd", "upto", "lowslot"),
    }


def encode_cmd(part, slot):
    """Command id per (partition, slot) proposal."""
    return ((part & 0x7FFF) << 16) | (slot & 0xFFFF)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    del rng
    require_packable(R)
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    return dict(
        # replica-of-record ring logs: [replica, partition, slot, G]
        log_cmd=torch.full((R, R, S, G), NO_CMD, **i32),
        log_commit=torch.zeros((R, R, S, G), dtype=torch.bool,
                               device=device),
        base=torch.zeros((R, R, G), **i32),     # abs slot of ring pos 0
        # the leader's ack mask for its own partition, aligned to
        # base[ldr, ldr]
        acks=torch.zeros((R, S, G), **i32),
        next_slot=torch.zeros((R, G), **i32),   # absolute
        execute=torch.zeros((R, R, G), **i32),  # frontier a partition
        kv=torch.zeros((R, K, G), **i32),
        stuck=torch.zeros((R, G), **i32),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ = cfg.majority
    RETAIN = max(S // 2, 1)
    dev = state["next_slot"].device
    ridx, sidx, kidx = iota(R, dev), iota(S, dev), iota(K, dev)

    log_cmd = state["log_cmd"]            # (R, P, S, G)
    log_commit = state["log_commit"]
    base = state["base"]                  # (R, P, G)
    acks = state["acks"]                  # (R, S, G) bitmask
    next_slot = state["next_slot"]
    execute = state["execute"]            # (R, P, G)
    kv = state["kv"]
    G = next_slot.shape[-1]
    RRG = (R, R, G)

    T = dst_major  # mailbox (src, dst, G) -> (me=dst, src=partition, G)
    diag = diag2   # (R, P, ...) -> (R, ...) at part == replica

    # ---------------- P2a: accept for partition == src ------------------
    m = inbox["p2a"]
    v = T(m["valid"])                              # (me, part, G)
    slot = T(m["slot"])                            # absolute
    cmd = T(m["cmd"])
    rel = slot - base                              # ring position
    inw = (rel >= 0) & (rel < S)
    oh = (v & inw)[:, :, None, :] & (sidx[None, None, :, None]
                                     == rel[:, :, None, :])
    wr = oh & ~log_commit                          # committed entries frozen
    log_cmd = torch.where(wr, cmd[:, :, None, :], log_cmd)
    # ack ONLY what was stored in-window; reply planes are [sender=me,
    # recipient=part]
    out_p2b = {"valid": v & inw, "slot": slot}

    # ---------------- P2b: the leader tallies its own partition ---------
    m = inbox["p2b"]
    okb = T(m["valid"])                            # (ldr, src, G)
    bslot = T(m["slot"])
    base_own = diag(base)                          # (ldr, G)
    brel = bslot - base_own[:, None, :]            # (ldr, src, G)
    for s in range(R):
        oh_s = okb[:, s][:, None, :] & (sidx[None, :, None]
                                        == brel[:, s][:, None, :])
        acks = acks | (oh_s.to(I32) << s)
    mine = diag(log_cmd)                           # (ldr, S, G)
    mine_com = diag(log_commit)
    newly = ((popcount(acks, R) >= MAJ) & (mine != NO_CMD) & ~mine_com)
    part_oh = (ridx[:, None] == ridx[None, :])[:, :, None, None]
    log_commit = log_commit | (part_oh & newly[:, None])

    # ---------------- P3: commit notifications for partition == src -----
    m = inbox["p3"]
    v = T(m["valid"])                              # (me, part, G)
    slot = T(m["slot"])
    cmd = T(m["cmd"])
    upto = T(m["upto"])
    lowslot = T(m["lowslot"])
    rel = slot - base
    inw = (rel >= 0) & (rel < S)
    oh = (v & inw)[:, :, None, :] & (sidx[None, None, :, None]
                                     == rel[:, :, None, :])
    log_cmd = torch.where(oh, cmd[:, :, None, :], log_cmd)
    log_commit = log_commit | oh
    # frontier rule: a static leader proposes one command a slot, so any
    # locally accepted slot below upto is safe to commit
    abs_ = base[:, :, None, :] + sidx[None, None, :, None]
    ohu = (v[:, :, None, :] & (abs_ < upto[:, :, None, :])
           & (log_cmd != NO_CMD))
    log_commit = log_commit | ohu

    # ---------------- P3: snapshot catch-up for deep laggards -----------
    adopt = v & (execute < lowslot) & ~part_oh[:, :, 0, 0][..., None]
    rows_cmd, rows_com, base_p, exec_p = [], [], [], []
    for p in range(R):
        mp = adopt[:, p]                           # (me, G)
        rows_cmd.append(torch.where(mp[:, None, :], log_cmd[p, p][None],
                                    log_cmd[:, p]))
        rows_com.append(torch.where(mp[:, None, :], log_commit[p, p][None],
                                    log_commit[:, p]))
        base_p.append(torch.where(mp, base[p, p][None], base[:, p]))
        exec_p.append(torch.where(mp, execute[p, p][None], execute[:, p]))
        stripe = (kidx % R == p)[None, :, None]
        kv = torch.where(mp[:, None, :] & stripe, kv[p][None], kv)
    log_cmd = torch.stack(rows_cmd, dim=1)
    log_commit = torch.stack(rows_com, dim=1)
    base = torch.stack(base_p, dim=1)
    execute = torch.stack(exec_p, dim=1)
    base_own = diag(base)

    # ---------------- the leader proposes in its own partition ----------
    # a new slot while the pipe is healthy; the frontier slot again when
    # it has stalled for retry_timeout steps
    my_exec = diag(execute)                        # (ldr, G)
    retry = state["stuck"] >= cfg.retry_timeout
    can_new = next_slot - base_own < S             # window flow control
    prop_slot = torch.where(retry, my_exec, next_slot)   # absolute
    do = can_new | retry
    prop_rel = torch.clamp(prop_slot - base_own, 0, S - 1)
    oh_p = sidx[None, :, None] == prop_rel[:, None, :]   # (ldr, S, G)
    new_cmd = encode_cmd(ridx[:, None], prop_slot)
    re_cmd = i32sum(torch.where(oh_p, mine, 0), 1)
    prop_cmd = torch.where(retry & (re_cmd != NO_CMD), re_cmd, new_cmd)
    # self-accept + self-ack
    wr_self = (do[:, None, :] & oh_p)[:, None] & part_oh  # (R, P, S, G)
    log_cmd = torch.where(wr_self & ~log_commit,
                          prop_cmd[:, None, None, :], log_cmd)
    self_bit = (torch.ones_like(ridx) << ridx)[:, None, None]
    acks = acks | torch.where(do[:, None, :] & oh_p, self_bit, 0)
    next_slot = next_slot + (do & ~retry & can_new)
    out_p2a = {
        "valid": do[:, None, :].expand(RRG),
        "slot": prop_slot[:, None, :].expand(RRG),
        "cmd": prop_cmd[:, None, :].expand(RRG),
    }

    # ---------------- execute committed prefixes, apply to KV -----------
    advanced = torch.zeros((R, R, G), dtype=I32, device=dev)
    running = torch.ones((R, R, G), dtype=torch.bool, device=dev)
    kspace = max(K // R, 1)
    for e in range(cfg.exec_window):
        rel_e = execute + e - base                  # (rep, part, G)
        oh_e = sidx[None, None, :, None] == rel_e[:, :, None, :]
        com = torch.any(oh_e & log_commit, dim=2)
        running = running & com
        cmd_e = i32sum(torch.where(oh_e, log_cmd, 0), 2)
        key_e = (ridx[None, :, None] + R * fib_key(cmd_e, kspace)) % K
        wr = running & (cmd_e >= 0)
        ohk = wr[:, :, None, :] & (kidx[None, None, :, None]
                                   == key_e[:, :, None, :])
        kv = torch.where(torch.any(ohk, dim=1),
                         torch.amax(torch.where(ohk, cmd_e[:, :, None, :],
                                                -1), dim=1),
                         kv)
        advanced = advanced + running
    new_execute = execute + advanced

    # ---------------- stuck-frontier counter (drives retransmits) -------
    my_exec_new = diag(new_execute)
    stalled = (my_exec_new == my_exec) & (next_slot > my_exec_new)
    stuck = torch.where(retry, 0, torch.where(stalled, state["stuck"] + 1,
                                              0))

    # ---------------- P3 out: newly committed or frontier retransmit ----
    low_new = torch.argmin(torch.where(newly, sidx[None, :, None], S),
                           dim=1).to(I32)
    any_new = torch.any(newly, dim=1)
    # otherwise cycle retransmits through my in-window committed prefix
    span = torch.clamp(my_exec_new - base_own, min=1)
    rr = torch.remainder(ctx.t, span)
    p3_rel = torch.clamp(torch.where(any_new, low_new, rr), 0, S - 1)
    oh_3 = sidx[None, :, None] == p3_rel[:, None, :]
    p3_committed = torch.any(oh_3 & diag(log_commit), dim=1)
    p3_cmd = i32sum(torch.where(oh_3, diag(log_cmd), 0), 1)
    out_p3 = {
        "valid": p3_committed[:, None, :].expand(RRG),
        "slot": (base_own + p3_rel)[:, None, :].expand(RRG),
        "cmd": p3_cmd[:, None, :].expand(RRG),
        "upto": my_exec_new[:, None, :].expand(RRG),
        "lowslot": base_own[:, None, :].expand(RRG),
    }

    # ---------------- slide the ring windows (slot recycling) -----------
    new_base = torch.maximum(base, new_execute - RETAIN)
    adv = new_base - base                           # (rep, part, G)
    log_cmd = shift_window(log_cmd, adv, NO_CMD)
    log_commit = shift_window(log_commit, adv, False)
    acks = shift_window(acks, diag(adv), 0)

    new_state = dict(
        log_cmd=log_cmd, log_commit=log_commit, base=new_base, acks=acks,
        next_slot=next_slot, execute=new_execute, kv=kv, stuck=stuck,
    )
    outbox = {"p2a": out_p2a, "p2b": out_p2b, "p3": out_p3}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    """Committed slots summed over all partitions (most advanced copy)."""
    return {
        "committed_slots": i32sum(torch.amax(state["execute"], dim=0)),
        "min_execute": i32sum(torch.amin(torch.amin(state["execute"],
                                                     dim=0), dim=0)),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Agreement on committed commands a (partition, slot) on the
    aligned common window; 2. stability while ring-resident, only executed
    slots recycled; 3. executed prefix committed.  Each group's
    violations, ``(G,)`` int32."""
    BIG = 2 ** 30
    S = cfg.n_slots
    sidx = iota(S, new["base"].device)
    base, c, cmd = new["base"], new["log_commit"], new["log_cmd"]

    align = torch.amax(base, dim=0)[None] - base    # (rep, part, G)
    a_c = shift_window(c, align, False)
    a_cmd = shift_window(cmd, align, NO_CMD)
    mx = torch.amax(torch.where(a_c, a_cmd, -BIG), dim=0)   # (part, S, G)
    mn = torch.amin(torch.where(a_c, a_cmd, BIG), dim=0)
    n_c = i32sum(a_c, 0)
    v_agree = group_sum((n_c >= 1) & (mx != mn))

    adv = base - old["base"]
    o_c = shift_window(old["log_commit"], adv, False)
    o_cmd = shift_window(old["log_cmd"], adv, NO_CMD)
    v_stable = group_sum(o_c & (~c | (cmd != o_cmd)))
    v_stable = v_stable + group_sum(new["execute"] < base)

    abs_ = base[:, :, None, :] + sidx[None, None, :, None]
    v_exec = group_sum((abs_ < new["execute"][:, :, None, :]) & ~c)
    return v_agree + v_stable + v_exec


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="kpaxos",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
