"""Multi-Paxos ballot and sliding-ring machinery (torch twin of the JAX
package's ``sim/ballot_ring.py``).

Two halves.  The layout-free handlers (``own_bal_mask``, ``depose``,
``promise_p1a``, ``tally_p1b``, ``propose_write``, ``election_tick``) serve
both ring contracts; the fixed-cell core (``sim/cell_ring.py``) re-exports
them.  The sliding-window handlers (``adopt_best_acker``,
``merge_acker_logs``, ``accept_p2a``, ``tally_p2b``, ``apply_p3``,
``repropose_target``, ``p3_out``, ``retry_stuck``, ``slide_window``) keep
ring position ``i`` at absolute slot ``base + i`` and realign the ring
with ``ring.shift_window`` whenever ``base`` moves (switchpaxos).

Conventions:
- ``st`` is the protocol's state dict; these helpers read and write the 13
  standard keys (``KEYS``) and leave every other key untouched.
- Mailbox planes are ``(src, dst, G)``; handlers consume them
  receiver-major via masked selects and reductions over the src axis.
- ``extras`` is a dict of additional ``(R, ..., G)`` planes that travel
  with state transfer (election adoption and P3 snapshot catch-up): the
  KV store.
- Every reduction that the reference takes in int32 is taken with
  ``dtype=torch.int32`` here; ``argmax`` and ``argmin`` return the first
  extreme in both frameworks.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.sim.ring import pick_src, shift_row, shift_window
from paxi_tpu_torch.sim.ring import take_replica

NO_CMD = -1    # empty log entry
NOOP = -2      # hole filled by a recovering leader

KEYS = ("ballot", "active", "p1_acks", "base", "log_bal", "log_cmd",
        "log_commit", "log_acks", "proposed", "next_slot", "execute",
        "timer", "stuck")


def ridx(st) -> torch.Tensor:
    R = st["log_bal"].shape[0]
    return torch.arange(R, dtype=torch.int32, device=st["log_bal"].device)


def sidx(st) -> torch.Tensor:
    S = st["log_bal"].shape[1]
    return torch.arange(S, dtype=torch.int32, device=st["log_bal"].device)


def popcount(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """Set bits among the low ``nbits`` of int32 ``x`` (the ack masks hold
    one bit per replica, ``nbits = R <= 31``)."""
    n = torch.zeros_like(x)
    for i in range(nbits):
        n = n + ((x >> i) & 1)
    return n


def argmax_i32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """First-maximum index along ``dim`` as int32 (bool planes count as
    0/1, as ``jnp.argmax`` treats them)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return torch.argmax(x, dim=dim).to(torch.int32)


def own_bal_mask(st, stride: int):
    """Replicas whose current ballot is their own (ballot.ID() == me)."""
    return (st["ballot"] > 0) & (torch.remainder(st["ballot"], stride)
                                 == ridx(st)[:, None])


def depose(st, mask, bal):
    """Adopt a higher ballot where ``mask``: raise the promise, drop
    leadership, void any in-flight phase-1 round."""
    return {**st,
            "ballot": torch.where(mask, bal, st["ballot"]),
            "active": st["active"] & ~mask,
            "p1_acks": torch.where(mask, 0, st["p1_acks"])}


def promise_p1a(st, m):
    """P1a handler: promise to the highest proposer; emit P1b to it.
    Returns (st', out_p1b, promote)."""
    R = st["log_bal"].shape[0]
    G = st["ballot"].shape[-1]
    b_in = torch.where(m["valid"], m["bal"], 0)
    p1a_bal = torch.amax(b_in, dim=0)                    # (dst, G)
    p1a_src = argmax_i32(b_in, 0)
    promote = p1a_bal > st["ballot"]
    st = depose(st, promote, p1a_bal)
    out_p1b = {
        "valid": promote[:, None, :] & (ridx(st)[None, :, None]
                                        == p1a_src[:, None, :]),
        "bal": st["ballot"][:, None, :].expand(R, R, G),
    }
    return st, out_p1b, promote


def tally_p1b(st, m, majority: int, stride: int):
    """P1b handler: collect phase-1 acks into the bit-packed mask.
    Returns (st', p1_win, amask) where amask[ldr, s, g] marks s as an
    acker of ldr's round (self included)."""
    R = st["log_bal"].shape[0]
    r = ridx(st)
    src_bit = (torch.ones_like(r) << r)[:, None, None]
    ob = own_bal_mask(st, stride)
    cond = m["valid"] & (m["bal"] == st["ballot"][None, :, :]) \
        & ob[None, :, :]                                 # (src, ldr, G)
    p1_acks = st["p1_acks"] | torch.sum(torch.where(cond, src_bit, 0),
                                        dim=0, dtype=torch.int32)
    p1_win = ob & ~st["active"] & (popcount(p1_acks, R) >= majority)
    amask = ((p1_acks[:, None, :] >> r[None, :, None]) & 1).to(torch.bool)
    return {**st, "p1_acks": p1_acks}, p1_win, amask


def propose_write(st, do, is_new, prop_cmd, prop_slot, oh_p):
    """Apply a proposal to the leader's own log and emit P2a.
    Returns (st', out_p2a)."""
    R = st["log_bal"].shape[0]
    G = st["ballot"].shape[-1]
    r = ridx(st)
    self_bit3 = (torch.ones_like(r) << r)[:, None, None]
    oh = do[:, None, :] & oh_p
    out_p2a = {
        "valid": do[:, None, :].expand(R, R, G),
        "bal": st["ballot"][:, None, :].expand(R, R, G),
        "slot": prop_slot[:, None, :].expand(R, R, G),
        "cmd": prop_cmd[:, None, :].expand(R, R, G),
    }
    return {**st,
            "log_bal": torch.where(oh, st["ballot"][:, None, :],
                                   st["log_bal"]),
            "log_cmd": torch.where(oh & ~st["log_commit"],
                                   prop_cmd[:, None, :], st["log_cmd"]),
            "proposed": st["proposed"] | oh,
            "log_acks": st["log_acks"] | torch.where(oh, self_bit3, 0),
            "next_slot": st["next_slot"] + (is_new & do).to(torch.int32)
            }, out_p2a


def election_tick(st, heard, rng, cfg):
    """Election timer with jittered backoff: fire a fresh higher ballot
    (P1a) when nothing leader-ish has been heard.  Draws
    ``fold_in(rng, 17)`` then ``randint`` every step, as the reference
    does.  Returns (st', out_p1a)."""
    R = st["log_bal"].shape[0]
    G = st["ballot"].shape[-1]
    r = ridx(st)
    self_bit2 = (torch.ones_like(r) << r)[:, None]
    k_jit = tr.fold_in(rng, 17)
    jitter = tr.randint(k_jit, tuple(st["ballot"].shape), 0,
                        cfg.backoff + 1)
    timer = torch.where(heard | st["active"],
                        cfg.election_timeout + jitter,
                        st["timer"] - 1)
    fire = ~st["active"] & (timer <= 0)
    new_bal = (torch.div(torch.amax(st["ballot"], dim=0)[None, :],
                         cfg.ballot_stride, rounding_mode="floor")
               + 1) * cfg.ballot_stride + r[:, None]
    ballot = torch.where(fire, new_bal, st["ballot"])
    out_p1a = {
        "valid": fire[:, None, :].expand(R, R, G),
        "bal": ballot[:, None, :].expand(R, R, G),
    }
    return {**st, "ballot": ballot,
            "p1_acks": torch.where(fire, self_bit2, st["p1_acks"]),
            "timer": torch.where(fire, cfg.election_timeout + jitter,
                                 timer)}, out_p1a


# ---- the sliding-window half: ring position i holds slot base + i --------

def _lead(mask, v):
    """``mask (R, G)`` reshaped to broadcast against ``v (R, ..., G)``."""
    return mask.reshape((mask.shape[0],) + (1,) * (v.ndim - 2)
                        + (mask.shape[-1],))


def _shift_logs(st, adv):
    """The five ring planes shifted forward by ``adv (R, G)``."""
    return {"log_bal": shift_window(st["log_bal"], adv, 0),
            "log_cmd": shift_window(st["log_cmd"], adv, NO_CMD),
            "log_commit": shift_window(st["log_commit"], adv, False),
            "proposed": shift_window(st["proposed"], adv, False),
            "log_acks": shift_window(st["log_acks"], adv, 0)}


def adopt_best_acker(st, amask, p1_win, extras):
    """Phase-1 win, step 1: a laggard winner adopts the most advanced
    acker's (extras, execute, base) by reference.  Returns (st',
    extras')."""
    el_exec = torch.where(amask, st["execute"][None, :, :], -1)
    f_src = argmax_i32(el_exec, 1)
    front = torch.amax(el_exec, dim=1)
    el_ad = p1_win & (front > st["execute"])
    ex = {k: torch.where(_lead(el_ad, v), take_replica(v, f_src), v)
          for k, v in extras.items()}
    execute = torch.where(el_ad, front, st["execute"])
    next_slot = torch.where(el_ad, torch.maximum(st["next_slot"], front),
                            st["next_slot"])
    # never adopt a LOWER base: a negative self-shift would drop my own
    # top-of-window entries (possibly committed via P3)
    f_base = take_replica(st["base"], f_src)
    adv_el = torch.where(el_ad, torch.clamp(f_base - st["base"], min=0), 0)
    base = torch.where(el_ad, torch.maximum(f_base, st["base"]),
                       st["base"])
    st = {**st, "execute": execute, "next_slot": next_slot, "base": base,
          **_shift_logs(st, adv_el)}
    return st, ex


def merge_acker_logs(st, amask, p1_win):
    """Phase-1 win, step 2: merge the ackers' current logs base-aligned —
    per slot adopt any committed value, else the highest-ballot accepted
    value, else NOOP-fill below the frontier; own the window under my
    ballot.  Returns st' (active set for winners)."""
    R = st["log_bal"].shape[0]
    s_i = sidx(st)
    r = ridx(st)
    self_bit3 = (torch.ones_like(r) << r)[:, None, None]
    base = st["base"]
    log_bal, log_cmd = st["log_bal"], st["log_cmd"]
    log_commit, proposed = st["log_commit"], st["proposed"]
    best_bal = torch.full_like(log_bal, -1)
    merged_cmd = torch.full_like(log_cmd, NO_CMD)
    merged_commit = torch.zeros_like(log_commit)
    committed_cmd = torch.full_like(log_cmd, NO_CMD)
    for s in range(R):
        sel_s = amask[:, s, :]                           # (ldr, G)
        adv_s = base - base[s][None, :]
        lb_s = shift_row(log_bal[s], adv_s, -1)
        lc_s = shift_row(log_cmd[s], adv_s, NO_CMD)
        lm_s = shift_row(log_commit[s], adv_s, False)
        lb_s = torch.where(sel_s[:, None, :], lb_s, -1)
        lm_s = lm_s & sel_s[:, None, :]
        upd = lb_s > best_bal
        best_bal = torch.where(upd, lb_s, best_bal)
        merged_cmd = torch.where(upd, lc_s, merged_cmd)
        committed_cmd = torch.where(lm_s & ~merged_commit, lc_s,
                                    committed_cmd)
        merged_commit = merged_commit | lm_s
    abs_ = base[:, None, :] + s_i[None, :, None]
    has_acc = (best_bal > 0) | merged_commit
    top = torch.amax(torch.where(has_acc, abs_ + 1, 0), dim=1)
    new_next = torch.maximum(st["next_slot"], top)
    in_win = abs_ < new_next[:, None, :]
    w = p1_win[:, None, :]
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    return {**st,
            "log_cmd": torch.where(w & in_win, adopt_cmd, log_cmd),
            "log_bal": torch.where(w & in_win, st["ballot"][:, None, :],
                                   log_bal),
            "log_commit": torch.where(w & in_win,
                                      merged_commit | log_commit,
                                      log_commit),
            "proposed": torch.where(w, in_win & (merged_commit | log_commit),
                                    proposed),
            "log_acks": torch.where(w, torch.where(in_win, self_bit3, 0),
                                    st["log_acks"]),
            "next_slot": torch.where(p1_win, new_next, st["next_slot"]),
            "active": st["active"] | p1_win}


def accept_p2a(st, m):
    """P2a handler: accept from the highest-ballot proposer; ack ONLY what
    was durably stored in-window.  Returns (st', out_p2b, acc_ok,
    demote)."""
    R, S = st["log_bal"].shape[0], st["log_bal"].shape[1]
    G = st["ballot"].shape[-1]
    b_in = torch.where(m["valid"], m["bal"], -1)
    a_src = argmax_i32(b_in, 0)
    a_bal = torch.amax(b_in, dim=0)
    a_has = a_bal > 0
    a_slot = pick_src(m["slot"], a_src)                  # absolute
    a_cmd = pick_src(m["cmd"], a_src)
    acc_ok = a_has & (a_bal >= st["ballot"])
    demote = acc_ok & (a_bal > st["ballot"])
    st = depose(st, demote, a_bal)
    a_rel = a_slot - st["base"]
    a_inw = (a_rel >= 0) & (a_rel < S)
    oh = acc_ok[:, None, :] & (sidx(st)[None, :, None] == a_rel[:, None, :])
    writable = oh & (st["log_bal"] <= a_bal[:, None, :]) \
        & ~st["log_commit"]
    out_p2b = {
        "valid": (acc_ok & a_inw)[:, None, :]
        & (ridx(st)[None, :, None] == a_src[:, None, :]),
        "bal": a_bal[:, None, :].expand(R, R, G),
        "slot": a_slot[:, None, :].expand(R, R, G),
    }
    st = {**st,
          "log_bal": torch.where(writable, a_bal[:, None, :],
                                 st["log_bal"]),
          "log_cmd": torch.where(writable, a_cmd[:, None, :],
                                 st["log_cmd"])}
    return st, out_p2b, acc_ok, demote


def tally_p2b(st, m, majority: int, stride: int):
    """P2b handler: the leader tallies acks per slot bitmask and commits at
    majority.  Returns (st', newly)."""
    R = st["log_bal"].shape[0]
    s_i = sidx(st)
    ob = own_bal_mask(st, stride)
    okb = m["valid"] & (m["bal"] == st["ballot"][None, :, :]) \
        & (st["active"] & ob)[None, :, :]
    brel = m["slot"] - st["base"][None, :, :]
    log_acks = st["log_acks"]
    for s in range(R):
        oh_s = okb[s][:, None, :] \
            & (s_i[None, :, None] == brel[s][:, None, :])
        log_acks = log_acks | (oh_s.to(torch.int32) << s)
    acks_n = popcount(log_acks, R)
    newly = ((st["active"] & ob)[:, None, :] & (acks_n >= majority)
             & ~st["log_commit"] & (st["log_cmd"] != NO_CMD)
             & st["proposed"])
    return {**st, "log_acks": log_acks,
            "log_commit": st["log_commit"] | newly}, newly


def apply_p3(st, m, extras):
    """P3 handler: adopt the commit notification, frontier-commit below
    ``upto`` at the sender's exact ballot, and snapshot-adopt (extras,
    execute, base) when my frontier fell below the sender's window.
    Returns (st', extras', c_has, c_bal).

    Two zombie fences, as in the reference: (1) a P3 with a higher ballot
    DEPOSES the receiver; (2) the frontier-commit only fires for ``bal >=
    my promised ballot``."""
    s_i = sidx(st)
    b_in = torch.where(m["valid"], m["bal"], -1)
    c_src = argmax_i32(b_in, 0)
    c_bal = torch.amax(b_in, dim=0)
    c_has = c_bal > 0
    c_slot = pick_src(m["slot"], c_src)
    c_cmd = pick_src(m["cmd"], c_src)
    c_upto = pick_src(m["upto"], c_src)
    fresh3 = c_has & (c_bal >= st["ballot"])             # fence (2)
    promote3 = c_has & (c_bal > st["ballot"])            # fence (1)
    st = depose(st, promote3, c_bal)
    base = st["base"]
    abs_ = base[:, None, :] + s_i[None, :, None]
    c_rel = c_slot - base
    oh = c_has[:, None, :] & (s_i[None, :, None] == c_rel[:, None, :])
    log_cmd = torch.where(oh, c_cmd[:, None, :], st["log_cmd"])
    log_bal = torch.where(oh, torch.maximum(st["log_bal"],
                                            c_bal[:, None, :]),
                          st["log_bal"])
    log_commit = st["log_commit"] | oh
    ohu = (fresh3[:, None, :] & (abs_ < c_upto[:, None, :])
           & (log_bal == c_bal[:, None, :]) & (log_cmd != NO_CMD))
    log_commit = log_commit | ohu

    # snapshot catch-up for deep laggards
    src_base = take_replica(base, c_src)
    adopt = c_has & (st["execute"] < src_base)
    adv_a = torch.where(adopt, src_base - base, 0)
    my_bal = shift_window(log_bal, adv_a, 0)
    my_cmd = shift_window(log_cmd, adv_a, NO_CMD)
    my_com = shift_window(log_commit, adv_a, False)
    s_bal = take_replica(log_bal, c_src)
    s_cmd = take_replica(log_cmd, c_src)
    s_com = take_replica(log_commit, c_src)
    a2 = adopt[:, None, :]
    ex = {k: torch.where(_lead(adopt, v), take_replica(v, c_src), v)
          for k, v in extras.items()}
    execute = torch.where(adopt, take_replica(st["execute"], c_src),
                          st["execute"])
    st = {**st,
          "log_bal": torch.where(a2, torch.where(s_com, s_bal, my_bal),
                                 log_bal),
          "log_cmd": torch.where(a2, torch.where(s_com, s_cmd, my_cmd),
                                 log_cmd),
          "log_commit": torch.where(a2, s_com | my_com, log_commit),
          "proposed": st["proposed"] & ~a2,
          "log_acks": torch.where(a2, 0, st["log_acks"]),
          "execute": execute,
          "next_slot": torch.where(adopt,
                                   torch.maximum(st["next_slot"], execute),
                                   st["next_slot"]),
          "base": torch.where(adopt, src_base, base)}
    return st, ex, c_has, c_bal


def repropose_target(st):
    """Shared proposal targeting: the first unproposed-uncommitted slot
    below next_slot (re-proposal), else the next fresh slot (window flow
    control).  Returns (has_re, can_new, prop_rel, prop_slot, oh_p,
    re_cmd)."""
    S = st["log_bal"].shape[1]
    s_i = sidx(st)
    base, next_slot = st["base"], st["next_slot"]
    abs_ = base[:, None, :] + s_i[None, :, None]
    mask_re = (~st["log_commit"]) & (~st["proposed"]) \
        & (abs_ < next_slot[:, None, :])
    first_re = torch.argmin(torch.where(mask_re, s_i[None, :, None], S),
                            dim=1).to(torch.int32)
    has_re = torch.any(mask_re, dim=1)
    can_new = (next_slot - base) < S
    rel_next = torch.clamp(next_slot - base, 0, S - 1)
    prop_rel = torch.where(has_re, first_re, rel_next)
    oh_p = s_i[None, :, None] == prop_rel[:, None, :]
    re_cmd = torch.sum(torch.where(oh_p, st["log_cmd"], 0), dim=1,
                       dtype=torch.int32)
    re_cmd = torch.where(re_cmd == NO_CMD, NOOP, re_cmd)
    return has_re, can_new, prop_rel, base + prop_rel, oh_p, re_cmd


def p3_out(st, newly, new_execute, is_leader, t: int):
    """Emit P3: the lowest newly committed slot, else round-robin
    retransmit through the committed prefix (laggards behind the window
    heal via snapshot adoption)."""
    R, S = st["log_bal"].shape[0], st["log_bal"].shape[1]
    G = st["ballot"].shape[-1]
    s_i = sidx(st)
    low_new = torch.argmin(torch.where(newly, s_i[None, :, None], S),
                           dim=1).to(torch.int32)
    any_new = torch.any(newly, dim=1)
    span = torch.clamp(new_execute - st["base"], min=1)
    rr = torch.remainder(t, span)
    p3_rel = torch.clamp(torch.where(any_new, low_new, rr), 0, S - 1)
    oh_3 = s_i[None, :, None] == p3_rel[:, None, :]
    p3_committed = torch.any(oh_3 & st["log_commit"], dim=1)
    p3_cmd = torch.sum(torch.where(oh_3, st["log_cmd"], 0), dim=1,
                       dtype=torch.int32)
    p3_do = is_leader & p3_committed
    return {
        "valid": p3_do[:, None, :].expand(R, R, G),
        "bal": st["ballot"][:, None, :].expand(R, R, G),
        "slot": (st["base"] + p3_rel)[:, None, :].expand(R, R, G),
        "cmd": p3_cmd[:, None, :].expand(R, R, G),
        "upto": new_execute[:, None, :].expand(R, R, G),
    }


def retry_stuck(st, new_execute, is_leader, retry_timeout: int):
    """Stuck-frontier retry, go-back-N: on a stall re-open EVERY
    uncommitted in-flight slot so the proposer re-proposes one per
    step."""
    s_i = sidx(st)
    abs_ = st["base"][:, None, :] + s_i[None, :, None]
    stalled = is_leader & (new_execute == st["execute"]) \
        & (st["next_slot"] > new_execute)
    stuck = torch.where(stalled, st["stuck"] + 1, 0)
    retry = stuck >= retry_timeout
    ohr = (retry[:, None, :] & ~st["log_commit"]
           & (abs_ >= new_execute[:, None, :])
           & (abs_ < st["next_slot"][:, None, :]))
    return {**st, "proposed": st["proposed"] & ~ohr,
            "stuck": torch.where(retry, 0, stuck)}


def slide_window(st, new_execute, retain: int):
    """Slide the ring past the executed prefix, retaining ``retain``
    executed slots for P3 retransmits (slot recycling)."""
    new_base = torch.maximum(st["base"], new_execute - retain)
    adv = new_base - st["base"]
    return {**st, "base": new_base, "execute": new_execute,
            **_shift_logs(st, adv)}
