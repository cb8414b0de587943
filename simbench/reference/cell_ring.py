"""Shared Multi-Paxos fixed-cell core for lane-major sim kernels (a
frozen copy of the port's ``sim/cell_ring.py``).

Fixed-cell layout (``sim/cell.py``): absolute slot ``a`` lives at cell
``a % S`` forever, so window slides and snapshot adoptions are masked
clears, and the phase-1 log merge is a pure elementwise mask over the
``(ldr, src, S, G)`` ack cube.  The layout-free helpers are re-exported
from ``ballot_ring``.  ``st`` carries the 13 standard keys (``KEYS``);
``extras`` travel with state transfer by reference; mailbox planes are
``(src, dst, G)``.
"""

from __future__ import annotations

import torch

from simbench.reference.ballot_ring import (KEYS, NO_CMD, NOOP,
                                            argmax_i32, depose,
                                            election_tick, own_bal_mask,
                                            popcount, promise_p1a,
                                            propose_write, ridx, tally_p1b)
from simbench.reference.cell import cell_abs, cell_onehot, in_window
from simbench.reference.ring import pick_src, take_replica

__all__ = ["KEYS", "NO_CMD", "NOOP", "depose", "election_tick",
           "own_bal_mask", "promise_p1a", "propose_write", "tally_p1b",
           "adopt_best_acker", "merge_acker_logs", "accept_p2a",
           "tally_p2b", "apply_p3", "repropose_target", "p3_out",
           "retry_stuck", "slide_window"]

BIG = 2 ** 30


def _clear_ring(st, drop):
    """Reset recycled cells in place (the no-copy window move)."""
    return {**st,
            "log_bal": torch.where(drop, 0, st["log_bal"]),
            "log_cmd": torch.where(drop, NO_CMD, st["log_cmd"]),
            "log_commit": st["log_commit"] & ~drop,
            "proposed": st["proposed"] & ~drop,
            "log_acks": torch.where(drop, 0, st["log_acks"])}


def _lane_mask(mask, v):
    """(R, G) mask -> broadcastable against a (R, ..., G) plane."""
    return mask.reshape((mask.shape[0],) + (1,) * (v.ndim - 2)
                        + (mask.shape[-1],))


def adopt_best_acker(st, amask, p1_win, extras):
    """Phase-1 win, step 1: a laggard winner adopts the most advanced
    acker's (extras, execute, base) by reference; raising my base
    recycles the cells that fell below it.  Returns (st', extras')."""
    el_exec = torch.where(amask, st["execute"][None, :, :], -1)
    f_src = argmax_i32(el_exec, 1)
    front = torch.amax(el_exec, dim=1)
    el_ad = p1_win & (front > st["execute"])
    ex = {k: torch.where(_lane_mask(el_ad, v), take_replica(v, f_src), v)
          for k, v in extras.items()}
    execute = torch.where(el_ad, front, st["execute"])
    next_slot = torch.where(el_ad, torch.maximum(st["next_slot"], front),
                            st["next_slot"])
    # never adopt a LOWER base (see the reference)
    f_base = take_replica(st["base"], f_src)
    S = st["log_bal"].shape[1]
    A_old = cell_abs(st["base"], S)
    base = torch.where(el_ad, torch.maximum(f_base, st["base"]),
                       st["base"])
    st = _clear_ring({**st, "execute": execute, "next_slot": next_slot,
                      "base": base}, A_old < base[:, None, :])
    return st, ex


def merge_acker_logs(st, amask, p1_win):
    """Phase-1 win, step 2: merge the ackers' current logs — per slot
    adopt any committed value, else the highest-ballot accepted value,
    else NOOP-fill below the frontier; own the window under my ballot.
    A pure mask over the (ldr, src, S, G) cube.  Returns st'."""
    S = st["log_bal"].shape[1]
    r = ridx(st)
    self_bit3 = (torch.ones_like(r) << r)[:, None, None]
    base = st["base"]
    A = cell_abs(base, S)                                # (ldr, S, G)
    Al = A[:, None]                                      # (ldr, 1, S, G)
    bsrc = base[None, :, None, :]
    in_src = (Al >= bsrc) & (Al < bsrc + S)
    sel = amask[:, :, None, :] & in_src                  # (ldr, src, S, G)
    lb = torch.where(sel, st["log_bal"][None], -1)
    src_best = argmax_i32(lb, 1)                         # first max src
    best_bal = torch.amax(lb, dim=1)                     # (ldr, S, G)
    merged_cmd = torch.gather(st["log_cmd"], 0, src_best.to(torch.int64))
    cmask = sel & st["log_commit"][None]
    merged_commit = torch.any(cmask, dim=1)
    csrc = argmax_i32(cmask, 1)                          # first committed
    committed_cmd = torch.gather(st["log_cmd"], 0, csrc.to(torch.int64))
    has_acc = (best_bal > 0) | merged_commit
    top = torch.amax(torch.where(has_acc, A + 1, 0), dim=1)  # (ldr, G)
    new_next = torch.maximum(st["next_slot"], top)
    in_win = A < new_next[:, None, :]
    w = p1_win[:, None, :]
    adopt_cmd = torch.where(merged_commit, committed_cmd,
                            torch.where(best_bal > 0, merged_cmd, NOOP))
    return {**st,
            "log_cmd": torch.where(w & in_win, adopt_cmd, st["log_cmd"]),
            "log_bal": torch.where(w & in_win, st["ballot"][:, None, :],
                                   st["log_bal"]),
            "log_commit": torch.where(w & in_win,
                                      merged_commit | st["log_commit"],
                                      st["log_commit"]),
            "proposed": torch.where(w, in_win
                                    & (merged_commit | st["log_commit"]),
                                    st["proposed"]),
            "log_acks": torch.where(w, torch.where(in_win, self_bit3, 0),
                                    st["log_acks"]),
            "next_slot": torch.where(p1_win, new_next, st["next_slot"]),
            "active": st["active"] | p1_win}


def accept_p2a(st, m):
    """P2a handler: accept from the highest-ballot proposer; ack ONLY
    what was durably stored in-window.  Returns (st', out_p2b, acc_ok,
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
    a_inw = in_window(a_slot, st["base"], S)
    oh = (acc_ok & a_inw)[:, None, :] & cell_onehot(a_slot, S)
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
    """P2b handler: the leader tallies acks per slot bitmask and commits
    at majority.  Returns (st', newly)."""
    R, S = st["log_bal"].shape[0], st["log_bal"].shape[1]
    ob = own_bal_mask(st, stride)
    okb = m["valid"] & (m["bal"] == st["ballot"][None, :, :]) \
        & (st["active"] & ob)[None, :, :]                # (src, ldr, G)
    base = st["base"]
    log_acks = st["log_acks"]
    for s in range(R):
        ok_s = okb[s] & in_window(m["slot"][s], base, S)
        oh_s = ok_s[:, None, :] & cell_onehot(m["slot"][s], S)
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
    Returns (st', extras', c_has, c_bal)."""
    S = st["log_bal"].shape[1]
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
    A = cell_abs(base, S)
    c_inw = in_window(c_slot, base, S)
    oh = (c_has & c_inw)[:, None, :] & cell_onehot(c_slot, S)
    log_cmd = torch.where(oh, c_cmd[:, None, :], st["log_cmd"])
    log_bal = torch.where(oh, torch.maximum(st["log_bal"],
                                            c_bal[:, None, :]),
                          st["log_bal"])
    log_commit = st["log_commit"] | oh
    ohu = (fresh3[:, None, :] & (A < c_upto[:, None, :])
           & (log_bal == c_bal[:, None, :]) & (log_cmd != NO_CMD))
    log_commit = log_commit | ohu

    # snapshot catch-up for deep laggards
    src_base = take_replica(base, c_src)
    adopt = c_has & (st["execute"] < src_base)
    keep = A >= src_base[:, None, :]     # my cells still in the new window
    my_bal = torch.where(keep, log_bal, 0)
    my_cmd = torch.where(keep, log_cmd, NO_CMD)
    my_com = keep & log_commit
    s_bal = take_replica(log_bal, c_src)
    s_cmd = take_replica(log_cmd, c_src)
    s_com = take_replica(log_commit, c_src)
    a2 = adopt[:, None, :]
    ex = {k: torch.where(_lane_mask(adopt, v), take_replica(v, c_src), v)
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
    """Shared proposal targeting: the lowest unproposed-uncommitted
    absolute slot below next_slot (re-proposal), else the next fresh
    slot (window flow control).  Returns (has_re, can_new, prop_cell,
    prop_slot, oh_p, re_cmd)."""
    S = st["log_bal"].shape[1]
    base, next_slot = st["base"], st["next_slot"]
    A = cell_abs(base, S)
    mask_re = (~st["log_commit"]) & (~st["proposed"]) \
        & (A < next_slot[:, None, :])
    re_abs = torch.amin(torch.where(mask_re, A, BIG), dim=1)
    has_re = torch.any(mask_re, dim=1)
    can_new = (next_slot - base) < S
    prop_slot = torch.where(has_re, re_abs, next_slot)   # absolute
    prop_cell = torch.remainder(prop_slot, S)
    oh_p = cell_onehot(prop_slot, S)
    re_cmd = torch.sum(torch.where(oh_p, st["log_cmd"], 0), dim=1,
                       dtype=torch.int32)
    re_cmd = torch.where(re_cmd == NO_CMD, NOOP, re_cmd)
    return has_re, can_new, prop_cell, prop_slot, oh_p, re_cmd


def p3_out(st, newly, new_execute, is_leader, t: int):
    """Emit P3: the lowest newly committed absolute slot, else
    round-robin retransmit through the committed prefix."""
    R, S = st["log_bal"].shape[0], st["log_bal"].shape[1]
    G = st["ballot"].shape[-1]
    A = cell_abs(st["base"], S)
    low_new = torch.amin(torch.where(newly, A, BIG), dim=1)  # abs
    any_new = torch.any(newly, dim=1)
    span = torch.clamp(new_execute - st["base"], min=1)
    rr = torch.remainder(t, span)
    p3_abs = torch.where(any_new, low_new, st["base"] + rr)
    oh_3 = cell_onehot(p3_abs, S)
    p3_committed = torch.any(oh_3 & st["log_commit"], dim=1)
    p3_cmd = torch.sum(torch.where(oh_3, st["log_cmd"], 0), dim=1,
                       dtype=torch.int32)
    p3_do = is_leader & p3_committed
    return {
        "valid": p3_do[:, None, :].expand(R, R, G),
        "bal": st["ballot"][:, None, :].expand(R, R, G),
        "slot": p3_abs[:, None, :].expand(R, R, G),
        "cmd": p3_cmd[:, None, :].expand(R, R, G),
        "upto": new_execute[:, None, :].expand(R, R, G),
    }


def retry_stuck(st, new_execute, is_leader, retry_timeout: int):
    """Stuck-frontier retry, go-back-N: on a stall re-open EVERY
    uncommitted in-flight slot so the proposer re-proposes one per
    step."""
    S = st["log_bal"].shape[1]
    A = cell_abs(st["base"], S)
    stalled = is_leader & (new_execute == st["execute"]) \
        & (st["next_slot"] > new_execute)
    stuck = torch.where(stalled, st["stuck"] + 1, 0)
    retry = stuck >= retry_timeout
    ohr = (retry[:, None, :] & ~st["log_commit"]
           & (A >= new_execute[:, None, :])
           & (A < st["next_slot"][:, None, :]))
    return {**st, "proposed": st["proposed"] & ~ohr,
            "stuck": torch.where(retry, 0, stuck)}


def slide_window(st, new_execute, retain: int):
    """Slide the window past the executed prefix, retaining ``retain``
    executed slots for P3 retransmits; recycled cells are cleared in
    place."""
    S = st["log_bal"].shape[1]
    new_base = torch.maximum(st["base"], new_execute - retain)
    drop = cell_abs(st["base"], S) < new_base[:, None, :]
    return _clear_ring({**st, "base": new_base, "execute": new_execute},
                       drop)
