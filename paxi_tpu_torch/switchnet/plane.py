"""Switch-acceptor registers and a NOPaxos-style sequencer as lane-major
carry planes (torch twin of the JAX package's ``switchnet/plane.py``).

A frame "passes through the switch" at the step its outbox is built (the
switch sits mid-fabric, before the delay wheel), and the vote it casts is
visible to the leader at the NEXT step, from the carry: one fabric
delivery where the classic P2a->P2b round trip costs two.

Register-state contract:

- **bounded**: a fixed ``cfg.sw_window`` register file a group —
  ``sw_vbal``/``sw_vcmd``/``sw_reg_seq`` ``(W, G)`` over absolute slots
  ``[sw_base, sw_base + W)`` — plus the scalar promise ``sw_bal`` and the
  sequencer counter ``sw_seq`` ``(G,)``;
- **overflow -> replicas**: a frame whose slot falls outside the file gets
  no vote and no stamp; the leader falls back to the majority-P2b path,
  which always runs underneath;
- **eviction is execution-gated**: ``sw_base`` advances only past
  ``min_r execute``;
- **recovery reads the registers**: a phase-1 winner folds the file into
  its log before the P1b merge (``recovery_fold``);
- **sequencer churn** (``cfg.sw_down_*``, compiled from a scenario's
  ``SwitchChurn`` by ``scenarios.apply_switch``): during a down window the
  switch neither votes nor stamps; each window end bumps the session.

The step index is a Python int here, so ``down_t``/``session_t`` are host
arithmetic (Python's ``%`` and ``//`` floor, as jnp's do on the traced
step) and return a Python bool and int.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.ring import shift_row, shift_window, take_replica
from paxi_tpu_torch.sim.types import SimConfig, resolve_device

NO_CMD = -1   # empty value register (ballot_ring.NO_CMD)
NO_SEQ = -1   # unstamped frame / empty sequence register

# the switch-plane keys a switchnet kernel carries
KEYS = ("sw_bal", "sw_base", "sw_vbal", "sw_vcmd", "sw_reg_seq",
        "sw_seq")


def init_planes(cfg: SimConfig, n_groups: int, device=None):
    """Zeroed switch planes (lane-major, group axis last) on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    if cfg.sw_window > cfg.n_slots:
        raise ValueError(
            f"sw_window={cfg.sw_window} > n_slots={cfg.n_slots}: the "
            "register file must fit the ring for recovery alignment")
    W, G = cfg.sw_window, n_groups
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    return dict(
        sw_bal=torch.zeros((G,), **i32),          # switch ballot promise
        sw_base=torch.zeros((G,), **i32),         # abs slot of register 0
        sw_vbal=torch.zeros((W, G), **i32),       # vote registers: ballot
        sw_vcmd=torch.full((W, G), NO_CMD, **i32),  # vote registers: value
        sw_reg_seq=torch.full((W, G), NO_SEQ, **i32),  # stamp per slot
        sw_seq=torch.zeros((G,), **i32),          # next sequence number
    )


# ---- sequencer-churn schedule (static cfg knobs x step) ------------------

def down_t(cfg: SimConfig, t: int) -> bool:
    """Is the switch down at step ``t`` (``scenarios.schedule``'s
    ``switch_down_at`` on the static ``cfg.sw_down_*`` knobs)."""
    start, period, for_ = (cfg.sw_down_start, cfg.sw_down_period,
                           cfg.sw_down_for)
    if start < 0 or for_ < 1:
        return False
    phase = (t - start) % period if period else (t - start)
    return t >= start and phase < for_


def session_t(cfg: SimConfig, t: int) -> int:
    """The ordered-multicast session epoch at step ``t``
    (``switch_session_at``)."""
    start, period, for_ = (cfg.sw_down_start, cfg.sw_down_period,
                           cfg.sw_down_for)
    if start < 0 or for_ < 1:
        return 0
    ended = t >= start + for_
    if not period:
        return int(ended)
    return 1 + (t - start - for_) // period if ended else 0


def stamp_where(mask: torch.Tensor, value: int) -> torch.Tensor:
    """``value`` where ``mask``, else ``NO_SEQ``, as an int32 plane (a
    where of two scalars would be int64 in torch)."""
    return mask.to(torch.int32) * (value - NO_SEQ) + NO_SEQ


# ---- register-file <-> ring alignment -----------------------------------

def align_to_ring(reg, sw_base, base, n_slots: int, fill):
    """View a ``(W, G)`` register plane through each replica's ring:
    ``out[r, i, g] = reg[i + base[r, g] - sw_base[g], g]`` (``fill``
    outside the file)."""
    W, G = reg.shape
    pad = torch.full((n_slots - W, G), fill, dtype=reg.dtype,
                     device=reg.device)
    row = torch.cat([reg, pad], dim=0)                   # (S, G)
    return shift_row(row, base - sw_base[None, :], fill)


# ---- the switch observing the wire --------------------------------------

def observe_p1a(sw, out_p1a):
    """Phase-1 passes through the fabric: the switch PROMISES to the
    highest ballot it carries (so a deposed leader's later frames get no
    vote).  Promises stay active during down windows."""
    hi = torch.amax(torch.where(out_p1a["valid"], out_p1a["bal"], 0),
                    dim=(0, 1))                          # (G,)
    return dict(sw, sw_bal=torch.maximum(sw["sw_bal"], hi))


def observe_p2a(sw, out_p2a, cfg: SimConfig, t: int):
    """The switch votes on P2a frames in flight and stamps them with the
    ordered-multicast (session, sequence) pair.

    Frames are broadcast-uniform over the dst axis (``propose_write``), so
    the per-src scalars come from dst column 0.  Among simultaneous
    proposers the switch serves the highest ballot >= its promise; a
    re-sent frame (same ballot, slot already registered) keeps its
    ORIGINAL stamp.

    Returns ``(sw', stamp)``: per-src ``sess``/``seq`` planes ``(R, G)``
    (``NO_SEQ`` where unstamped) and the per-group ``voted`` and
    ``overflow`` masks."""
    R = out_p2a["valid"].shape[0]
    W = sw["sw_vbal"].shape[0]
    dev = sw["sw_vbal"].device
    ridx = torch.arange(R, dtype=torch.int32, device=dev)
    widx = torch.arange(W, dtype=torch.int32, device=dev)

    valid = out_p2a["valid"][:, 0, :]                    # (R, G)
    bal = out_p2a["bal"][:, 0, :]
    b_in = torch.where(valid, bal, -1)
    src = argmax_i32(b_in, 0)                            # (G,)
    p_bal = torch.amax(b_in, dim=0)
    p_has = p_bal > 0
    p_slot = take_replica(out_p2a["slot"][:, 0, :], src[None])[0]
    p_cmd = take_replica(out_p2a["cmd"][:, 0, :], src[None])[0]

    active = p_has & (p_bal >= sw["sw_bal"]) & (not down_t(cfg, t))
    rel = p_slot - sw["sw_base"]
    inw = (rel >= 0) & (rel < W)
    overflow = active & ~inw

    oh = (widx[:, None] == rel[None, :]) & (active & inw)[None, :]
    upd = oh & (p_bal[None, :] >= sw["sw_vbal"])
    fresh = upd & ((p_bal[None, :] > sw["sw_vbal"])
                   | (sw["sw_reg_seq"] < 0))
    sw_vbal = torch.where(upd, p_bal[None, :], sw["sw_vbal"])
    sw_vcmd = torch.where(upd, p_cmd[None, :], sw["sw_vcmd"])
    stamp_now = torch.any(fresh, dim=0)                  # (G,)
    sw_reg_seq = torch.where(fresh, sw["sw_seq"][None, :],
                             sw["sw_reg_seq"])
    voted = torch.any(upd, dim=0)                        # (G,)
    frame_seq = torch.sum(torch.where(oh & upd, sw_reg_seq, 0), dim=0,
                          dtype=torch.int32)
    frame_seq = torch.where(voted, frame_seq, NO_SEQ)

    mine = (ridx[:, None] == src[None, :]) & voted[None, :]   # (R, G)
    stamp = {
        "seq": torch.where(mine, frame_seq[None, :], NO_SEQ),
        "sess": stamp_where(mine, session_t(cfg, t)),
        "voted": voted,
        "overflow": overflow,
    }
    sw = dict(sw, sw_bal=torch.where(active,
                                     torch.maximum(sw["sw_bal"], p_bal),
                                     sw["sw_bal"]),
              sw_vbal=sw_vbal, sw_vcmd=sw_vcmd, sw_reg_seq=sw_reg_seq,
              sw_seq=sw["sw_seq"] + stamp_now.to(torch.int32))
    return sw, stamp


# ---- leader-side fast path + recovery -----------------------------------

def fast_commit_mask(sw, st, is_leader, n_slots: int):
    """In-network acceptance: slots whose register holds a vote at MY
    ballot commit now (the vote was cast when the frame passed the switch
    last step).  The value equality guard is belt-and-braces."""
    al_vbal = align_to_ring(sw["sw_vbal"], sw["sw_base"], st["base"],
                            n_slots, 0)
    al_vcmd = align_to_ring(sw["sw_vcmd"], sw["sw_base"], st["base"],
                            n_slots, NO_CMD)
    return (is_leader[:, None, :] & st["proposed"] & ~st["log_commit"]
            & (al_vbal > 0) & (al_vbal == st["ballot"][:, None, :])
            & (al_vcmd == st["log_cmd"]) & (st["log_cmd"] != NO_CMD))


def apply_fast_commits(sw, st, is_leader, n_slots: int):
    """Apply the in-network acceptances to the leader's log.  Returns
    ``(st', newly_fast)``."""
    newly = fast_commit_mask(sw, st, is_leader, n_slots)
    return {**st, "log_commit": st["log_commit"] | newly}, newly


def gap_reopen(st, oh_gr):
    """Gap agreement, leader half for in-flight frames: re-open the
    requested slot for immediate re-proposal (it keeps its original stamp:
    the register remembers) instead of waiting out ``retry_timeout``."""
    return {**st,
            "proposed": st["proposed"] & ~(oh_gr & ~st["log_commit"])}


def noop_commit_holes(st, gap, frame_slot, sidx):
    """THE SEEDED BUG of the ``switchpaxos_nogap`` twin, never called by
    the real protocol: on a detected stamp gap, unilaterally NOOP-commit
    the empty slots below the arriving frame.  The leader commits real
    commands there, so committed values diverge across replicas."""
    NOOP = -2   # ballot_ring.NOOP
    abs_ = st["base"][:, None, :] + sidx[None, :, None]
    hole = (gap[:, None, :] & (abs_ < frame_slot[:, None, :])
            & ~st["log_commit"] & (st["log_cmd"] == NO_CMD)
            & (abs_ >= st["execute"][:, None, :]))
    return {**st,
            "log_cmd": torch.where(hole, NOOP, st["log_cmd"]),
            "log_commit": st["log_commit"] | hole}


def recovery_fold(sw, st, p1_win, n_slots: int):
    """Phase-1 win: fold the register file into the winner's own log
    planes BEFORE the P1b merge, so a value committed via the in-network
    vote alone is visible to the merge at the switch's ballot (the
    {switch} x recovery quorum intersection)."""
    al_vbal = align_to_ring(sw["sw_vbal"], sw["sw_base"], st["base"],
                            n_slots, 0)
    al_vcmd = align_to_ring(sw["sw_vcmd"], sw["sw_base"], st["base"],
                            n_slots, NO_CMD)
    upd = (p1_win[:, None, :] & (al_vbal > st["log_bal"])
           & (al_vbal > 0) & ~st["log_commit"])
    return {**st,
            "log_bal": torch.where(upd, al_vbal, st["log_bal"]),
            "log_cmd": torch.where(upd, al_vcmd, st["log_cmd"])}


def evict(sw, execute):
    """Slide the register file past the slowest replica's execute frontier
    (the execution-gated eviction rule)."""
    min_exec = torch.amin(execute, dim=0)                # (G,)
    adv = torch.clamp(min_exec - sw["sw_base"], min=0)
    return dict(sw, sw_base=sw["sw_base"] + adv,
                sw_vbal=shift_window(sw["sw_vbal"], adv, 0),
                sw_vcmd=shift_window(sw["sw_vcmd"], adv, NO_CMD),
                sw_reg_seq=shift_window(sw["sw_reg_seq"], adv, NO_SEQ))
