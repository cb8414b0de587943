"""Layout-free Multi-Paxos ballot machinery (torch twin of the part of the
JAX package's ``sim/ballot_ring.py`` that the fixed-cell core re-exports).

Conventions:
- ``st`` is the protocol's state dict; these helpers read and write the 13
  standard keys (``KEYS``) and leave every other key untouched.
- Mailbox planes are ``(src, dst, G)``; handlers consume them
  receiver-major via masked selects and reductions over the src axis.
- Every reduction that the reference takes in int32 is taken with
  ``dtype=torch.int32`` here; ``argmax`` returns the first maximum in
  both frameworks.
"""

from __future__ import annotations

import torch

from paxi_tpu_torch import random as tr

NO_CMD = -1    # empty log entry
NOOP = -2      # hole filled by a recovering leader

KEYS = ("ballot", "active", "p1_acks", "base", "log_bal", "log_cmd",
        "log_commit", "log_acks", "proposed", "next_slot", "execute",
        "timer", "stuck")


def ridx(st) -> torch.Tensor:
    R = st["log_bal"].shape[0]
    return torch.arange(R, dtype=torch.int32, device=st["log_bal"].device)


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
