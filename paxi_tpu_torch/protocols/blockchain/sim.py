"""Longest-chain blockchain as a lane-major sim kernel (torch twin of the
JAX package's ``protocols/blockchain/sim.py``).

The longest-chain contrast case: replicas mine blocks by lottery, extend
the longest chain they know, gossip heads and adopt any longer chain they
hear of; agreement is only eventual.  As in the reference:

- A block id is its hash chain, ``id' = mix(id, miner, height)``, so
  "verify the chain" is "recompute the hash chain", which the oracle does
  over the resident window of the last ``n_slots`` ids and miners.
- Gossip advertises ``(height, id)``; adoption copies the offerer's live
  (height, head, rings) by reference.
- Mining: a lottery a (replica, step) with P(block) = ``1 / (R *
  difficulty)``, ``cfg.steal_threshold`` the difficulty.
- The oracle: height monotone, the window hash-chain consistent, the head
  cell holding the head; convergence is a metric.

``mix`` relies on int32 products wrapping: here they are formed in int64
and wrapped to int32 by hand (``ops/hashing.wrap_int32``).  Every
reduction the reference takes in int32 is taken with ``dtype=torch.int32``
here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.ops.hashing import wrap_int32
from paxi_tpu_torch.sim.ballot_ring import argmax_i32
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import dst_major, take_replica
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

GENESIS = 7
I32 = torch.int32


def mix(pid, miner, height):
    """Deterministic 31-bit block id from (parent id, miner, height): the
    reference's wrapping int32 multiply-adds, formed in int64."""
    h = (wrap_int32(pid.to(torch.int64) * 0x1E3779B1)
         + wrap_int32(miner.to(torch.int64) * 0x05EBCA77)
         + wrap_int32(height.to(torch.int64) * 0x42B2AE35))
    h = wrap_int32(h)
    h = h ^ (h >> 13)
    return ((h & 0x7FFFFFFF) | 1).to(I32)               # never 0


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {"head": ("height", "hid")}


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, S, G = cfg.n_replicas, cfg.n_slots, n_groups
    del rng
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    at0 = (torch.arange(S, device=device) == 0)[None, :, None]
    return dict(
        height=torch.zeros((R, G), **i32),       # my head height (genesis 0)
        head=torch.full((R, G), GENESIS, **i32),  # my head id
        ring=torch.where(at0, GENESIS, torch.zeros((R, S, G), **i32)),
        miner_ring=torch.zeros((R, S, G), **i32),  # miner of each block
        mined=torch.zeros((R, G), **i32),        # blocks I mined
        reorgs=torch.zeros((R, G), **i32),       # adoptions that rewound me
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S = cfg.n_replicas, cfg.n_slots
    height = state["height"]
    head = state["head"]
    ring = state["ring"]
    miner_ring = state["miner_ring"]
    mined = state["mined"]
    G = height.shape[-1]
    dev = height.device
    ridx, sidx = iota(R, dev), iota(S, dev)

    def ring_at(rg, h):
        """rg's value at absolute height h (garbage once h left the
        window; callers mask)."""
        oh = sidx[None, :, None] == torch.remainder(h, S)[:, None, :]
        return i32sum(torch.where(oh, rg, 0), 1)

    # ---------------- fork choice over gossiped advertisements ----------
    m = inbox["head"]
    v = dst_major(m["valid"])                            # (me, src, G)
    gh = torch.where(v, dst_major(m["height"]), -1)
    gid = dst_major(m["hid"])
    best_h = torch.amax(gh, dim=1)                       # (me, G)
    tie = gh == best_h[:, None, :]
    best_id = torch.amin(torch.where(tie & v, gid, 0x7FFFFFFF), dim=1)
    better = (best_h > height) \
        | ((best_h == height) & (best_h >= 0) & (best_id < head))
    pick = argmax_i32(tie & v & (gid == best_id[:, None, :]), 1)
    # adopt the offerer's LIVE chain (by reference): heights are monotone,
    # so its current chain is at least the advertised one
    src_height = take_replica(height, pick)
    src_head = take_replica(head, pick)
    src_ring = take_replica(ring, pick)
    src_miner = take_replica(miner_ring, pick)
    # reorg accounting: the adopted chain's block at MY old height differs
    # from my old head (or my old height already left its window)
    in_win = height > src_height - S
    diverged = better & (~in_win | (ring_at(src_ring, height) != head))
    height_n = torch.where(better, src_height, height)
    head_n = torch.where(better, src_head, head)
    ring = torch.where(better[:, None, :], src_ring, ring)
    miner_ring = torch.where(better[:, None, :], src_miner, miner_ring)
    height, head = height_n, head_n
    reorgs = state["reorgs"] + diverged

    # ---------------- mine: a lottery, extend my chain ------------------
    diff = max(int(cfg.steal_threshold), 1)
    k = tr.fold_in(ctx.rng, 41)
    p = torch.tensor(1.0 / (R * diff), dtype=torch.float32, device=dev)
    win = tr.uniform(k, (R, G)) < p
    new_h = height + 1
    new_id = mix(head, ridx[:, None], new_h)
    oh_n = sidx[None, :, None] == torch.remainder(new_h, S)[:, None, :]
    ring = torch.where(win[:, None, :] & oh_n, new_id[:, None, :], ring)
    miner_ring = torch.where(win[:, None, :] & oh_n,
                             ridx[:, None, None], miner_ring)
    height = torch.where(win, new_h, height)
    head = torch.where(win, new_id, head)
    mined = mined + win

    # ---------------- gossip my head ------------------------------------
    RRG = (R, R, G)
    out_head = {
        "valid": torch.ones(RRG, dtype=torch.bool, device=dev),
        "height": height[:, None, :].expand(RRG),
        "hid": head[:, None, :].expand(RRG),
    }

    new_state = dict(height=height, head=head, ring=ring,
                     miner_ring=miner_ring, mined=mined, reorgs=reorgs)
    return new_state, {"head": out_head}


def metrics(state, cfg: SimConfig):
    h, hd = state["height"], state["head"]
    conv = torch.all(hd == hd[:1], dim=0) & torch.all(h == h[:1], dim=0)
    return {
        "committed_slots": i32sum(torch.amax(h, dim=0)),  # chain growth
        "mined": i32sum(state["mined"]),
        "reorgs": i32sum(state["reorgs"]),
        "converged": i32sum(conv),                        # groups agreed
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Height monotonicity; 2. windowed hash-chain verification: every
    resident (parent, miner, height) recomputes to the stored id; 3. the
    head cell holds the head.  Each group's violations, ``(G,)`` int32."""
    S = cfg.n_slots
    height, head = new["height"], new["head"]
    ring, miner = new["ring"], new["miner_ring"]
    sidx = iota(S, height.device)

    v1 = group_sum(new["height"] < old["height"])

    # the height at ring cell s (the latest cycle at or below my height);
    # check id[h] == mix(id[h-1], miner[h], h) where both are resident
    h_at = height[:, None, :] - torch.remainder(
        height[:, None, :] - sidx[None, :, None], S)     # (R, S, G)
    checkable = (h_at >= 1) & (h_at > height[:, None, :] - S + 1)
    parent = torch.roll(ring, 1, dims=1)   # the parent sits at cell s - 1
    expect = mix(parent, miner, h_at)
    v2 = group_sum(checkable & (ring != expect))

    oh_h = sidx[None, :, None] == torch.remainder(height, S)[:, None, :]
    at_head = i32sum(torch.where(oh_h, ring, 0), 1)
    v3 = group_sum(at_head != head)
    return v1 + v2 + v3


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="blockchain",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
