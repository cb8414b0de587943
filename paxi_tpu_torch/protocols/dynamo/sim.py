"""Dynamo-style eventual store as a lane-major sim kernel (torch twin of
the JAX package's ``protocols/dynamo/sim.py``).

No consensus: writes stamp Lamport ``(counter, node)`` versions, replicate
best-effort and merge last-writer-wins; anti-entropy gossip heals
divergence.  As in the reference:

- Version planes ``ver_c``/``ver_n`` ``(R, K, G)``; the value is a
  function of the version, so no payload is carried.
- While ``t < n_slots`` every replica writes one hashed key a step, then
  the run switches to pure anti-entropy, gossiping a rotating key.
- The oracle checks what an eventual store promises: version and Lamport
  clock monotonicity and owner ids in range; convergence is a metric.

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import dst_major
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {"gossip": ("key", "c", "n")}


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, K, G = cfg.n_replicas, cfg.n_keys, n_groups
    del rng
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    return dict(
        ver_c=torch.zeros((R, K, G), **i32),
        ver_n=torch.full((R, K, G), -1, **i32),
        clock=torch.zeros((R, G), **i32),
        writes=torch.zeros((G,), **i32),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, K = cfg.n_replicas, cfg.n_keys
    ver_c = state["ver_c"]                              # (R, K, G)
    ver_n = state["ver_n"]
    clock = state["clock"]                              # (R, G)
    G = clock.shape[-1]
    dev = clock.device
    ridx, kidx = iota(R, dev), iota(K, dev)
    RRG = (R, R, G)

    # ---------------- merge incoming gossip (LWW by (c, n)) -------------
    m = inbox["gossip"]
    v = dst_major(m["valid"])                           # (me, src, G)
    g_key = dst_major(m["key"])
    g_c = dst_major(m["c"])
    g_n = dst_major(m["n"])
    oh = v[:, :, None, :] & (g_key[:, :, None, :]
                             == kidx[None, None, :, None])  # (me,src,K,G)
    in_c = torch.amax(torch.where(oh, g_c[:, :, None, :], -1), dim=1)
    rank = g_c[:, :, None, :] * R + torch.clamp(g_n[:, :, None, :], min=0)
    pick = torch.argmax(torch.where(oh, rank, -1), dim=1)   # (me, K, G)
    in_n = torch.zeros_like(in_c)                       # (me, K, G)
    for s in range(R):      # a masked select over the small src axis
        in_n = torch.where(pick == s, g_n[:, s, None, :], in_n)
    has = torch.any(oh, dim=1)
    newer = has & ((in_c > ver_c)
                   | ((in_c == ver_c) & (in_n > ver_n)))
    ver_c = torch.where(newer, in_c, ver_c)
    ver_n = torch.where(newer, in_n, ver_n)
    clock = torch.maximum(clock, torch.amax(ver_c, dim=1))

    # ---------------- a local write while inside the write window -------
    writing = ctx.t < cfg.n_slots
    k_w = tr.fold_in(ctx.rng, 3)
    wkey = fib_key(tr.randint(k_w, (R, G), 0, 1 << 16)
                   + ridx[:, None] * 977, K)            # (R, G)
    clock = clock + int(writing)
    oh_w = (kidx[None, :, None] == wkey[:, None, :]) & writing  # (R, K, G)
    bump = oh_w & ((clock[:, None, :] > ver_c)
                   | ((clock[:, None, :] == ver_c)
                      & (ridx[:, None, None] > ver_n)))
    ver_c = torch.where(bump, clock[:, None, :], ver_c)
    ver_n = torch.where(bump, ridx[:, None, None], ver_n)
    writes = state["writes"] + (R if writing else 0)

    # ---------------- gossip out: the written key, else anti-entropy ----
    gkey = wkey if writing else torch.remainder(
        ctx.t + ridx[:, None], K).expand(R, G).contiguous()   # (R, G)
    goh = kidx[None, :, None] == gkey[:, None, :]       # (R, K, G)
    out_c = i32sum(torch.where(goh, ver_c, 0), 1)     # (R, G)
    out_n = i32sum(torch.where(goh, ver_n, 0), 1)
    out = {
        "valid": torch.ones(RRG, dtype=torch.bool, device=dev),
        "key": gkey[:, None, :].expand(RRG),
        "c": out_c[:, None, :].expand(RRG),
        "n": out_n[:, None, :].expand(RRG),
    }

    new_state = dict(ver_c=ver_c, ver_n=ver_n, clock=clock, writes=writes)
    return new_state, {"gossip": out}


def metrics(state, cfg: SimConfig):
    c, n = state["ver_c"], state["ver_n"]
    same = (torch.all(c == c[:1], dim=0)
            & torch.all(n == n[:1], dim=0))             # (K, G)
    return {
        "converged_keys": i32sum(same),
        "total_keys": torch.tensor(cfg.n_keys * same.shape[-1],
                                   dtype=I32, device=c.device),
        "writes": i32sum(state["writes"]),
        "committed_slots": i32sum(state["writes"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Per-(replica, key) versions never regress (LWW monotonicity);
    2. a replica's Lamport clock bounds every version it stores;
    3. version owner ids stay in range.  Each group's violations,
    ``(G,)`` int32."""
    regress = ((new["ver_c"] < old["ver_c"])
               | ((new["ver_c"] == old["ver_c"])
                  & (new["ver_n"] < old["ver_n"])))
    v1 = group_sum(regress)
    v2 = group_sum(torch.amax(new["ver_c"], dim=1) > new["clock"])
    v3 = group_sum((new["ver_n"] < -1) | (new["ver_n"] >= cfg.n_replicas))
    return v1 + v2 + v3


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="dynamo",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
