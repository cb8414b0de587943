"""``fragile_counter``: a deliberately UNSAFE kernel that seeds violations
for the trace subsystem (torch twin of the JAX package's
``trace/demo.py``).

Replica 0 broadcasts a sequence number each step; receivers require strict
in-order delivery and count a violation whenever a sequence gap slips
through, which any single drop (or reordering delay) of a ``seq`` message
causes.  The minimal witness is ONE fault event.  It is a per-group kernel
(``batched=False``): the group axis LEADS every plane — state ``last (G,
R)``, ``gaps (G,)``, mailbox planes ``(G, src, dst)`` — the layout of the
reference's vmapped state, so it runs through the runner's per-group
branch and ``sim/mailbox_pg.py``'s exchange.

NOT a real protocol: its violations are the expected output.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {"seq": ("v",)}


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """Zeroed per-group state on ``device`` (the card unless ``"cpu"`` is
    asked for); ``rng`` is unused (as in the reference)."""
    del rng
    device = resolve_device(device)
    R, G = cfg.n_replicas, n_groups
    return {
        "last": torch.zeros((G, R), dtype=torch.int32, device=device),
        "gaps": torch.zeros((G,), dtype=torch.int32, device=device),
    }


def step(state, inbox, ctx: StepCtx):
    R = ctx.cfg.n_replicas
    m = inbox["seq"]
    from0 = m["valid"][:, 0]                   # (G, dst): arrivals from 0
    v0 = m["v"][:, 0]
    last = state["last"]
    gap = from0 & (v0 > last + 1)              # a seq number was skipped
    new_last = torch.where(from0, torch.maximum(last, v0), last)
    new_gaps = state["gaps"] + torch.sum(gap, dim=1, dtype=torch.int32)
    G, dev = last.shape[0], last.device
    valid = torch.zeros((G, R, R), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    out = {"seq": {
        "valid": valid,
        "v": torch.full((G, R, R), ctx.t + 1, dtype=torch.int32,
                        device=dev),
    }}
    return {"last": new_last, "gaps": new_gaps}, out


def metrics(state, cfg: SimConfig):
    """Each group's metrics, ``(G,)`` int32 (the runner sums them)."""
    return {"delivered": torch.sum(state["last"], dim=1, dtype=torch.int32)}


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Each group's gaps this step, ``(G,)`` int32."""
    return (new["gaps"] - old["gaps"]).to(torch.int32)


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="fragile_counter",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=False,
)
