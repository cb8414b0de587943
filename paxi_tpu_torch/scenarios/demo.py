"""``relay_churn``: the scenario engine's seeded CHURN-SENSITIVE kernel
(torch twin of the JAX package's ``scenarios/demo.py``).

A sequence relay with leader takeover, and two deliberate bugs that ONLY
leader churn exposes:

- the broadcaster keeps incrementing its own sequence counter while
  comms-dead, so a revived leader resumes ABOVE what receivers saw;
- a takeover replica's FIRST broadcast skips one sequence number.

Replica 0 broadcasts an increasing sequence every step; receivers apply in
order and count a violation on any gap (``v > last + 1``).  A replica
r > 0 takes over when it has heard nothing for ``election_timeout * r``
steps.  Fault-free the run is clean; kill the leader (churn) and the
takeover skip and revival drift fire deterministically.

NOT a real protocol: its violations are the expected output.  A per-group
kernel (``batched=False``), group axis leading, like ``fragile_counter``.
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
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "last": torch.zeros((G, R), **i32),     # highest seq applied
        "silence": torch.zeros((G, R), **i32),  # steps since a seq
        "gaps": torch.zeros((G,), **i32),       # ordering violations
    }


def step(state, inbox, ctx: StepCtx):
    R = ctx.cfg.n_replicas
    last = state["last"]
    ridx = torch.arange(R, dtype=torch.int32, device=last.device)
    m = inbox["seq"]
    v = m["valid"]                                  # (G, src, dst)
    got = torch.any(v, dim=1)                       # (G, dst)
    vmax = torch.amax(torch.where(v, m["v"], 0), dim=1)
    gap = got & (vmax > last + 1)
    gaps = state["gaps"] + torch.sum(gap, dim=1, dtype=torch.int32)
    last = torch.where(got, torch.maximum(last, vmax), last)
    silence = torch.where(got, 0, state["silence"] + 1)

    # rank-staggered takeover: replica r broadcasts while its silence is
    # at/over election_timeout * r; the FIRST takeover broadcast (silence
    # exactly at threshold) skips one sequence number
    thr = ctx.cfg.election_timeout * ridx
    bcast = silence >= thr
    skip = (ridx > 0) & (silence == thr)
    new_last = torch.where(bcast, last + 1 + skip.to(torch.int32), last)
    G = last.shape[0]
    out = {"seq": {
        "valid": bcast[:, :, None].expand(G, R, R),
        "v": new_last[:, :, None].expand(G, R, R),
    }}
    return {"last": new_last, "silence": silence, "gaps": gaps}, out


def metrics(state, cfg: SimConfig):
    """Each group's metrics, ``(G,)`` int32 (the runner sums them)."""
    return {"delivered": torch.sum(state["last"], dim=1, dtype=torch.int32)}


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """Each group's ordering violations this step, ``(G,)`` int32."""
    return (new["gaps"] - old["gaps"]).to(torch.int32)


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="relay_churn",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=False,
)
