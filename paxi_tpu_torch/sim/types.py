"""Static configs and the protocol-plugin interface for the torch sim runtime.

The same surface as the JAX package's ``sim/types.py``: a protocol provides
a mailbox spec (message types and their int32 fields), ``init_state``, a
pure ``step(state, inbox, ctx) -> (state, outbox)`` transition (all
handlers fused and masked), per-step ``invariants`` (the safety oracle) and
``metrics``.  The dataclasses carry the same fields and defaults as the
reference, so a configuration means the same run in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]
Mailboxes = Dict[str, Dict[str, torch.Tensor]]


@dataclass(frozen=True)
class SimConfig:
    """Static per-protocol group geometry (the knobs of the reference's
    config that matter inside the kernel)."""

    n_replicas: int = 3
    n_slots: int = 64          # log window (reference log is unbounded map)
    n_keys: int = 16           # KV key-space inside the sim
    n_zones: int = 1           # zone grid rows (WPaxos); R % zones == 0
    exec_window: int = 4       # max slots executed per replica per step
    ballot_stride: int = 64    # ballot = round*stride + replica_idx
    election_timeout: int = 8  # steps without leader activity before P1a
    backoff: int = 8           # randomized extra timeout (anti-dueling)
    retry_timeout: int = 6     # steps with a stuck frontier before re-propose
    # protocol-specific extras (ignored by protocols that don't use them)
    n_objects: int = 8
    steal_threshold: int = 3
    grid_q2: int = 1
    locality: float = 0.8
    fast_quorum: bool = True
    n_proxies: int = 2
    grid_rows: int = 2
    grid_cols: int = 2
    batch_max: int = 4
    sw_window: int = 16
    sw_down_start: int = -1
    sw_down_period: int = 0
    sw_down_for: int = 0
    # traffic workload spec (``paxi_tpu_torch.workload.Workload``) or None
    workload: Any = None

    @property
    def majority(self) -> int:
        return self.n_replicas // 2 + 1

    @property
    def fast_size(self) -> int:
        return -(-3 * self.n_replicas // 4)  # ceil(3N/4)

    def with_(self, **kw) -> "SimConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class FuzzConfig:
    """Randomized fault schedule applied at the message exchange.
    ``max_delay=1`` and all probabilities 0 => fault-free lock-step."""

    max_delay: int = 1         # messages arrive after 1..max_delay steps
    p_drop: float = 0.0        # per-message drop probability
    p_dup: float = 0.0         # per-message duplication probability
    p_crash: float = 0.0       # per-replica comms-crash prob per window
    p_partition: float = 0.0   # prob a window has a random bipartition
    window: int = 16           # steps between fault-schedule resamples
    perm_crash: int = -1       # replica that goes comms-dead for good
    perm_crash_at: int = 0     # ... from this step on
    # WAN topology / churn scenario (``paxi_tpu_torch.scenarios``)
    scenario: Any = None

    @property
    def wheel(self) -> int:
        d = max(self.max_delay, 1)
        if self.scenario is not None:
            d = max(d, self.scenario.max_latency())
        return d

    @property
    def faulty(self) -> bool:
        return (self.p_drop > 0 or self.p_dup > 0 or self.p_crash > 0
                or self.p_partition > 0 or self.max_delay > 1
                or self.perm_crash >= 0 or self.scenario is not None)


FAULT_FREE = FuzzConfig()


def resolve_device(device=None) -> torch.device:
    """The device a public entry point runs on: ``device`` if given, else
    the card; raises when no device was given and CUDA is absent (no
    silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run the simulation on the CPU")
    return torch.device("cuda")


class StepCtx(NamedTuple):
    """Per-step context handed to protocol transition functions."""

    rng: torch.Tensor  # this step's PRNG key (paxi_tpu_torch.random)
    t: int             # step index
    cfg: SimConfig     # static geometry


@dataclass(frozen=True)
class SimProtocol:
    """A protocol plugin for the torch sim runtime.  Lane-major kernels
    (``batched=True``) carry the group axis LAST on every plane and their
    ``metrics`` sum over it; per-group kernels (``batched=False``, the
    reference's vmapped layout written out) carry it FIRST, take one PRNG
    key a group (``ctx.rng`` is ``(G, 2)``) and return each group's
    metrics ``(G,)``, which the runner sums."""

    name: str
    mailbox_spec: Callable[[SimConfig], Dict[str, Tuple[str, ...]]]
    init_state: Callable[..., State]
    step: Callable[[State, Mailboxes, StepCtx], Tuple[State, Mailboxes]]
    metrics: Callable[[State, SimConfig], Dict[str, torch.Tensor]]
    invariants: Callable[[State, State, SimConfig], torch.Tensor]
    batched: bool = False
    # each group's violations, ``(G,)`` int32, in one pass (the record
    # and pinned runs locate the violating group with it)
    group_invariants: Optional[
        Callable[[State, State, SimConfig], torch.Tensor]] = None
