"""The sim runner: a Python loop over lock-step rounds on one device
(torch twin of the JAX package's ``sim/runner.py``, lane-major branch).

Every step, every group delivers its in-flight messages, applies the
protocol's pure transition, refreshes its fault schedule, draws the
per-edge faults, counts the round, inserts its outbox into the timing
wheel and checks the safety invariants.  ``lax.scan`` becomes a loop that
never syncs with the host: the per-step violations and ``net_*`` counters
accumulate on the device as int32, and the deferred latency flush is a
host-side ``if`` on the step index.

On a CUDA device the exchange runs the hand-written kernels of
``ops/exchange.py``; on the CPU it runs their plain versions.  The entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.metrics.simcount import (COUNTER_NAMES, NET_PREFIX,
                                             counters_of, step_counts)
from paxi_tpu_torch.ops import exchange as ops
from paxi_tpu_torch.sim import lanes
from paxi_tpu_torch.sim import mailbox as mb
from paxi_tpu_torch.sim.types import (FAULT_FREE, FuzzConfig, SimConfig,
                                      SimProtocol, StepCtx, resolve_device)


@dataclass
class SimResult:
    state: Dict[str, torch.Tensor]     # final state, group axis leading
    metrics: Dict[str, torch.Tensor]   # protocol metrics + net_* counters
    violations: torch.Tensor           # total invariant violations (int32)
    steps: int
    groups: int

    @property
    def counters(self) -> Dict[str, torch.Tensor]:
        """The run's message/fault counters, prefix stripped."""
        return counters_of(self.metrics)

    @property
    def latency_hist(self):
        """Whole-batch commit-latency bucket vector ((N_BUCKETS,) int32
        numpy, pending deltas folded in), or None."""
        from paxi_tpu_torch.convert import state_to_numpy
        return lathist.total_hist(state_to_numpy(self.state))

    @property
    def inscan_violations(self) -> Optional[int]:
        v = self.metrics.get("inscan_violations")
        return None if v is None else int(v)

    def latency_summary(self) -> Optional[Dict[str, Any]]:
        """p50/p99/p999 in lock-step rounds plus count, mean and sparse
        buckets (lathist.summarize)."""
        hist = self.latency_hist
        if hist is None:
            return None
        return lathist.summarize(hist,
                                 int(self.metrics.get("commit_lat_sum", 0)))


def _require_lane_major(proto: SimProtocol) -> None:
    if not proto.batched:
        raise NotImplementedError(
            f"{proto.name}: only lane-major kernels are ported")


def init_carry(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
               n_groups: int, rng: torch.Tensor, device):
    """``(state, wheel, fs, key)`` at step 0, on ``device``."""
    _require_lane_major(proto)
    spec = proto.mailbox_spec(cfg)
    k_state, k_run = tr.split(rng.to(device))
    state = proto.init_state(cfg, k_state, n_groups, device=device)
    wheel = lanes.empty_wheel(spec, cfg.n_replicas, n_groups, fuzz, device)
    fs = lanes.fault_state_init(cfg.n_replicas, n_groups, device)
    return (state, wheel, fs, k_run)


def _group_step(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
                carry, t: int):
    """One lock-step round: deliver -> step -> refresh faults -> draw
    faults -> count -> insert -> check invariants."""
    state, wheel, fs, rng = carry
    rng, k_step, k_fault, k_ins = tr.split(rng, 4)
    inbox, wheel = ops.wheel_deliver(wheel)
    new_state, outbox = proto.step(state, inbox, StepCtx(k_step, t, cfg))
    fs = lanes.fault_state_refresh(fs, k_fault, t, fuzz, cfg.n_replicas)
    faults = mb.draw_edge_faults(k_ins, outbox, fuzz)
    # counted before the insert, so the pre-insert wheel exposes delay
    # collisions; a one-slot wheel cannot collide and is not read
    wheel_valid = ({n: b.planes[:, 0] != 0 for n, b in wheel.items()}
                   if fuzz.wheel > 1 else None)
    counts = step_counts(inbox, outbox, faults, fs, cfg.n_replicas,
                         wheel_valid=wheel_valid)
    wheel = ops.wheel_insert(wheel, outbox, fs, faults)
    viol = proto.invariants(state, new_state, cfg)
    return (new_state, wheel, fs, rng), (viol, counts)


def flush_measurements(proto: SimProtocol, cfg: SimConfig, carry, t: int):
    """Deferred commit-latency binning: every ``flush_every(S)`` steps the
    pending ``m_commit_dt`` deltas are binned into ``m_lat_hist``."""
    state = carry[0]
    if "m_commit_dt" not in state:
        return carry
    if (t + 1) % lathist.flush_every(cfg.n_slots) != 0:
        return carry
    return (lathist.flush_pending(state),) + tuple(carry[1:])


def make_scan_body(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig):
    """``body(carry, t) -> (carry, (viol, counts))``: one step plus the
    deferred flush."""
    _require_lane_major(proto)
    mb.require_scenario_free(fuzz)

    def body(carry, t: int):
        carry, ys = _group_step(proto, cfg, fuzz, carry, t)
        return flush_measurements(proto, cfg, carry, t), ys

    return body


def run_steps(body, carry, n_steps: int):
    """``n_steps`` rounds of ``body`` from step 0 with no host sync:
    ``(carry, violations, net_* counters)``, the sums int32 on the
    carry's device."""
    viols = torch.zeros((), dtype=torch.int32, device=carry[-1].device)
    counts = {NET_PREFIX + k: torch.zeros_like(viols) for k in COUNTER_NAMES}
    for t in range(n_steps):
        carry, (viol, c) = body(carry, t)
        viols = viols + viol
        counts = {k: v + c[k] for k, v in counts.items()}
    return carry, viols, counts


def finish_run(proto: SimProtocol, cfg: SimConfig, carry, viols, counts):
    """Protocol metrics plus the accumulated ``net_*`` counters; the final
    state moves its group axis to the front (the public layout)."""
    state = carry[0]
    metrics = {**proto.metrics(state, cfg), **counts}
    state = {k: torch.movedim(v, -1, 0) for k, v in state.items()}
    return state, metrics, viols


def make_run(proto: SimProtocol, cfg: SimConfig,
             fuzz: FuzzConfig = FAULT_FREE, device=None):
    """Build ``run(rng, n_groups, n_steps) -> (state, metrics,
    violations)`` on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``rng`` is a key from ``paxi_tpu_torch.random.PRNGKey``."""
    dev = resolve_device(device)
    body = make_scan_body(proto, cfg, fuzz)

    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        with torch.inference_mode():
            carry = init_carry(proto, cfg, fuzz, n_groups, rng, dev)
            carry, viols, counts = run_steps(body, carry, n_steps)
            return finish_run(proto, cfg, carry, viols, counts)

    return run


def simulate(proto: SimProtocol, cfg: SimConfig, n_groups: int,
             n_steps: int, fuzz: FuzzConfig = FAULT_FREE, seed: int = 0,
             device=None) -> SimResult:
    """One-shot run from ``seed``; waits for the device to finish."""
    run = make_run(proto, cfg, fuzz, device=device)
    state, metrics, viols = run(tr.PRNGKey(seed), n_groups, n_steps)
    if viols.is_cuda:
        torch.cuda.synchronize(viols.device)
    return SimResult(state=state, metrics=metrics, violations=viols,
                     steps=n_steps, groups=n_groups)
