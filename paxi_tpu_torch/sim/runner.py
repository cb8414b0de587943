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

import numpy as np
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
    # per-step counter time series ({name: (T,) int32}, prefix stripped),
    # only when ``simulate(..., series=True)`` asked for it
    counter_series: Optional[Dict[str, torch.Tensor]] = None

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

    def latency_snapshot(self, step_seconds: float = 1.0,
                         name: str = "paxi_sim_commit_latency_seconds",
                         **labels: str) -> Optional[Dict[str, Any]]:
        """The histogram in the host registry's snapshot format
        (``lathist.to_host_snapshot``), or None when uninstrumented."""
        hist = self.latency_hist
        if hist is None:
            return None
        snap = lathist.to_host_snapshot(
            hist, int(self.metrics.get("commit_lat_sum", 0)),
            step_seconds=step_seconds)
        return {"name": name, "labels": dict(labels), **snap}


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


def _put_group(x: torch.Tensor, g: int, rec: torch.Tensor) -> torch.Tensor:
    """A copy of the lane-major plane ``x`` with group ``g`` set to
    ``rec`` (never a write into ``x``: it may be the carry's own)."""
    out = x.clone()
    out[..., g] = rec
    return out


def _group_step(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
                carry, t: int, sched_t=None, pin_on: Optional[int] = None,
                record: bool = False):
    """One lock-step round: deliver -> step -> refresh faults -> draw
    faults -> count -> insert -> check invariants.

    Trace hooks (``paxi_tpu_torch.trace``):
    - ``sched_t``: this step's recorded single-group schedule (``{"conn",
      "crashed", "faults"}``); group ``pin_on`` takes it in place of its
      drawn schedule, after the draws (the PRNG chain is split the same
      way, so a replay whose record equals the draw is the original run
      bit for bit), and the violations are that group's only, ``(1,)``.
    - ``record=True``: also return the effective-event schedule of every
      group and each group's violations ``(G,)``."""
    state, wheel, fs, rng = carry
    rng, k_step, k_fault, k_ins = tr.split(rng, 4)
    inbox, wheel = ops.wheel_deliver(wheel)
    new_state, outbox = proto.step(state, inbox, StepCtx(k_step, t, cfg))
    fs = lanes.fault_state_refresh(fs, k_fault, t, fuzz, cfg.n_replicas)
    faults = mb.draw_edge_faults(k_ins, outbox, fuzz)
    if sched_t is not None:
        g = pin_on
        fs = dict(fs, conn=_put_group(fs["conn"], g, sched_t["conn"]),
                  crashed=_put_group(fs["crashed"], g, sched_t["crashed"]))
        faults = {name: {k: _put_group(v, g, sched_t["faults"][name][k])
                         for k, v in f.items()}
                  for name, f in faults.items()}
    # counted before the insert, so the pre-insert wheel exposes delay
    # collisions; a one-slot wheel cannot collide and is not read
    wheel_valid = ({n: b.planes[:, 0] != 0 for n, b in wheel.items()}
                   if fuzz.wheel > 1 else None)
    counts = step_counts(inbox, outbox, faults, fs, cfg.n_replicas,
                         wheel_valid=wheel_valid)
    wheel = ops.wheel_insert(wheel, outbox, fs, faults)
    if pin_on is not None:
        def one(x):
            return x[..., pin_on:pin_on + 1]
        viol = proto.group_invariants(
            {k: one(v) for k, v in state.items()},
            {k: one(v) for k, v in new_state.items()}, cfg)
    elif record:
        viol = per_group_invariants(proto, cfg, state, new_state)
    else:
        viol = proto.invariants(state, new_state, cfg)
    new_carry = (new_state, wheel, fs, rng)
    if record:
        # only EFFECTIVE events: a drop/dup/delay on an edge the insert
        # masks anyway (no send, self-edge, cut, crashed end) is a no-op,
        # so neutralizing it keeps replay exact and the schedule sparse
        live = mb.live_mask(fs, cfg.n_replicas)
        rec_faults = {}
        for name, f in faults.items():
            sent = outbox[name]["valid"] & live
            rec_faults[name] = {"drop": f["drop"] & sent,
                                "delay": torch.where(sent, f["delay"], 1),
                                "dup": f["dup"] & sent}
        sched = {"conn": fs["conn"], "crashed": fs["crashed"],
                 "faults": rec_faults}
        return new_carry, (viol, counts, sched)
    return new_carry, (viol, counts)


def per_group_invariants(proto: SimProtocol, cfg: SimConfig, old, new):
    """Each group's invariant violations, ``(G,)`` int32, in one pass over
    the lane-major planes (the protocol's ``group_invariants``)."""
    if proto.group_invariants is None:
        raise NotImplementedError(
            f"{proto.name}: no per-group invariants")
    return proto.group_invariants(old, new, cfg)


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

    def body(carry, t: int):
        carry, ys = _group_step(proto, cfg, fuzz, carry, t)
        return flush_measurements(proto, cfg, carry, t), ys

    return body


def _zero_counts(device) -> Dict[str, torch.Tensor]:
    return {NET_PREFIX + k: torch.zeros((), dtype=torch.int32, device=device)
            for k in COUNTER_NAMES}


def run_steps(body, carry, n_steps: int, t0: int = 0,
              series: bool = False):
    """Rounds ``t0 .. t0 + n_steps - 1`` of ``body`` with no host sync:
    ``(carry, violations, net_* counters, series)``, the sums int32 on the
    carry's device; ``series`` is the per-step counters ``{name: (T,)}``
    when asked for, else None."""
    viols = torch.zeros((), dtype=torch.int32, device=carry[-1].device)
    counts = _zero_counts(viols.device)
    steps = {k: [] for k in counts} if series else None
    for t in range(t0, t0 + n_steps):
        carry, (viol, c) = body(carry, t)
        viols = viols + viol
        counts = {k: v + c[k] for k, v in counts.items()}
        if series:
            for k in steps:
                steps[k].append(c[k])
    if series:
        steps = {k: (torch.stack(v) if v else torch.zeros(
            (0,), dtype=torch.int32, device=viols.device))
            for k, v in steps.items()}
    return carry, viols, counts, steps


def finish_run(proto: SimProtocol, cfg: SimConfig, carry, viols, counts):
    """Protocol metrics plus the accumulated ``net_*`` counters; the final
    state moves its group axis to the front (the public layout)."""
    state = carry[0]
    metrics = {**proto.metrics(state, cfg), **counts}
    state = {k: torch.movedim(v, -1, 0) for k, v in state.items()}
    return state, metrics, viols


def make_run(proto: SimProtocol, cfg: SimConfig,
             fuzz: FuzzConfig = FAULT_FREE, series: bool = False,
             device=None):
    """Build ``run(rng, n_groups, n_steps) -> (state, metrics,
    violations)`` on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``rng`` is a key from ``paxi_tpu_torch.random.PRNGKey``.
    ``series=True`` adds the per-step ``net_*`` counters ``{name: (T,)}``
    as a fourth output."""
    dev = resolve_device(device)
    body = make_scan_body(proto, cfg, fuzz)

    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        with torch.inference_mode():
            carry = init_carry(proto, cfg, fuzz, n_groups, rng, dev)
            carry, viols, counts, steps = run_steps(body, carry, n_steps,
                                                    series=series)
            out = finish_run(proto, cfg, carry, viols, counts)
            return (*out, steps) if series else out

    return run


def _record_into(bufs, sched, t: int, n_steps: int):
    """Write step ``t``'s schedule tree into the ``(T, ...)`` buffers,
    made at the first step on the schedule's device."""
    if isinstance(sched, dict):
        if bufs is None:
            bufs = {}
        for k, v in sched.items():
            bufs[k] = _record_into(bufs.get(k), v, t, n_steps)
        return bufs
    if bufs is None:
        bufs = torch.empty((n_steps,) + tuple(sched.shape),
                           dtype=sched.dtype, device=sched.device)
    bufs[t].copy_(sched)
    return bufs


def make_recorded_run(proto: SimProtocol, cfg: SimConfig,
                      fuzz: FuzzConfig = FAULT_FREE, device=None):
    """Build the capture-mode runner: ``run(rng, n_groups, n_steps) ->
    (state, metrics, violations, viol_steps, sched)``, where
    ``viol_steps`` is the ``(T, G)`` int32 matrix of each group's
    violations a step and ``sched`` the effective fault schedule of every
    group and step (``conn (T, R, R, G)``, ``crashed (T, R, G)``, per
    message type ``drop``/``delay``/``dup (T, R, R, G)``), kept on the run's
    device (2,520 bytes a group-step for 9 replicas and 5 message types).
    The PRNG chain is make_run's, so the record is what a plain run
    draws."""
    _require_lane_major(proto)
    dev = resolve_device(device)

    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        with torch.inference_mode():
            carry = init_carry(proto, cfg, fuzz, n_groups, rng, dev)
            counts = _zero_counts(dev)
            viol_steps = torch.zeros((n_steps, n_groups), dtype=torch.int32,
                                     device=dev)
            bufs = None
            for t in range(n_steps):
                carry, (viol, c, sched) = _group_step(proto, cfg, fuzz,
                                                      carry, t, record=True)
                carry = flush_measurements(proto, cfg, carry, t)
                viol_steps[t] = viol
                counts = {k: v + c[k] for k, v in counts.items()}
                bufs = _record_into(bufs, sched, t, n_steps)
            total = torch.sum(viol_steps, dtype=torch.int32)
            state, metrics, total = finish_run(proto, cfg, carry, total,
                                               counts)
            return state, metrics, total, viol_steps, bufs

    return run


def _sched_to(tree, device):
    """A schedule tree of numpy arrays or tensors, on ``device``."""
    if isinstance(tree, dict):
        return {k: _sched_to(v, device) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree, copy=True))
    return tree.to(device)


def _tree_at(tree, t: int):
    if isinstance(tree, dict):
        return {k: _tree_at(v, t) for k, v in tree.items()}
    return tree[t]


def make_pinned_run(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
                    group: int, device=None):
    """Build the replay-mode runner: ``run(rng, n_groups, sched) ->
    (state, metrics, violations, viol_steps)``.  ``sched`` is a
    time-stacked single-group schedule (a trace's planes); group ``group``
    takes it in place of its draws while the other groups keep theirs
    (they pin the traced group's workload: with the original seed and
    geometry they reproduce the captured run).  The violations are the
    traced group's, ``viol_steps`` ``(T,)``; the schedule's length sets
    the number of steps."""
    _require_lane_major(proto)
    dev = resolve_device(device)

    def run(rng: torch.Tensor, n_groups: int, sched):
        if not 0 <= group < n_groups:
            raise ValueError(f"group {group} outside 0..{n_groups - 1}")
        with torch.inference_mode():
            sched = _sched_to(sched, dev)
            n_steps = int(sched["crashed"].shape[0])
            carry = init_carry(proto, cfg, fuzz, n_groups, rng, dev)
            counts = _zero_counts(dev)
            viols = []
            for t in range(n_steps):
                carry, (viol, c) = _group_step(
                    proto, cfg, fuzz, carry, t, sched_t=_tree_at(sched, t),
                    pin_on=group)
                carry = flush_measurements(proto, cfg, carry, t)
                viols.append(viol)
                counts = {k: v + c[k] for k, v in counts.items()}
            viol_steps = (torch.cat(viols) if viols else
                          torch.zeros((0,), dtype=torch.int32, device=dev))
            total = torch.sum(viol_steps, dtype=torch.int32)
            state, metrics, total = finish_run(proto, cfg, carry, total,
                                               counts)
            return state, metrics, total, viol_steps

    return run


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def simulate(proto: SimProtocol, cfg: SimConfig, n_groups: int,
             n_steps: int, fuzz: FuzzConfig = FAULT_FREE, seed: int = 0,
             device=None, series: bool = False) -> SimResult:
    """One-shot run from ``seed``; waits for the device to finish.
    ``series=True`` also keeps the per-step counters
    (``SimResult.counter_series``)."""
    run = make_run(proto, cfg, fuzz, series=series, device=device)
    out = run(tr.PRNGKey(seed), n_groups, n_steps)
    state, metrics, viols = out[:3]
    _sync(viols)
    return SimResult(state=state, metrics=metrics, violations=viols,
                     steps=n_steps, groups=n_groups,
                     counter_series=counters_of(out[3]) if series else None)


def _leaves(carry):
    state, wheel, fs, key = carry
    return ([state[k] for k in sorted(state)]
            + [wheel[k].planes for k in sorted(wheel)]
            + [fs[k] for k in sorted(fs)] + [key])


def continue_run(proto: SimProtocol, cfg: SimConfig, carry, t0: int,
                 n_steps: int, fuzz: FuzzConfig = FAULT_FREE):
    """Advance ``carry`` (from ``init_carry`` or ``checkpoint.load_carry``)
    by ``n_steps`` rounds from the absolute step ``t0``, in place: its
    tensors hold the advanced carry afterwards.  A run split this way
    equals the straight run bit for bit.  Returns ``(SimResult, carry)``;
    the result's ``net_*`` counters are this call's steps only, its state
    a copy in the public group-leading layout."""
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        new, viols, counts, _ = run_steps(body, carry, n_steps, t0=t0)
        state, metrics, viols = finish_run(proto, cfg, new, viols, counts)
        state = {k: v.clone() for k, v in state.items()}
        dst, src = _leaves(carry), _leaves(new)
        # a plane the step passed through unchanged is its own source; one
        # that shares memory with another destination is copied out first
        ptrs = {d.untyped_storage().data_ptr() for d in dst}
        src = [s if s is d or s.untyped_storage().data_ptr() not in ptrs
               else s.clone() for d, s in zip(dst, src)]
        for d, s in zip(dst, src):
            if s is not d:
                d.copy_(s)
    _sync(viols)
    n_groups = int(carry[-2]["crashed"].shape[-1])
    return SimResult(state=state, metrics=metrics, violations=viols,
                     steps=n_steps, groups=n_groups), carry
