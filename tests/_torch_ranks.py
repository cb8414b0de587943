"""Rank functions for ``parallel.launch.spawn`` in the port's tests: each
runs on every rank of a CPU mesh and returns numpy values.  Imports only
torch and the port (the ranks' processes load no JAX)."""

from __future__ import annotations

import numpy as np
import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.dryrun import dryrun_multichip
from paxi_tpu_torch.ops.exchange import make_remote_lane_shift
from paxi_tpu_torch.parallel import (gather_state, make_sharded_pinned_run,
                                     make_sharded_run)
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig, SimConfig
from paxi_tpu_torch.workload import apply_workload, named_workload


def sim_config(cfg_kw, workload=None):
    """The port's SimConfig of ``cfg_kw`` under the named ``workload``."""
    cfg = SimConfig(**cfg_kw)
    return apply_workload(cfg, named_workload(workload)) if workload \
        else cfg


def sharded_case(mesh, name, cfg_kw, fuzz_kw, n_groups, n_steps, seed,
                 workload=None):
    """One sharded run, gathered: ``(state, metrics, violations)`` as
    numpy."""
    run = make_sharded_run(sim_protocol(name), sim_config(cfg_kw, workload),
                           FuzzConfig(**fuzz_kw), mesh)
    state, metrics, viol = run(tr.PRNGKey(seed), n_groups, n_steps)
    whole = gather_state(state, mesh, n_groups)
    return ({k: v.cpu().numpy() for k, v in whole.items()},
            {k: v.cpu().numpy() for k, v in metrics.items()},
            viol.cpu().numpy())


def shift_inputs(rank: int, shape):
    """This rank's int32 and bool inputs of the shift tests, from a seed
    made of the rank and the shape."""
    rng = np.random.default_rng([rank, *shape])
    return (rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int32),
            rng.random(shape) < 0.5)


def state_planes(rank: int):
    """A state's worth of planes of mixed shapes and dtypes, with odd-sized
    bool planes, from a seed made of the rank."""
    rng = np.random.default_rng([rank, 7])
    return [rng.integers(-2 ** 31, 2 ** 31, size=(5, 16, 7), dtype=np.int32),
            rng.random((7,)) < 0.5,
            rng.random((3, 333)) < 0.5,
            rng.integers(0, 256, size=(1,), dtype=np.uint8),
            rng.integers(-2 ** 31, 2 ** 31, size=(4, 5), dtype=np.int32)]


def pinned_case(mesh, name, cfg_kw, fuzz_kw, n_groups, seed, group, sched,
                workload=None):
    """One sharded pinned replay of ``sched`` as group ``group``, gathered:
    ``(state, metrics, violations, viol_steps)`` as numpy."""
    run = make_sharded_pinned_run(sim_protocol(name),
                                  sim_config(cfg_kw, workload),
                                  FuzzConfig(**fuzz_kw), group, mesh)
    state, metrics, total, viols = run(tr.PRNGKey(seed), n_groups, sched)
    whole = gather_state(state, mesh, n_groups)
    return ({k: v.cpu().numpy() for k, v in whole.items()},
            {k: v.cpu().numpy() for k, v in metrics.items()},
            total.cpu().numpy(), viols.cpu().numpy())


def replay_case(mesh, path):
    """``trace.replay(load(path), mesh=mesh)``: (hash, violations,
    viol_steps, metrics, lat_hist)."""
    from paxi_tpu_torch import trace
    r = trace.replay(trace.load(path), mesh=mesh)
    return (r.state_hash, r.violations, r.viol_steps, r.metrics, r.lat_hist)


def all_cases(mesh, cases, shift_shapes, pinned=None, replays=()):
    """Every sharded case, the sharded pinned replays and trace replays,
    the dry run, the shift's plain version on every shape, and
    ``shift.many`` over a state's planes: the whole test file's rank work
    in one spawn."""
    out = {"cases": {label: sharded_case(mesh, *case)
                     for label, case in cases.items()},
           "pinned": {label: pinned_case(mesh, *case)
                      for label, case in (pinned or {}).items()},
           "replays": [replay_case(mesh, p) for p in replays],
           "dryrun": dryrun_multichip(mesh, verbose=False),
           "shift": {}}
    shift = make_remote_lane_shift(mesh)
    for shape in shift_shapes:
        for x in shift_inputs(mesh.rank, shape):
            got = shift(torch.from_numpy(x))
            out["shift"][(shape, str(x.dtype))] = (x, got.numpy())
    planes = state_planes(mesh.rank)
    out["many"] = (planes, [y.numpy() for y in shift.many(
        [torch.from_numpy(x) for x in planes])])
    return out


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 says no")
    return mesh.rank


def shift_ring_on_card(mesh, epochs, shape):
    """``epochs`` ring shifts on the card, each of new data, every one
    held against the plain version: ``([equal per epoch], launches)``."""
    from paxi_tpu_torch.ops import exchange
    shift = make_remote_lane_shift(mesh)
    exchange.reset_launches()
    equal = []
    for e in range(epochs):
        x = torch.from_numpy(
            shift_inputs(mesh.rank * 1000 + e, shape)[0]).to(mesh.device)
        got = shift(x)
        equal.append(bool(torch.equal(
            got, exchange.lane_shift_plain(x, mesh))))
    launches = exchange.make_remote_lane_shift.launches
    shift.close()
    return equal, launches


def shift_many_on_card(mesh, epochs):
    """``epochs`` calls of ``shift.many`` on the card over a state's planes
    (new data each time), held against the plain version plane by plane:
    ``([equal per epoch], launches)``."""
    from paxi_tpu_torch.ops import exchange
    shift = make_remote_lane_shift(mesh)
    exchange.reset_launches()
    equal = []
    for e in range(epochs):
        xs = [torch.from_numpy(x).to(mesh.device)
              for x in state_planes(mesh.rank * 1000 + e)]
        got = shift.many(xs)
        want = [exchange.lane_shift_plain(x, mesh) for x in xs]
        equal.append(all(bool(torch.equal(a, b)) for a, b in zip(got, want)))
    launches = exchange.make_remote_lane_shift.launches
    shift.close()
    return equal, launches


def shift_broken_ring(mesh, timeout_s):
    """Rank 1 leaves the ring after one call: rank 0's next call waits for
    a shard that never comes, times out and raises (at ``check`` and at
    its next call); rank 1 waits at a barrier meanwhile.  Returns the
    messages rank 0 saw (rank 1: [])."""
    import torch.distributed as dist
    shift = make_remote_lane_shift(mesh, timeout_s=timeout_s)
    xs = [torch.arange(24, dtype=torch.int32, device=mesh.device),
          torch.ones(5, dtype=torch.bool, device=mesh.device)]
    shift.many(xs)
    shift.check()
    seen = []
    if mesh.rank == 0:
        shift.many(xs)
        for call in (shift.check, lambda: shift.many(xs)):
            try:
                call()
            except RuntimeError as e:
                seen.append(str(e))
    dist.barrier(group=mesh.group)
    for ch in shift.channels.values():
        ch.close()
    return seen
