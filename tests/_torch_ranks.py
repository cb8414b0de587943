"""Rank functions for ``parallel.launch.spawn`` in the port's tests: each
runs on every rank of a CPU mesh and returns numpy values.  Imports only
torch and the port (the ranks' processes load no JAX)."""

from __future__ import annotations

import numpy as np
import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.dryrun import dryrun_multichip
from paxi_tpu_torch.ops.exchange import make_remote_lane_shift
from paxi_tpu_torch.parallel import gather_state, make_sharded_run
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig, SimConfig


def sharded_case(mesh, name, cfg_kw, fuzz_kw, n_groups, n_steps, seed):
    """One sharded run, gathered: ``(state, metrics, violations)`` as
    numpy."""
    run = make_sharded_run(sim_protocol(name), SimConfig(**cfg_kw),
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


def all_cases(mesh, cases, shift_shapes):
    """Every sharded case, the dry run, and the shift's plain version on
    every shape: the whole test file's rank work in one spawn."""
    out = {"cases": {label: sharded_case(mesh, *case)
                     for label, case in cases.items()},
           "dryrun": dryrun_multichip(mesh, verbose=False),
           "shift": {}}
    shift = make_remote_lane_shift(mesh)
    for shape in shift_shapes:
        for x in shift_inputs(mesh.rank, shape):
            got = shift(torch.from_numpy(x))
            out["shift"][(shape, str(x.dtype))] = (x, got.numpy())
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
