"""Shard the instance batch over ranks (torch twin of the JAX package's
``parallel/mesh.py``, lane-major branch).

Groups are independent, so the batch shards over ranks with no traffic
between them while it runs: each rank simulates ``n_groups / world``
groups, and only the aggregate metrics and the violation count cross
ranks, summed in int32 once at the end of the run (the reference's
``lax.psum`` over the mesh axis).

PyTorch's idiom replaces the reference's ``shard_map``: one process per
rank, each running the same program (SPMD) on its own device, with an
explicit ``torch.distributed`` process group.  Each rank draws its carry
from ``random.split(rng, world)[rank]`` — the key the reference hands to
the rank's shard — so a sharded run is, shard by shard, the single-device
run of that key and equals the JAX package's sharded run bit for bit.

Group counts need not divide the world: the batch is padded with inert
tail groups to the next multiple.  Their final state is blended back to
the initial state before the metrics, so protocol metrics exclude them;
the ``net_*`` counters and the violation count are whole-shard reductions
inside the step, so pad groups ride along there, as in the reference.

Collectives: NCCL where each rank has its own card; gloo on the CPU and
where several ranks share one card (NCCL refuses two ranks on one
device).  Under gloo a CUDA tensor crosses through the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.collectives import all_gather, all_reduce_sum
from paxi_tpu_torch.sim.runner import (finish_run, init_carry,
                                       make_scan_body, run_steps)
from paxi_tpu_torch.sim.types import (FAULT_FREE, FuzzConfig, SimConfig,
                                      SimProtocol)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the run: its process group (None at world
    1 with no process group), rank, world size and device."""

    group: Optional[object]
    rank: int
    world: int
    device: torch.device


def rank_device(local_rank: int, device=None) -> torch.device:
    """A rank's device: ``device`` where given (a bare ``"cuda"`` is the
    current card), else its own card, ``cuda:<local_rank>`` modulo the
    cards present (``cuda:0`` for every rank where they share one card).
    Without CUDA it raises unless ``device="cpu"`` is asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to shard the run over CPU ranks")
        device = f"cuda:{local_rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(device=None, group=None) -> Mesh:
    """This rank's mesh over ``group`` (default: the initialised default
    process group; world 1 without one), on ``rank_device(LOCAL_RANK,
    device)`` (``LOCAL_RANK`` defaults to the rank)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        rank, world = 0, 1
    else:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    device = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    return Mesh(group=group, rank=rank, world=world, device=device)


def _shard(n_groups: int, world: int):
    """(n_pad, g_local) of a batch of ``n_groups`` over ``world`` ranks."""
    n_pad = (-n_groups) % world
    return n_pad, (n_groups + n_pad) // world


def make_sharded_run(proto: SimProtocol, cfg: SimConfig,
                     fuzz: FuzzConfig = FAULT_FREE,
                     mesh: Optional[Mesh] = None):
    """Build ``run(rng, n_groups, n_steps) -> (state, metrics,
    violations)`` with the group axis sharded over the mesh's ranks; every
    rank calls it.  ``state`` is this rank's final state (group axis
    leading, pad groups trimmed); ``metrics`` and ``violations`` are
    summed over the ranks.  ``n_groups`` may be any positive count (see
    the module docstring for the padding contract)."""
    if not proto.batched:
        raise NotImplementedError(
            f"{proto.name}: sharding a per-group kernel waits for the "
            "per-group layout (the paxos_pg slice)")
    mesh = mesh or make_mesh()
    body = make_scan_body(proto, cfg, fuzz)

    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        n_pad, g_local = _shard(n_groups, mesh.world)
        dev = mesh.device
        with torch.inference_mode():
            key = tr.split(rng.to(dev), mesh.world)[mesh.rank]
            carry = init_carry(proto, cfg, fuzz, g_local, key, dev)
            state0 = {k: v.clone() for k, v in carry[0].items()} \
                if n_pad else None
            carry, viols, counts, _ = run_steps(body, carry, n_steps)
            gidx = mesh.rank * g_local + torch.arange(g_local, device=dev)
            if n_pad:
                # neutralise pad groups before the metrics: their final
                # state is blended back to the (metric-zero) initial state
                real = gidx < n_groups
                carry = ({k: torch.where(real, v, state0[k])
                          for k, v in carry[0].items()},) + carry[1:]
            state, metrics, viols = finish_run(proto, cfg, carry, viols,
                                               counts)
            summed = all_reduce_sum({**metrics, "_violations": viols},
                                    mesh)
            viols = summed.pop("_violations")
            n_real = min(max(n_groups - mesh.rank * g_local, 0), g_local)
            state = {k: v[:n_real] for k, v in state.items()}
        return state, summed, viols

    return run


def gather_state(state: Dict[str, torch.Tensor], mesh: Mesh,
                 n_groups: int) -> Dict[str, torch.Tensor]:
    """The whole batch's state from every rank's ``make_sharded_run``
    state: group axis leading, trimmed to ``n_groups`` (the layout the
    JAX package's sharded run returns).  Every rank calls it and gets
    the whole state."""
    _, g_local = _shard(n_groups, mesh.world)
    out = {}
    for k, v in state.items():
        pad = g_local - v.shape[0]
        if pad:
            v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        out[k] = torch.cat(all_gather(v.contiguous(), mesh))[:n_groups]
    return out


def make_sharded_pinned_run(proto: SimProtocol, cfg: SimConfig,
                            fuzz: FuzzConfig, group: int,
                            mesh: Optional[Mesh] = None):
    """Sharded replay of a captured single-group schedule: per-group
    kernels only, as in the reference."""
    if proto.batched:
        raise NotImplementedError(
            "sharded pinned replay needs per-group PRNG streams; "
            f"lane-major kernel {proto.name!r} draws whole-batch "
            "randomness — replay it with sim/runner.make_pinned_run")
    raise NotImplementedError(
        f"{proto.name}: sharded pinned replay of a per-group kernel waits "
        "for the per-group layout (the paxos_pg slice, ROADMAP.md Queue 1 "
        "item 12)")
