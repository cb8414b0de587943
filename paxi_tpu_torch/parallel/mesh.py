"""Shard the instance batch over ranks (torch twin of the JAX package's
``parallel/mesh.py``).

Groups are independent, so the batch shards over ranks with no traffic
between them while it runs: each rank simulates ``n_groups / world``
groups, and only the aggregate metrics and the violation count cross
ranks, summed in int32 once at the end of the run (the reference's
``lax.psum`` over the mesh axis).

PyTorch's idiom replaces the reference's ``shard_map``: one process per
rank, each running the same program (SPMD) on its own device, with an
explicit ``torch.distributed`` process group.

Lane-major kernels: each rank draws its carry from ``random.split(rng,
world)[rank]`` — the key the reference hands to the rank's shard — so a
sharded run is, shard by shard, the single-device run of that key and
equals the JAX package's sharded run bit for bit.  A workload's draws key
on global group ids, so each rank offsets its ``wl_gid`` plane by its
first group.

Per-group kernels: every group keeps the key it has on one device
(``split(k_run, n_groups)``; pad groups take theirs from ``fold_in(rng,
0x9ad)``, since ``split(k, g_pad)[:G]`` is not ``split(k, G)``), so a
sharded run equals the single-device run bit for bit, and a captured
trace replays inside a sharded batch (``make_sharded_pinned_run``).  Each
rank derives all the keys (cheap) but builds only its slice of the state.

Group counts need not divide the world: the batch is padded with inert
tail groups to the next multiple.  Lane-major: their final state is
blended back to the initial state before the metrics, so protocol metrics
exclude them; the ``net_*`` counters and the violation count are
whole-shard reductions inside the step, so pad groups ride along there,
as in the reference.  Per-group: pad groups are masked out of every sum.

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
from paxi_tpu_torch.sim import mailbox_pg as mbpg
from paxi_tpu_torch.sim.runner import (_sched_to, _tree_at, finish_run,
                                       flush_measurements, init_carry,
                                       make_scan_body, pg_step, run_steps)
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
    mesh = mesh or make_mesh()
    if not proto.batched:
        return _sharded_pg_run(proto, cfg, fuzz, mesh)
    body = make_scan_body(proto, cfg, fuzz)

    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        n_pad, g_local = _shard(n_groups, mesh.world)
        dev = mesh.device
        with torch.inference_mode():
            key = tr.split(rng.to(dev), mesh.world)[mesh.rank]
            carry = init_carry(proto, cfg, fuzz, g_local, key, dev)
            if "wl_gid" in carry[0]:
                # workload draws key on global group ids: offset this
                # rank's by its first group (before the state0 copy, so
                # the pad blend keeps it)
                carry[0]["wl_gid"] = carry[0]["wl_gid"] \
                    + mesh.rank * g_local
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


def _pg_carry(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
              n_groups: int, rng: torch.Tensor, mesh: Mesh):
    """This rank's slice of the padded per-group carry: every group's key
    exactly as one device derives it (``split(k_run, n_groups)``), pad
    groups keyed from ``fold_in(rng, 0x9ad)``; the state, wheel and fault
    state built for the slice alone, ``wl_gid`` holding global ids."""
    n_pad, g_local = _shard(n_groups, mesh.world)
    dev = mesh.device
    rng = rng.to(dev)
    keys = tr.split(tr.split(rng)[1], n_groups)
    if n_pad:
        pad_run = tr.split(tr.fold_in(rng, 0x9ad))[1]
        keys = torch.cat([keys, tr.split(pad_run, n_pad)])
    g0 = mesh.rank * g_local
    state = proto.init_state(cfg, None, g_local, device=dev)
    if "wl_gid" in state:
        state["wl_gid"] = state["wl_gid"] + g0
    spec = proto.mailbox_spec(cfg)
    carry = (state, mbpg.empty_wheel(spec, cfg.n_replicas, g_local, fuzz, dev),
             mbpg.fault_state_init(cfg.n_replicas, g_local, dev),
             keys[g0:g0 + g_local].contiguous())
    gidx = g0 + torch.arange(g_local, device=dev)
    return carry, gidx, gidx < n_groups


def _masked_sum(v: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(real, v, 0), dtype=torch.int32)


def _sharded_pg_run(proto: SimProtocol, cfg: SimConfig, fuzz: FuzzConfig,
                    mesh: Mesh):
    """``make_sharded_run`` for a per-group kernel: each rank steps its
    slice of the single-device batch; pad groups are masked out of the
    violations, the counters and the metrics."""
    def run(rng: torch.Tensor, n_groups: int, n_steps: int):
        with torch.inference_mode():
            carry, _, real = _pg_carry(proto, cfg, fuzz, n_groups, rng,
                                       mesh)
            viols = torch.zeros((), dtype=torch.int32, device=mesh.device)
            counts = None
            for t in range(n_steps):
                carry, (viol, c) = pg_step(proto, cfg, fuzz, carry, t)
                carry = flush_measurements(proto, cfg, carry, t)
                viols = viols + _masked_sum(viol, real)
                c = {k: _masked_sum(v, real) for k, v in c.items()}
                counts = c if counts is None else {
                    k: v + c[k] for k, v in counts.items()}
            state, metrics, viols = finish_run(
                proto, cfg, carry, viols, counts or {}, group_mask=real)
            summed = all_reduce_sum({**metrics, "_violations": viols},
                                    mesh)
            viols = summed.pop("_violations")
            state = {k: v[real] for k, v in state.items()}
        return state, summed, viols

    return run


def make_sharded_pinned_run(proto: SimProtocol, cfg: SimConfig,
                            fuzz: FuzzConfig, group: int,
                            mesh: Optional[Mesh] = None):
    """Sharded twin of ``sim/runner.make_pinned_run``: replay a captured
    single-group schedule inside a batch sharded over the mesh's ranks;
    every rank calls ``run(rng, n_groups, sched) -> (state, metrics,
    violations, viol_steps)``.  Every group, traced and scaffolding alike,
    consumes the key chain of the single-device pinned run, so the replay
    reproduces the captured state hash and ``net_*`` counters.  ``state``
    is this rank's (pad groups trimmed); the metrics, the traced group's
    violations and its ``viol_steps (T,)`` are summed over the ranks.
    Per-group kernels only, as in the reference: lane-major kernels draw
    whole-batch randomness that cannot be re-sliced per rank."""
    if proto.batched:
        raise NotImplementedError(
            "sharded pinned replay needs per-group PRNG streams; "
            f"lane-major kernel {proto.name!r} draws whole-batch "
            "randomness — replay it with sim/runner.make_pinned_run")
    mesh = mesh or make_mesh()

    def run(rng: torch.Tensor, n_groups: int, sched):
        if not 0 <= group < n_groups:
            raise ValueError(f"group {group} outside 0..{n_groups - 1}")
        with torch.inference_mode():
            sched = _sched_to(sched, mesh.device)
            n_steps = int(sched["crashed"].shape[0])
            carry, gidx, real = _pg_carry(proto, cfg, fuzz, n_groups, rng,
                                          mesh)
            on = gidx == group
            local = int(group - gidx[0]) if bool(on.any()) else None
            viol_steps = torch.zeros((n_steps,), dtype=torch.int32,
                                     device=mesh.device)
            counts = None
            for t in range(n_steps):
                carry, (viol, c) = pg_step(proto, cfg, fuzz, carry, t,
                                           sched_t=_tree_at(sched, t),
                                           pin_on=local)
                carry = flush_measurements(proto, cfg, carry, t)
                viol_steps[t] = _masked_sum(viol, on)
                c = {k: _masked_sum(v, real) for k, v in c.items()}
                counts = c if counts is None else {
                    k: v + c[k] for k, v in counts.items()}
            total = torch.sum(viol_steps, dtype=torch.int32)
            state, metrics, total = finish_run(
                proto, cfg, carry, total, counts or {}, group_mask=real)
            summed = all_reduce_sum({**metrics, "_violations": total},
                                    mesh)
            total = summed.pop("_violations")
            viol_steps = all_reduce_sum({"v": viol_steps}, mesh)["v"]
            state = {k: v[real] for k, v in state.items()}
        return state, summed, total, viol_steps

    return run
