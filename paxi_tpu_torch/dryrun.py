"""The multi-chip dry run: the full sharded run over every rank of a mesh
(torch twin of the JAX package's ``__graft_entry__.dryrun_multichip``).

Three lane-major protocols (paxos, wpaxos, sdpaxos), 2 x world groups, 40
steps under ``FuzzConfig(p_drop=0.15, max_delay=2)``, each sharded over the
ranks; per protocol it asserts 0 violations, at least one commit, and that
the summed ``committed_slots`` equals the metric recomputed from the
gathered final state.

    python -m paxi_tpu_torch.dryrun --world 4           # 4 ranks, this host
    python -m paxi_tpu_torch.dryrun --world 4 --device cpu
    torchrun --nproc-per-node 4 -m paxi_tpu_torch.dryrun   # a rank a card

``--world N`` starts the ranks with ``parallel.launch.spawn`` (gloo when
they share one card); under ``torchrun`` each process joins the process
group ``torchrun`` describes (NCCL when every rank has a card).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.parallel.mesh import (Mesh, gather_state, make_mesh,
                                          make_sharded_run)
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim.types import FuzzConfig, SimConfig

FUZZ = FuzzConfig(p_drop=0.15, max_delay=2)
STEPS = 40
CASES = (
    ("paxos", SimConfig(n_replicas=5, n_slots=64)),
    ("wpaxos", SimConfig(n_replicas=6, n_zones=2, n_objects=4, n_slots=16,
                         steal_threshold=3)),
    ("sdpaxos", SimConfig(n_replicas=5, n_slots=16, n_keys=8)),
)


def dryrun_multichip(mesh: Mesh, verbose: bool = True) -> Dict[str, dict]:
    """Run the three sharded cases on every rank of ``mesh``; returns
    ``{protocol: {"metrics": {name: int}, "violations": int}}`` (the
    summed values, the same on every rank)."""
    n_groups = 2 * mesh.world
    out = {}
    for name, cfg in CASES:
        proto = sim_protocol(name)
        run = make_sharded_run(proto, cfg, fuzz=FUZZ, mesh=mesh)
        state, metrics, viol = run(tr.PRNGKey(0), n_groups, STEPS)
        assert int(viol) == 0, \
            f"{name}: invariant violations in dryrun: {int(viol)}"
        # per-shard consistency: the summed metric must equal the same
        # metric recomputed from the gathered (group-major) final state
        whole = gather_state(state, mesh, n_groups)
        lane = {k: torch.movedim(v, 0, -1) for k, v in whole.items()}
        a = int(metrics["committed_slots"])
        b = int(proto.metrics(lane, cfg)["committed_slots"])
        assert a == b, f"{name}: summed metric {a} != gathered {b}"
        assert a > 0, f"{name}: no commits"
        if verbose and mesh.rank == 0:
            print(f"dryrun_multichip({mesh.world}) {name}: ok — "
                  f"committed={a} (summed == gathered) violations=0 "
                  f"fuzz=drop{FUZZ.p_drop}/delay{FUZZ.max_delay}",
                  flush=True)
        out[name] = {"metrics": {k: int(v) for k, v in metrics.items()},
                     "violations": int(viol)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=0,
                    help="start this many local ranks (omit under torchrun)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the ranks on the CPU (default: cards)")
    args = ap.parse_args(argv)
    if args.world:
        from paxi_tpu_torch.parallel.launch import spawn
        spawn(args.world, dryrun_multichip, device=args.device)
        return 0
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        from paxi_tpu_torch.parallel.launch import init_from_env
        mesh = init_from_env(args.device)
        try:
            dryrun_multichip(mesh)
        finally:
            dist.destroy_process_group()
        return 0
    dryrun_multichip(make_mesh(device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
