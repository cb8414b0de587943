"""Per-protocol benchmark sweep on the torch sim runtime (the port's twin
of the JAX package's ``bench_all.py``: the same rows and line fields).

    python -m paxi_tpu_torch.bench_all [--out build/BENCH_PROTOCOLS.json]
    python -m paxi_tpu_torch.bench_all --workload \
        [--out build/BENCH_WORKLOAD.json]
    python -m paxi_tpu_torch.bench_all --mesh 4      # four local ranks
    python -m paxi_tpu_torch.bench_all --device cpu

Prints one JSON line a configuration (paxos anchor, epaxos
conflict-heavy, wpaxos 3x3 locality grid, abd, chain, fuzzed paxos,
sdpaxos tokens, wankeeper zones, blockchain forks, bpaxos grid, the wan3z
geo rows and the switchnet pair) and writes the list to ``--out``, never
to the JAX package's root ``BENCH_*.json``.  Each configuration runs once
warm, then is timed on a second run from a cold state, as the reference
does.  On the card (the default) the group counts are the reference's
accelerator shapes (x16); on the CPU its CPU shapes, with the per-group
``paxos_pg`` kernel for the paxos rows.

``--mesh N`` shards every configuration's group batch over N ranks
(``parallel.launch.spawn``: gloo where ranks share a card or run on the
CPU); under ``torchrun`` each process joins the group it describes.

``--workload`` runs the workload x topology matrix instead: {uniform,
zipf99, flash} x {paxos 3-replica, wpaxos 3x3 grid}, the uniform rows the
same-run controls, plus the wpaxos steal contrast line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

from paxi_tpu_torch import random as tr
from paxi_tpu_torch.convert import state_to_numpy
from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.scenarios import compile as scn
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run
from paxi_tpu_torch.sim.types import resolve_device

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FAULT_FREE = FuzzConfig()
FUZZ = FuzzConfig(p_drop=0.1, p_dup=0.05, max_delay=2, p_partition=0.1,
                  window=16)
# the scenario axis: fault-free load inside the wan3z asymmetric WAN
# latency matrix (no drops: the local vs cross-zone split is topology)
GEO_WAN3Z = scn.with_scenario(FAULT_FREE, scn.WAN3Z)


def _big(device) -> bool:
    return resolve_device(device).type != "cpu"


def _cfgs(device=None):
    """(label, protocol, SimConfig, fuzz, groups, steps, metric key,
    unit); the accelerator shapes (x16) unless ``device`` is the CPU."""
    big = _big(device)
    s = 16 if big else 1
    return [
        # 1. classic Multi-Paxos, 3 replicas, closed-loop
        ("paxos_3rep", "paxos" if big else "paxos_pg",
         SimConfig(n_replicas=3, n_slots=64), FAULT_FREE,
         1024 * s, 104, "committed_slots", "slots/s"),
        # 2. epaxos, 5 replicas, conflict-heavy keys (4 keys)
        ("epaxos_conflict", "epaxos",
         SimConfig(n_replicas=5, n_slots=16, n_keys=4), FAULT_FREE,
         64 * s, 60, "executed", "cmds/s"),
        # 3. wpaxos, 3x3 zone grid, locality-skewed workload
        ("wpaxos_3x3_grid", "wpaxos",
         SimConfig(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                   steal_threshold=3, locality=0.8), FAULT_FREE,
         64 * s, 60, "committed_slots", "slots/s"),
        # 4a. abd crash-only linearizable register
        ("abd_register", "abd",
         SimConfig(n_replicas=5, n_keys=16), FAULT_FREE,
         512 * s, 60, "ops_done", "ops/s"),
        # 4b. chain replication throughput baseline
        ("chain_pipeline", "chain",
         SimConfig(n_replicas=3, n_slots=64), FAULT_FREE,
         512 * s, 110, "committed_slots", "slots/s"),
        # 5. fuzzed paxos: drop/dup/delay/partition schedule
        ("paxos_fuzzed", "paxos" if big else "paxos_pg",
         SimConfig(n_replicas=5, n_slots=64), FUZZ,
         256 * s, 150, "committed_slots", "slots/s"),
        # 6. sdpaxos: command leaders + central sequencer
        ("sdpaxos_tokens", "sdpaxos",
         SimConfig(n_replicas=5, n_slots=32, n_keys=16), FAULT_FREE,
         256 * s, 80, "committed_slots", "slots/s"),
        # 7. wankeeper: hierarchical tokens, locality-skewed zones
        ("wankeeper_zones", "wankeeper",
         SimConfig(n_replicas=6, n_zones=2, n_objects=4, n_slots=16,
                   locality=0.8), FAULT_FREE,
         256 * s, 80, "committed_slots", "writes/s"),
        # 8. blockchain: longest-chain fork churn under the fuzz schedule
        ("blockchain_forks", "blockchain",
         SimConfig(n_replicas=5, n_slots=32, steal_threshold=4), FUZZ,
         256 * s, 200, "committed_slots", "blocks/s"),
        # 9. bpaxos: compartmentalized roles with batched accepts
        ("bpaxos_grid", "bpaxos",
         SimConfig(n_replicas=7, n_slots=32), FAULT_FREE,
         256 * s, 104, "committed_cmds", "cmds/s"),
        # 10. scenario axis: zone-local vs cross-zone commit latency
        #     under the wan3z matrix (extra commit_lat_* fields)
        ("wpaxos_wan3z_geo", "wpaxos",
         SimConfig(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                   steal_threshold=3, locality=0.8), GEO_WAN3Z,
         64 * s, 100, "committed_slots", "slots/s"),
        ("wankeeper_wan3z_geo", "wankeeper",
         SimConfig(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                   locality=0.8), GEO_WAN3Z,
         64 * s, 100, "committed_slots", "writes/s"),
        # 11. the in-fabric consensus tier beside the paxos baseline of
        #     the same geometry, shape and scenario: the latency
        #     histograms count the rounds in-network acceptance removes
        ("paxos_wan3z_base", "paxos",
         SimConfig(n_replicas=3, n_slots=32), GEO_WAN3Z,
         64 * s, 100, "committed_slots", "slots/s"),
        ("switchpaxos_wan3z", "switchpaxos",
         SimConfig(n_replicas=3, n_slots=32), GEO_WAN3Z,
         64 * s, 100, "committed_slots", "slots/s"),
    ]


def _wl_cfgs(device=None):
    """The workload matrix: (label, protocol, SimConfig, workload name,
    groups, steps, metric key, unit); each (protocol, topology) pair runs
    its uniform control next to the skewed specs."""
    s = 16 if _big(device) else 1
    # single-zone majority-quorum baseline
    paxos_cfg = SimConfig(n_replicas=3, n_slots=16, n_keys=64)
    # the 3x3 locality grid sized so skew churns object ownership: 16
    # objects over 32 keys, steal threshold 4 remote demands
    wpaxos_cfg = SimConfig(n_replicas=9, n_zones=3, n_slots=16,
                           n_keys=32, n_objects=16, steal_threshold=4,
                           locality=0.8)
    out = []
    for wl_name in ("uniform", "zipf99", "flash"):
        out.append((f"paxos_{wl_name}", "paxos", paxos_cfg, wl_name,
                    64 * s, 120, "committed_slots", "slots/s"))
        out.append((f"wpaxos_grid_{wl_name}", "wpaxos", wpaxos_cfg,
                    wl_name, 8 * s, 120, "committed_slots", "slots/s"))
    return out


def device_name(device) -> str:
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _timed(proto, cfg, fuzz, groups: int, steps: int, mesh, device):
    """A warm run (seed 1), then the timed run from a cold state (seed
    0): ``(whole numpy state, metrics, violations, seconds)``."""
    if mesh is not None:
        from paxi_tpu_torch.parallel import gather_state, make_sharded_run
        run = make_sharded_run(proto, cfg, fuzz=fuzz, mesh=mesh)
    else:
        run = make_run(proto, cfg, fuzz, device=device)

    def sync(x):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    sync(run(tr.PRNGKey(1), groups, steps)[2])
    t0 = time.perf_counter()
    state, metrics, viols = run(tr.PRNGKey(0), groups, steps)
    sync(viols)
    dt = time.perf_counter() - t0
    if mesh is not None:
        state = gather_state(state, mesh, groups)
    return state_to_numpy(state), metrics, viols, dt


def protocol_line(row, mesh=None, device=None) -> dict:
    """One ``_cfgs`` row's line."""
    label, proto_name, cfg, fuzz, groups, steps, key, unit = row
    proto = sim_protocol(proto_name)
    state, metrics, viols, dt = _timed(proto, cfg, fuzz, groups, steps,
                                       mesh, device)
    n = int(metrics[key])
    line = {
        "metric": f"{label}_{key}_per_sec",
        "value": round(n / dt, 1),
        "unit": unit,
        "vs_baseline": None,   # the reference publishes no numbers
        "config": label,
        "protocol": proto.name,
        key: n,
        "wall_s": round(dt, 3),
        "invariant_violations": int(viols),
        "groups": groups,
        "steps": steps,
        "mesh": mesh.world if mesh is not None else 0,
        "device": device_name(mesh.device if mesh is not None else device),
    }
    # the zone-latency split (scenario rows), in mean lock-step rounds
    line.update(scn.latency_split(metrics))
    # switchnet accounting: fast-path commits vs the fall-backs
    for k in ("fast_commits", "gap_events", "sw_overflows"):
        if k in metrics:
            line[k] = int(metrics[k])
    # commit-latency distribution and the in-scan linearizability verdict
    hist = lathist.total_hist(state)
    if hist is not None:
        line["commit_latency"] = lathist.summarize(
            hist, int(metrics.get("commit_lat_sum", 0)))
        line["inscan_violations"] = int(
            metrics.get("inscan_violations", 0))
    return line


def workload_line(row, mesh=None, device=None) -> dict:
    """One ``_wl_cfgs`` row's line."""
    from paxi_tpu_torch.workload import (apply_workload, class_split,
                                         named_workload)
    label, proto_name, cfg0, wl_name, groups, steps, key, unit = row
    cfg = apply_workload(cfg0, named_workload(wl_name))
    proto = sim_protocol(proto_name)
    state, metrics, viols, dt = _timed(proto, cfg, FAULT_FREE, groups,
                                       steps, mesh, device)
    n = int(metrics[key])
    line = {
        "metric": f"{label}_{key}_per_sec",
        "value": round(n / dt, 1),
        "unit": unit,
        "config": label,
        "protocol": proto.name,
        "workload": wl_name,
        key: n,
        "wall_s": round(dt, 3),
        "invariant_violations": int(viols),
        "inscan_violations": int(metrics.get("inscan_violations", 0)),
        "groups": groups,
        "steps": steps,
        "mesh": mesh.world if mesh is not None else 0,
        "device": device_name(mesh.device if mesh is not None else device),
    }
    hist = lathist.total_hist(state)
    if hist is not None:
        line["commit_latency"] = lathist.summarize(
            hist, int(metrics.get("commit_lat_sum", 0)))
    line["key_class_latency"] = class_split(state)
    line["key_class_counts"] = {
        c: int(metrics.get(f"wl_{c}_n", 0))
        for c in ("hot", "warm", "cold")}
    if "steals" in metrics:
        line["steals"] = int(metrics["steals"])
    return line


def sweep(workload: bool = False, mesh=None, device=None, emit=print):
    """Every line of the sweep (and, for the workload matrix, the wpaxos
    steal contrast), each handed to ``emit`` as it is made; returns
    (lines, worst violation count)."""
    results, worst = [], 0
    if mesh is not None:
        device = mesh.device
    if workload:
        steals = {}
        for row in _wl_cfgs(device):
            line = workload_line(row, mesh, device)
            if "steals" in line:
                steals[(line["protocol"], line["workload"])] = \
                    line["steals"]
            worst = max(worst, line["invariant_violations"],
                        line["inscan_violations"])
            results.append(line)
            emit(line)
        # the headline contrast: skew churns ownership, the control not
        u, z = steals.get(("wpaxos", "uniform")), \
            steals.get(("wpaxos", "zipf99"))
        if u is not None and z is not None:
            contrast = {"summary": "wpaxos_steal_contrast",
                        "uniform_steals": u, "zipf99_steals": z,
                        "skew_drives_stealing": z > u}
            results.append(contrast)
            emit(contrast)
        return results, worst
    for row in _cfgs(device):
        line = protocol_line(row, mesh, device)
        worst = max(worst, line["invariant_violations"],
                    line.get("inscan_violations", 0))
        results.append(line)
        emit(line)
    return results, worst


def _print_line(line) -> None:
    print(json.dumps(line), flush=True)


def _mesh_rank(mesh, workload: bool):
    """A rank's share of a sharded sweep; rank 0 prints the lines."""
    emit = _print_line if mesh.rank == 0 else (lambda _: None)
    return sweep(workload, mesh=mesh, emit=emit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="store_true",
                    help="the workload x topology matrix")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard every row over N ranks")
    ap.add_argument("--out", default=None,
                    help="the JSON list (default: build/BENCH_PROTOCOLS."
                         "json, or build/BENCH_WORKLOAD.json)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    out = args.out or str(BUILD_DIR / ("BENCH_WORKLOAD.json" if args.workload
                                       else "BENCH_PROTOCOLS.json"))
    if "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        from paxi_tpu_torch.parallel.launch import init_from_env
        mesh = init_from_env(args.device)
        try:
            results, worst = _mesh_rank(mesh, args.workload)
        finally:
            dist.destroy_process_group()
        if mesh.rank != 0:
            return 0 if worst == 0 else 1
    elif args.mesh:
        from paxi_tpu_torch.parallel.launch import spawn
        results, worst = spawn(args.mesh, _mesh_rank, args.workload,
                               device=args.device)[0]
    else:
        results, worst = sweep(args.workload, device=args.device,
                               emit=_print_line)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return 0 if worst == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
