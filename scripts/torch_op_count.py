#!/usr/bin/env python3
"""Count the PyTorch operators one lock-step round of the torch port
dispatches (each one a kernel launch on the card), on the CPU.

    python3 scripts/torch_op_count.py [--protocol wpaxos_thinq1]
        [--groups 16] [--warm 5] [--workload zipf99] [--config workload]
    python3 scripts/torch_op_count.py --row wankeeper_zones [--groups 16]
    python3 scripts/torch_op_count.py --protocol switchpaxos \
        --config wan3z|seqchurn

Runs ``--warm`` rounds of the hunt's ``wpaxos_thinq1`` case (9 replicas
in 3 zones, 4 objects, 16 slots) or of another protocol at that
configuration (``paxos_pg``, the per-group kernel, too), then counts the
aten operators of the next round, under the GEO3Z schedule (p_drop 0.05
inside the wan3z zone-latency matrix) and fault-free, and prints one JSON
line.  ``--workload NAME`` runs the named workload on ``bench_all.py``'s
workload configuration of the protocol instead (paxos and paxos_pg: 3
replicas, 16 slots, 64 keys; wpaxos: the 3 x 3 grid, 16 objects over 32
keys); ``--config workload`` takes that configuration without one.
``--row NAME`` counts a round of one of ``chip_smoke.py``'s phase-8 or
phase-9 rows (``PROTO_ROWS``, ``SWITCH_ROWS``: bench_all.py's protocol
rows) under its own schedule.  ``--config wan3z`` takes bench_all.py's
switchnet pair geometry (3 replicas, 32 slots) under the wan3z matrix
alone, ``--config seqchurn`` the hunt's switchpaxos case (5 replicas, 32
slots, the seqchurn sequencer windows) under DROP; each also counts a
fault-free round.  ``--sweep soak|bench|workload`` counts a round of every
row of the fuzz soak twin (every hunt case under each of its schedules),
of the bench_all twin's protocol rows or of its workload matrix, and
prints one JSON line a row with its runs and steps, then a total:
operators a sweep dispatches (runs x steps x operators a step), the
basis of a sweep's predicted time at a measured cost an operator.  The
count is the same at any group count.  On the card the
lane-major exchange launches its two kernels where the CPU runs their
plain versions' operators (a few dozen a message type), so the card
dispatches slightly fewer a step.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WITNESS_CFG = dict(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
                   steal_threshold=2, locality=0.3)
# bench_all.py's workload matrix configurations (_wl_cfgs)
WORKLOAD_CFGS = {"paxos": dict(n_replicas=3, n_slots=16, n_keys=64),
                 "wpaxos": dict(n_replicas=9, n_zones=3, n_slots=16,
                                n_keys=32, n_objects=16, steal_threshold=4,
                                locality=0.8)}


class OpCount(TorchDispatchMode):
    """Counts every aten operator dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def ops_a_step(proto, cfg, fuzz, groups: int, warm: int) -> int:
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, groups, tr.PRNGKey(0), "cpu")
        for t in range(warm):
            carry, _ = body(carry, t)
        count = OpCount()
        with count:
            body(carry, warm)
    return count.n


def sweep_counts(which: str, groups: int, warm: int) -> int:
    """One JSON line a row of a driver twin's sweep, then the total."""
    from paxi_tpu_torch import bench_all
    from paxi_tpu_torch.hunt import cases as hc
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE
    from paxi_tpu_torch.workload import apply_workload, named_workload

    rows = []   # (label, protocol, cfg, fuzz, runs, steps, groups)
    if which == "soak":
        for name, cfg, scheds, g, steps, _ in hc.CASES:
            for fz in scheds:
                rows.append((f"{name}/{hc.sched_name(fz)}", name, cfg, fz,
                             len(hc.SEEDS), steps, g))
    elif which == "bench":
        for label, name, cfg, fz, g, steps, _, _ in bench_all._cfgs("cuda"):
            rows.append((label, name, cfg, fz, 2, steps, g))
    else:
        for label, name, cfg, wl, g, steps, _, _ in \
                bench_all._wl_cfgs("cuda"):
            rows.append((label, name, apply_workload(cfg, named_workload(wl)),
                         FAULT_FREE, 2, steps, g))
    total = 0
    for label, name, cfg, fz, runs, steps, g in rows:
        n = ops_a_step(sim_protocol(name), cfg, fz, groups, warm)
        total += runs * steps * n
        print(json.dumps({"row": label, "protocol": name, "runs": runs,
                          "steps": steps, "groups_on_the_card": g,
                          "ops_a_step": n, "ops": runs * steps * n}),
              flush=True)
    print(json.dumps({"sweep": which, "rows": len(rows),
                      "ops_total": total,
                      "device": "cpu (a count, not a time)"}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", default="wpaxos_thinq1")
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--workload", default=None,
                    help="a named workload (uniform, zipf99, flash, ...)")
    ap.add_argument("--config", choices=("witness", "workload", "wan3z",
                                         "seqchurn"),
                    default=None, help="the geometry (default: workload "
                    "with --workload, else witness)")
    ap.add_argument("--row", default=None,
                    help="a chip_smoke.py PROTO_ROWS or SWITCH_ROWS row, "
                    "under its own schedule")
    ap.add_argument("--sweep", choices=("soak", "bench", "workload"),
                    default=None, help="every row of a driver twin's sweep")
    args = ap.parse_args()
    if args.sweep:
        return sweep_counts(args.sweep, args.groups, args.warm)

    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig
    from paxi_tpu_torch.workload import apply_workload, named_workload

    import chip_smoke
    if args.row:
        spec = {**chip_smoke.PROTO_ROWS, **chip_smoke.SWITCH_ROWS}[args.row]
        sched = spec.get("schedule", "fault_free")
        print(json.dumps({
            "row": args.row, "protocol": spec["protocol"],
            "groups": args.groups, "config": spec["cfg"],
            "schedule": sched, "device": "cpu (a count, not a time)",
            "ops_a_step": ops_a_step(
                sim_protocol(spec["protocol"]), SimConfig(**spec["cfg"]),
                chip_smoke.schedule_of(sched), args.groups, args.warm)}))
        return 0
    if args.config in ("wan3z", "seqchurn"):
        cfg_kw, sched = {"wan3z": (chip_smoke.SWITCH_CFG, "wan3z"),
                         "seqchurn": (chip_smoke.SEQCHURN_CFG,
                                      "seqchurn_drop")}[args.config]
        proto, cfg = sim_protocol(args.protocol), SimConfig(**cfg_kw)
        print(json.dumps({
            "protocol": args.protocol, "groups": args.groups,
            "config": cfg_kw, "device": "cpu (a count, not a time)",
            "ops_a_step": {
                sched: ops_a_step(proto, cfg, chip_smoke.schedule_of(sched),
                                  args.groups, args.warm),
                "fault_free": ops_a_step(proto, cfg, FAULT_FREE,
                                         args.groups, args.warm)}}))
        return 0
    cfg_kw = WITNESS_CFG
    if (args.config or ("workload" if args.workload else "witness")) \
            == "workload":
        family = "wpaxos" if args.protocol.startswith("wpaxos") else "paxos"
        cfg_kw = WORKLOAD_CFGS[family]
    proto, cfg = sim_protocol(args.protocol), SimConfig(**cfg_kw)
    if args.workload:
        cfg = apply_workload(cfg, named_workload(args.workload))
    geo = FuzzConfig(p_drop=0.05, scenario=NAMED["wan3z"])
    print(json.dumps({
        "protocol": args.protocol, "groups": args.groups,
        "config": cfg_kw, "workload": args.workload,
        "device": "cpu (a count, not a time)",
        "ops_a_step": {
            "geo3z": ops_a_step(proto, cfg, geo, args.groups, args.warm),
            "fault_free": ops_a_step(proto, cfg, FAULT_FREE, args.groups,
                                     args.warm)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
