"""Runnable tour of the workload engine: one spec, two lowerings (torch
twin of the JAX package's ``workload/demo.py``).

    python -m paxi_tpu_torch.workload.demo [--device cpu]

Walks the named catalog, shows the counter-draw determinism that makes a
spec portable across lowerings (lane-major ``paxos`` against per-group
``paxos_pg`` on the same zipf99 spec: equal kv planes), the per-key-class
latency split, the host sampler agreeing with the sim's planes draw for
draw, and the wpaxos steal contrast under skew.  Every stage is asserted,
so the demo doubles as a smoke script; it prints one JSON line a stage,
the reference's lines.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig, simulate
    from paxi_tpu_torch.sim.types import resolve_device
    from paxi_tpu_torch.workload import (NAMED, ZIPF99, apply_workload,
                                         class_split, describe,
                                         host_sampler, key_plane,
                                         named_workload, read_plane)
    dev = resolve_device(args.device)

    # 1. the catalog
    print(json.dumps({"stage": "catalog",
                      "specs": [describe(NAMED[n])["name"]
                                for n in sorted(NAMED)]}))

    # 2. one spec, both sim lowerings: equal command effects
    cfg = apply_workload(SimConfig(n_replicas=3, n_slots=16, n_keys=64),
                         ZIPF99)
    res = {n: simulate(sim_protocol(n), cfg, 8, 80, seed=3, device=dev)
           for n in ("paxos", "paxos_pg")}
    kv = {n: r.state["kv"].cpu() for n, r in res.items()}
    assert torch.equal(kv["paxos"], kv["paxos_pg"])
    assert all(int(r.violations) == 0 for r in res.values())
    split = class_split(res["paxos"].state)
    print(json.dumps({
        "stage": "sim-lowering-parity", "workload": "zipf99",
        "kv_bit_identical": True,
        "committed": int(res["paxos"].metrics["committed_slots"]),
        "key_class_latency": split}))

    # 3. host sampler == sim planes (same hash family, python ints)
    slots = torch.arange(64, device=dev)
    sim_keys = key_plane(ZIPF99, 64, 2, slots).tolist()
    sim_reads = read_plane(ZIPF99, 2, slots).tolist()
    sample = host_sampler(ZIPF99, 64, stream=2)
    agree = all(sample(i)[0] == sim_keys[i]
                and sample(i)[1] == (not sim_reads[i])
                for i in range(64))
    assert agree
    print(json.dumps({"stage": "host-sim-agreement", "stream": 2,
                      "draws": 64, "agree": agree}))

    # 4. skew churns wpaxos ownership; the uniform control does not
    base = SimConfig(n_replicas=9, n_zones=3, n_slots=16, n_keys=32,
                     n_objects=16, steal_threshold=4, locality=0.8)
    steals = {}
    for name in ("uniform", "zipf99"):
        wcfg = apply_workload(base, named_workload(name))
        r = simulate(sim_protocol("wpaxos"), wcfg, 8, 120, seed=0,
                     device=dev)
        assert int(r.violations) == 0
        steals[name] = int(r.metrics["steals"])
    print(json.dumps({"stage": "wpaxos-steal-contrast",
                      "steals": steals,
                      "skew_drives_stealing":
                          steals["zipf99"] > steals["uniform"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
