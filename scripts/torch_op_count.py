#!/usr/bin/env python3
"""Count the PyTorch operators one lock-step round of the torch port
dispatches (each one a kernel launch on the card), on the CPU.

    python3 scripts/torch_op_count.py [--protocol wpaxos_thinq1]
        [--groups 16] [--warm 5]

Runs ``--warm`` rounds of the hunt's ``wpaxos_thinq1`` case (9 replicas
in 3 zones, 4 objects, 16 slots) or of another lane-major protocol at that
configuration, then counts the aten operators of the next round, under
the GEO3Z schedule (p_drop 0.05 inside the wan3z zone-latency matrix) and
fault-free, and prints one JSON line.  The count is the same at any
group count.  On the card the exchange launches its two kernels where the
CPU runs their plain versions' operators (a few dozen a message type), so
the card dispatches slightly fewer a step.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", default="wpaxos_thinq1")
    ap.add_argument("--groups", type=int, default=16)
    ap.add_argument("--warm", type=int, default=5)
    args = ap.parse_args()

    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig

    proto, cfg = sim_protocol(args.protocol), SimConfig(**WITNESS_CFG)
    geo = FuzzConfig(p_drop=0.05, scenario=NAMED["wan3z"])
    print(json.dumps({
        "protocol": args.protocol, "groups": args.groups,
        "config": WITNESS_CFG, "device": "cpu (a count, not a time)",
        "ops_a_step": {
            "geo3z": ops_a_step(proto, cfg, geo, args.groups, args.warm),
            "fault_free": ops_a_step(proto, cfg, FAULT_FREE, args.groups,
                                     args.warm)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
