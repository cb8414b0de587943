#!/usr/bin/env python3
"""Profile lock-step rounds of the torch port's main path on one card.

    python3 scripts/torch_step_profile.py [--protocol paxos|epaxos]
        [--groups 100000] [--steps 8] [--fuzz] [--top 25]

Runs ``--steps`` warm rounds of a lane-major kernel at its main path's
configuration (paxos: 5 replicas, 64-slot ring; epaxos: 5 replicas,
16-instance window, 4 keys) and then ``--steps`` rounds under
``torch.profiler``, and prints JSON lines: the device time per step by
aten operator and by CUDA kernel (top ``--top`` of each), the share of the
exchange kernels and of the closure kernel, and the device's busy and idle
share of the window's wall time.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CONFIGS = {"paxos": dict(n_replicas=5, n_slots=64),
           "epaxos": dict(n_replicas=5, n_slots=16, n_keys=4)}
# CUDA kernel names of the port's hand-written kernels, by group
OWN_KERNELS = {"exchange": ("deliver_kernel", "insert_kernel"),
               "closure": ("closure_kernel",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", choices=sorted(CONFIGS), default="paxos")
    ap.add_argument("--groups", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--fuzz", action="store_true",
                    help="FuzzConfig(p_drop=0.1, max_delay=3)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body

    proto = sim_protocol(args.protocol)
    cfg = SimConfig(**CONFIGS[args.protocol])
    fuzz = FuzzConfig(p_drop=0.1, max_delay=3) if args.fuzz else FAULT_FREE
    dev = torch.device("cuda")
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, args.groups,
                           tr.PRNGKey(args.seed), dev)
        body = make_scan_body(proto, cfg, fuzz)
        for t in range(args.steps):
            carry, _ = body(carry, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(args.steps, 2 * args.steps):
                carry, _ = body(carry, t)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0

    # device time per CUDA kernel (the busy time), and per aten operator
    # (the self device time of the kernels each operator launched); the
    # two views count the same kernels, so only the first is summed
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us <= 0:
            continue
        on_card = str(getattr(e, "device_type", "")).endswith("CUDA")
        (kernels if on_card else ops).append((dev_us, e.key, e.count))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    busy_us = sum(r[0] for r in kernels)
    own_us = {g: sum(r[0] for r in kernels if any(n in r[1] for n in names))
              for g, names in OWN_KERNELS.items()}
    for kind, rows in (("op", ops), ("kernel", kernels)):
        for dev_us, key, count in rows[:args.top]:
            print(kind + " " + json.dumps({
                "name": key[:120], "calls": count,
                "device_ms_per_step": dev_us / 1e3 / args.steps,
                "share_of_busy": dev_us / busy_us}))
    print(json.dumps({
        "protocol": args.protocol,
        "groups": args.groups, "steps_profiled": args.steps,
        "schedule": "fuzz" if args.fuzz else "fault_free",
        "wall_ms_per_step": wall_s * 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": (max(0.0, 1 - busy_us / 1e6 / wall_s)
                              if busy_us else None),
        **{f"{g}_kernels_share_of_busy": (us / busy_us if busy_us else None)
           for g, us in own_us.items()},
        "kernels_launched_per_step": sum(r[2] for r in kernels)
        / args.steps,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
