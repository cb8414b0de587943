#!/usr/bin/env python3
"""Profile lock-step rounds of the torch port's main path on one card.

    python3 scripts/torch_step_profile.py [--groups 100000] [--steps 8]
        [--fuzz] [--top 25]

Runs ``--steps`` warm rounds of the lane-major paxos kernel (5 replicas,
64-slot ring) and then ``--steps`` rounds under ``torch.profiler``, and
prints JSON lines: the device time per step by aten operator and by CUDA
kernel (top ``--top`` of each), the share of the two exchange kernels, and
the device's busy and idle share of the window's wall time.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    proto = sim_protocol("paxos")
    cfg = SimConfig(n_replicas=5, n_slots=64)
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
    xchg_us = sum(r[0] for r in kernels if "deliver_kernel" in r[1]
                  or "insert_kernel" in r[1])
    for kind, rows in (("op", ops), ("kernel", kernels)):
        for dev_us, key, count in rows[:args.top]:
            print(kind + " " + json.dumps({
                "name": key[:120], "calls": count,
                "device_ms_per_step": dev_us / 1e3 / args.steps,
                "share_of_busy": dev_us / busy_us}))
    print(json.dumps({
        "groups": args.groups, "steps_profiled": args.steps,
        "schedule": "fuzz" if args.fuzz else "fault_free",
        "wall_ms_per_step": wall_s * 1e3 / args.steps,
        "device_busy_ms_per_step": busy_us / 1e3 / args.steps,
        "device_idle_share": (max(0.0, 1 - busy_us / 1e6 / wall_s)
                              if busy_us else None),
        "exchange_kernels_share_of_busy": (xchg_us / busy_us
                                           if busy_us else None),
        "kernels_launched_per_step": sum(r[2] for r in kernels)
        / args.steps,
        "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
