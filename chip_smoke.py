#!/usr/bin/env python3
"""Smoke run of the torch port (``paxi_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure ends the run with a
non-zero exit code and no result line:

1. device: the card's name and power limit, torch and CUDA versions, and
   the time to build the CUDA kernels from ``paxi_tpu_torch/ops/csrc``;
2. kernels against their plain versions at the main path's shape (paxos
   mailbox, 5 replicas, 100,000 groups, wheel depth 1 and 3): exact
   equality, CUDA-event times (median), bytes moved and the bandwidth
   bound;
3. card against CPU: the same seed and a small shape run on both devices
   under a fault-free and a fuzzed schedule must give identical final
   state, metrics and violations;
4. the main path: 100,000 groups x 5 replicas x 64-slot ring for 104
   steps through ``simulate``, fault-free (warm-up run, then a timed run)
   and under ``FuzzConfig(p_drop=0.1, max_delay=3)``, with the launch
   counts of both kernels read around each run, then a per-stage split
   of one step's device time;
5. the kernel summary line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and exits non-zero when CUDA
is not available.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
GROUPS, REPLICAS, RING, STEPS = 100_000, 5, 64, 104
SMALL_GROUPS, SMALL_STEPS = 256, 60
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
TIMED_REPS = 20
FUZZ_ARGS = dict(p_drop=0.1, max_delay=3)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = TIMED_REPS) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs (after two
    warm-up runs)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---- phase 2: kernels against their plain versions ----------------------

def random_blocks(spec, d: int, gen: torch.Generator):
    """Seeded random stacked wheel blocks, outboxes and fault planes at
    the main path's shape, one set per message type."""
    dev = torch.device("cuda")
    R, G = REPLICAS, GROUPS
    blocks = {}
    for name, fields in spec.items():
        F = 1 + len(fields)

        def ints(shape, hi):
            return torch.randint(0, hi, shape, generator=gen, device=dev,
                                 dtype=torch.int32)

        w = ints((d, F, R, R, G), 1000)
        w[:, 0] = ints((d, R, R, G), 2)
        ob = ints((F, R, R, G), 1000)
        ob[0] = ints((R, R, G), 2)
        eff = ints((R, R, G), 2).bool()
        delay = ints((R, R, G), d) + 1
        dup = ints((R, R, G), 2).bool()
        blocks[name] = (w, ob, eff, delay, dup)
    return blocks


def kernel_phase(spec):
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import mailbox as mb

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = {}
    for d in (1, 3):
        blocks = random_blocks(spec, d, gen)
        err = {"wheel_deliver": 0, "wheel_insert": 0}
        for w, ob, eff, delay, dup in blocks.values():
            got, want = ops.deliver_launch(w), mb.deliver_planes(w)
            for g_, w_ in zip(got, want):
                err["wheel_deliver"] = max(
                    err["wheel_deliver"],
                    int((g_.long() - w_.long()).abs().max()))
            got = ops.insert_launch(w, ob, eff, delay, dup)
            want = mb.insert_planes(w, ob, eff, delay, dup)
            err["wheel_insert"] = max(err["wheel_insert"],
                                      int((got.long() - want.long())
                                          .abs().max()))
        torch.cuda.synchronize()
        # bytes one step moves over all five message types: each input
        # read once, each output written once
        deliver_bytes = sum(w.numel() * 4 + w[0].numel() * 4 + w.numel() * 4
                            for w, *_ in blocks.values())
        insert_bytes = sum(w.numel() * 4 * 2 + ob.numel() * 4
                           + eff.numel() + delay.numel() * 4 + dup.numel()
                           for w, ob, eff, delay, dup in blocks.values())
        vals = list(blocks.values())
        timings = {
            "wheel_deliver": (
                median_ms(lambda: [ops.deliver_launch(b[0]) for b in vals]),
                median_ms(lambda: [mb.deliver_planes(b[0]) for b in vals]),
                deliver_bytes),
            "wheel_insert": (
                median_ms(lambda: [ops.insert_launch(*b) for b in vals]),
                median_ms(lambda: [mb.insert_planes(*b) for b in vals]),
                insert_bytes),
        }
        for name, (ms, plain_ms, nbytes) in timings.items():
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "wheel_depth": d, "groups": GROUPS,
                   "replicas": REPLICAS, "message_types": len(vals),
                   "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "share_of_bound": bound_ms / ms}
            log("kernel " + json.dumps(row))
            if err[name] != 0:
                fail(f"{name} differs from its plain version at d={d}")
            rows[(name, d)] = row
    return rows


# ---- phase 3: the card against the CPU ----------------------------------

def compare_runs(a, b, label: str) -> None:
    from paxi_tpu_torch.convert import state_to_numpy
    sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
    for k in sa:
        if sa[k].dtype != sb[k].dtype or not (sa[k] == sb[k]).all():
            fail(f"{label}: state plane {k} differs between CPU and card")
    for k in a.metrics:
        if int(a.metrics[k]) != int(b.metrics[k]):
            fail(f"{label}: metric {k} differs: {int(a.metrics[k])} vs "
                 f"{int(b.metrics[k])}")
    if int(a.violations) != int(b.violations):
        fail(f"{label}: violations differ")


def card_vs_cpu_phase(proto, cfg):
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, simulate
    for label, fuzz in (("fault_free", FAULT_FREE),
                        ("fuzz", FuzzConfig(**FUZZ_ARGS))):
        t0 = time.perf_counter()
        on_cpu = simulate(proto, cfg, SMALL_GROUPS, SMALL_STEPS, fuzz,
                          seed=SEED, device="cpu")
        on_card = simulate(proto, cfg, SMALL_GROUPS, SMALL_STEPS, fuzz,
                           seed=SEED, device="cuda")
        compare_runs(on_cpu, on_card, label)
        log("card_vs_cpu " + json.dumps({
            "schedule": label, "groups": SMALL_GROUPS,
            "steps": SMALL_STEPS, "equal": True,
            "committed_slots": int(on_card.metrics["committed_slots"]),
            "violations": int(on_card.violations),
            "seconds": time.perf_counter() - t0}))


# ---- phase 4: the main path ---------------------------------------------

def main_path_run(proto, cfg, fuzz, label: str, device_line: str,
                  fault_free: bool):
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import simulate

    warmup_s = None
    if fault_free:
        t0 = time.perf_counter()
        simulate(proto, cfg, GROUPS, STEPS, fuzz, seed=SEED + 1,
                 device="cuda")
        warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, STEPS, fuzz, seed=SEED,
                   device="cuda")
    wall_s = time.perf_counter() - t0
    launches = {"wheel_deliver": ops.wheel_deliver.launches,
                "wheel_insert": ops.wheel_insert.launches}
    n_types = len(proto.mailbox_spec(cfg))
    committed = int(res.metrics["committed_slots"])
    row = {
        "schedule": label,
        "metric": "committed_paxos_slots_per_sec",
        "committed_paxos_slots_per_sec": committed / wall_s,
        "committed_slots": committed,
        "wall_s": wall_s, "warmup_s": warmup_s,
        "invariant_violations": int(res.violations),
        "inscan_violations": res.inscan_violations,
        "commit_latency": res.latency_summary(),
        "groups": GROUPS, "replicas": REPLICAS, "steps": STEPS,
        "ring_slots": RING, "device": device_line,
        "kernels": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "counters": {k: int(v) for k, v in res.counters.items()},
    }
    log("main_path " + json.dumps(row))
    if int(res.violations) != 0 or res.inscan_violations != 0:
        fail(f"{label}: safety violations on the main path")
    if fault_free and committed != (STEPS - 4) * GROUPS:
        fail(f"{label}: committed {committed} != {(STEPS - 4) * GROUPS}")
    for name, n in launches.items():
        if n != STEPS * n_types:
            fail(f"{label}: {name} launched {n} times, expected "
                 f"{STEPS * n_types}")
    return row


def step_split_phase(proto, cfg, fuzz, label: str, n_steps: int = 8):
    """Device time of each stage of one lock-step round at the main
    path's shape, by CUDA events between the stages (the runner's
    ``_group_step`` sequence, after ``n_steps`` warm steps)."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.metrics.simcount import step_counts
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import lanes
    from paxi_tpu_torch.sim import mailbox as mb
    from paxi_tpu_torch.sim.runner import (flush_measurements, init_carry,
                                           make_scan_body)
    from paxi_tpu_torch.sim.types import StepCtx

    dev = torch.device("cuda")
    stages = ("deliver", "protocol_step", "faults_and_counts", "insert",
              "invariants", "flush")
    acc = {s: [] for s in stages}
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, GROUPS, tr.PRNGKey(SEED), dev)
        body = make_scan_body(proto, cfg, fuzz)
        for t in range(n_steps):
            carry, _ = body(carry, t)
        for t in range(n_steps, 2 * n_steps):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
            state, wheel, fs, rng = carry
            ev[0].record()
            rng, k_step, k_fault, k_ins = tr.split(rng, 4)
            inbox, wheel = ops.wheel_deliver(wheel)
            ev[1].record()
            new_state, outbox = proto.step(state, inbox,
                                           StepCtx(k_step, t, cfg))
            ev[2].record()
            fs = lanes.fault_state_refresh(fs, k_fault, t, fuzz,
                                           cfg.n_replicas)
            faults = mb.draw_edge_faults(k_ins, outbox, fuzz)
            wv = ({n: b.planes[:, 0] != 0 for n, b in wheel.items()}
                  if fuzz.wheel > 1 else None)
            step_counts(inbox, outbox, faults, fs, cfg.n_replicas,
                        wheel_valid=wv)
            ev[3].record()
            wheel = ops.wheel_insert(wheel, outbox, fs, faults)
            ev[4].record()
            proto.invariants(state, new_state, cfg)
            ev[5].record()
            carry = flush_measurements(proto, cfg,
                                       (new_state, wheel, fs, rng), t)
            ev[6].record()
            torch.cuda.synchronize()
            for i, s in enumerate(stages):
                acc[s].append(ev[i].elapsed_time(ev[i + 1]))
    split = {s: statistics.mean(v) for s, v in acc.items()}
    log("step_split " + json.dumps({"schedule": label, "groups": GROUPS,
                                    "steps_timed": n_steps,
                                    "mean_ms": split,
                                    "total_ms": sum(split.values())}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from paxi_tpu_torch.ops import _build
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig

    # 1. device and build
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build(["exchange"])
    build_s = time.perf_counter() - t0
    log("device " + json.dumps({
        "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_s": _build.BUILD_SECONDS}))

    proto = sim_protocol("paxos")
    cfg = SimConfig(n_replicas=REPLICAS, n_slots=RING)
    spec = proto.mailbox_spec(cfg)

    # 2. kernels against their plain versions
    krows = kernel_phase(spec)

    # 3. the card against the CPU
    card_vs_cpu_phase(proto, cfg)

    # 4. the main path, fault-free then fuzzed, and a step's split
    free = main_path_run(proto, cfg, FAULT_FREE, "fault_free", smi, True)
    main_path_run(proto, cfg, FuzzConfig(**FUZZ_ARGS), "fuzz", smi, False)
    step_split_phase(proto, cfg, FAULT_FREE, "fault_free")
    step_split_phase(proto, cfg, FuzzConfig(**FUZZ_ARGS), "fuzz")

    # 5. the kernel summary at the main path's shape (wheel depth 1)
    sources = {"wheel_deliver": "paxi_tpu/ops/exchange.py:93",
               "wheel_insert": "paxi_tpu/ops/exchange.py:140"}
    kernels = []
    for kname, replaces in sources.items():
        row = krows[(kname, 1)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paxi_tpu_torch/ops/csrc/exchange.cu",
            "replaces": replaces, "launches": free["kernels"][kname],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
