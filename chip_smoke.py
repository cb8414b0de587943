#!/usr/bin/env python3
"""Smoke run of the torch port (``paxi_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure ends the run with a
non-zero exit code and no result line:

1. device: the card's name and power limit, torch and CUDA versions, and
   the time to build the CUDA kernels from ``paxi_tpu_torch/ops/csrc``
   (one ``nvcc`` a source, started together: exchange, closure,
   lane_shift);
2. kernels against their plain versions at the main paths' shapes, exact:
   the two exchange kernels at 100,000 groups x 5 replicas for the paxos
   and the epaxos mailbox (wheel depth 1 and 3) and at 9 replicas for the
   wpaxos mailbox at the six-slot wheel of the wan3z scenario, the closure
   kernel at the EPaxos execution step's shape (500,000 graphs of 80 nodes, two
   densities), on the graphs the EPaxos path itself hands the closure at
   step 30 of its fault-free and fuzzed runs, and at 130 and 256 nodes,
   and the ring shift (``make_remote_lane_shift``, one ``shift.many`` call
   a state) at world 1 over every plane of an epaxos state of 100,000
   groups; CUDA-event times (median), bytes moved, the bound, and for the
   shift ``out.copy_(x)`` as the library yardstick;
3. card against CPU: the same seed and a small shape run on both devices
   under a fault-free and a fuzzed schedule must give identical final
   state, metrics and violations, for paxos, epaxos, sdpaxos and wpaxos;
4. the main paths, each read with the launch counts set to 0 just before
   it: paxos at 100,000 groups x 5 replicas x 64-slot ring for 104 steps
   and epaxos at 100,000 groups x 5 replicas x 16-instance window x 4
   keys for 60 steps, both through ``simulate``, fault-free (an 8-step
   warm-up run, then a timed run) and under
   ``FuzzConfig(p_drop=0.1, max_delay=3)``, then a per-stage split of
   one step's device time for each; then sdpaxos (``bench_all.py``'s
   ``sdpaxos_tokens``, 80 steps) and wpaxos (``wpaxos_3x3_grid``, 60
   steps) at 100,000 groups, fault-free, with
   their rates; each must commit its count (``NEW_PATHS``) with one
   launch of each exchange kernel a message type a step;
5. record, replay, shrink, scenarios and checkpoints: the hunt's seeded
   bug (``wpaxos_thinq1``, 9 replicas in 3 zones, under p_drop 0.05 inside
   the wan3z zone-latency matrix) captured at 100,000 groups x 100 steps
   (every group's schedule recorded on the card), replayed twice and from
   its saved file to the capture's state hash, counters and latency
   histogram, and the real wpaxos under the same schedule with 0
   violations; the same case at the hunt's 16 groups recorded on the card
   and on the CPU (every plane equal), then shrunk on the card (40
   replays); wpaxos 3 x 3 under wan3z alone at 100,000 groups (bench_all's
   ``wpaxos_wan3z_geo``) with its zone-local and cross-zone latency; and
   the fuzzed paxos path resumed from a checkpoint (52 steps,
   ``save_carry``, ``load_carry``, 52 more) equal to the straight run;
6. four ranks sharing the card (``parallel.launch.spawn``, gloo): the
   shift kernel against its plain version at 25,000 groups a rank, both
   timed, and the shift's own path (every state rotated once around the
   ring by ``shift.many``, two launches a call, launch counts read around
   it); the sharded runs of paxos, sdpaxos and wpaxos
   at 256 groups x 30 steps, fault-free and fuzzed, against the same
   sharded runs on four CPU ranks (identical gathered state, metrics and
   violations); ``dryrun_multichip``; and the sharded north star, paxos
   at 100,000 groups x 5 x 64 for 104 steps over the four ranks, which
   must commit 10,000,000 slots with 0 violations (correctness: four
   processes time-slicing one card say nothing of four cards);
7. the kernel summary line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.

It needs one card, imports nothing of JAX, and exits non-zero when CUDA
is not available.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

DEVICE = "cuda"
SEED = 0
GROUPS, REPLICAS = 100_000, 5
SHARD_WORLD = 4                      # ranks sharing the card in phase 6
# the card-against-CPU runs (phases 3 and 6); 60 steps until phase 5 came
SMALL_GROUPS, SMALL_STEPS = 256, 30
WARMUP_STEPS = 8                     # the main paths' warm-up run
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
# H100 SXM int32 lanes: 64 a clock an SM, 132 SMs at 1.98 GHz (NVIDIA's
# Hopper white paper); the closure kernel's word updates run there
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIMED_REPS = 20
SHIFT_INNER = 4                      # shift calls a timed run (world 1)
FUZZ_ARGS = dict(p_drop=0.1, max_delay=3)
# the two main paths: configuration, depth, and what a fault-free run
# must commit
PATHS = {
    "paxos": dict(cfg=dict(n_replicas=REPLICAS, n_slots=64), steps=104,
                  line="main_path",
                  metric="committed_paxos_slots_per_sec",
                  count="committed_slots",
                  expect=lambda steps: (steps - 4) * GROUPS),
    # fault-free EPaxos draws nothing random: 74 instances a group
    # commit and execute in 60 steps (the same count as the JAX package)
    "epaxos": dict(cfg=dict(n_replicas=REPLICAS, n_slots=16, n_keys=4),
                   steps=60, line="epaxos_path",
                   metric="epaxos_conflict_executed_per_sec",
                   count="executed", expect=lambda steps: 74 * GROUPS),
}
# the new kernels' single-card runs: bench_all.py's configurations at the
# BASELINE.json scale, and what a fault-free run of seed SEED must commit
NEW_PATHS = {
    # fault-free sdpaxos commits one slot a group a step from step 4 on
    "sdpaxos": dict(cfg=dict(n_replicas=5, n_slots=32, n_keys=16),
                    steps=80, line="sdpaxos_path",
                    metric="committed_sdpaxos_slots_per_sec",
                    expect=76 * GROUPS),
    # wpaxos draws its demand and steals from the seed, so its count is
    # that seed's: the card equals the CPU on the same seed (phases 3 and
    # 6) and the CPU the JAX package (tests/test_torch_wpaxos_sim.py)
    "wpaxos": dict(cfg=dict(n_replicas=9, n_zones=3, n_objects=6,
                            n_slots=16, steal_threshold=3, locality=0.8),
                   steps=60, line="wpaxos_path",
                   metric="committed_wpaxos_slots_per_sec",
                   expect=18_041_564),
}
# phase 6's sharded card-against-CPU runs
SHARDED_CHECKS = {"paxos": PATHS["paxos"]["cfg"],
                  "sdpaxos": NEW_PATHS["sdpaxos"]["cfg"],
                  "wpaxos": NEW_PATHS["wpaxos"]["cfg"]}
# closure shapes: (label, graphs, nodes, edge density); the first two are
# the EPaxos execution step's (replicas x groups graphs of R x 16 nodes)
CLOSURE_SHAPES = (("main_path", REPLICAS * GROUPS, REPLICAS * 16, 0.02),
                  ("main_path", REPLICAS * GROUPS, REPLICAS * 16, 0.1),
                  ("n130", 50_000, 130, 0.02),
                  ("n256", 20_000, 256, 0.02))
CLOSURE_CHUNK_BYTES = 1_300_000_000  # float32 operand of the plain check
PATH_GRAPH_STEP = 30                 # the EPaxos step whose graphs are taken
# phase 5: the hunt's seeded-bug case (paxi_tpu/hunt/cases.py,
# wpaxos_thinq1 under GEO3Z: p_drop 0.05 inside the wan3z zone-latency
# matrix), captured and replayed at GROUPS, shrunk at the hunt's 16 groups
WITNESS_CFG = dict(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
                   steal_threshold=2, locality=0.3)
WITNESS_STEPS, HUNT_GROUPS, SHRINK_TRIALS, GEO_DROP = 100, 16, 40, 0.05
# bench_all.py's wpaxos_wan3z_geo row: wpaxos 3 x 3 under wan3z alone
SCENARIO_CFG = NEW_PATHS["wpaxos"]["cfg"]
SCENARIO_STEPS = 100
CHECKPOINT_SPLIT = 52                # of the paxos path's 104 fuzzed steps
SCRATCH_DIR = "build/chip_smoke"     # trace and checkpoint files


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


def median_ms(fn, reps: int = TIMED_REPS, inner: int = 1) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs (after two
    warm-up runs); with ``inner`` > 1 each run is that many calls back to
    back, divided by ``inner``, so one call's host set-up overlaps the
    card's work on the call before."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def launch_counts():
    from paxi_tpu_torch.ops import closure, exchange
    return {"wheel_deliver": exchange.wheel_deliver.launches,
            "wheel_insert": exchange.wheel_insert.launches,
            "transitive_closure": closure.transitive_closure.launches,
            "make_remote_lane_shift":
                exchange.make_remote_lane_shift.launches}


def reset_launch_counts() -> None:
    from paxi_tpu_torch.ops import closure, exchange
    exchange.reset_launches()
    closure.reset_launches()


# ---- phase 2: kernels against their plain versions ----------------------

def random_blocks(spec, d: int, gen: torch.Generator,
                  replicas: int = REPLICAS):
    """Seeded random stacked wheel blocks, outboxes and fault planes at
    the main path's shape, one set per message type."""
    dev = torch.device(DEVICE)
    R, G = replicas, GROUPS
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


def exchange_phase(path: str, spec, depths=(1, 3),
                   replicas: int = REPLICAS):
    """Both exchange kernels on one mailbox's blocks, one step's worth
    (every message type), at each wheel depth of ``depths``."""
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import mailbox as mb

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    rows = {}
    for d in depths:
        blocks = random_blocks(spec, d, gen, replicas)
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
        # bytes one step moves over all message types: each input read
        # once, each output written once
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
            row = {"kernel": name, "mailbox": path, "wheel_depth": d,
                   "groups": GROUPS, "replicas": replicas,
                   "message_types": len(vals),
                   "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "share_of_bound": bound_ms / ms}
            log("kernel " + json.dumps(row))
            if err[name] != 0:
                fail(f"{name} differs from its plain version at d={d} "
                     f"({path} mailbox)")
            rows[(name, d)] = row
        del blocks, vals
    return rows


def closure_ops(b: int, n: int) -> int:
    """The word and-ors Warshall's algorithm needs on ``b`` graphs of ``n``
    nodes at most: n steps, each ORing row k's ceil(n/32) words into every
    row that has bit k (all n rows at most; no padded rows counted)."""
    return b * n * n * ((n + 31) // 32)


def closure_row(label, a, p=None, reps=TIMED_REPS):
    """The closure kernel against its plain version on ``a``, exact,
    compared in chunks that keep the plain version's float32 operands
    small, then timed beside it."""
    from paxi_tpu_torch.ops import closure as C
    b, n = a.shape[0], a.shape[-1]
    got = C.closure_launch(a)
    chunk = max(1, CLOSURE_CHUNK_BYTES // (4 * n * n))
    err = 0
    for s in range(0, b, chunk):
        want = C.closure_plain(a[s:s + chunk])
        err = max(err, int((got[s:s + chunk].to(torch.int32)
                            - want.to(torch.int32)).abs().max()))
    del got, want
    ms = median_ms(lambda: C.closure_launch(a), reps=reps)

    def plain_all():
        for s in range(0, b, chunk):
            C.closure_plain(a[s:s + chunk])

    plain_ms = median_ms(plain_all, reps=5)
    nbytes = 2 * a.numel()              # read adj once, write reach once
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops = closure_ops(b, n)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # the TPU kernel's formulation: n_iter float squarings of N x N
    tpu_flop = C._n_iter(n) * 2 * n ** 3 * b
    row = {"kernel": "transitive_closure", "shape": label, "graphs": b,
           "nodes": n, "density": p,
           "edges_per_graph": int(a.sum()) / b,
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bytes": nbytes, "int32_ops": ops,
           "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "share_of_bound": bound_ms / ms,
           "squaring_flop_of_tpu_form": tpu_flop}
    log("kernel " + json.dumps(row))
    if err != 0:
        fail(f"transitive_closure differs from its plain version at "
             f"{label} (N={n}, p={p})")
    return row


def closure_phase():
    """The closure kernel against its plain version on seeded random
    graphs at the EPaxos step's shape and at 130 and 256 nodes."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 7)
    rows = []
    for label, b, n, p in CLOSURE_SHAPES:
        a = torch.rand((b, n, n), generator=gen, device=DEVICE) < p
        rows.append(closure_row(label, a, p))
        del a
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def closure_calls(wrap):
    """Route every closure call of the EPaxos step through ``wrap(real,
    adj)``, where ``real`` is the closure it would have called."""
    from paxi_tpu_torch.protocols.epaxos import sim as ep
    real = ep.transitive_closure
    ep.transitive_closure = lambda adj: wrap(real, adj)
    try:
        yield
    finally:
        ep.transitive_closure = real


def capture_path_graphs(step: int = PATH_GRAPH_STEP):
    """The ``(R*G, NN, NN)`` graphs the EPaxos path hands the closure at
    step ``step`` of its fault-free and its fuzzed run at 100,000 groups
    (the runs stop just after it)."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig, simulate
    graphs = {}
    for label, fuzz in (("fault_free", FAULT_FREE),
                        ("fuzz", FuzzConfig(**FUZZ_ARGS))):
        calls = [0]

        def grab(real, adj, label=label):
            if calls[0] == step:
                graphs[label] = adj.reshape(
                    (-1,) + tuple(adj.shape[-2:])).clone()
            calls[0] += 1
            return real(adj)

        with closure_calls(grab):
            simulate(sim_protocol("epaxos"),
                     SimConfig(**PATHS["epaxos"]["cfg"]), GROUPS, step + 1,
                     fuzz, seed=SEED, device=DEVICE)
    return graphs


def closure_path_phase():
    """The closure kernel on the EPaxos path's own graphs (captured at a
    mid-run step, fault-free and fuzzed), exact and timed."""
    rows = []
    for label, a in capture_path_graphs().items():
        rows.append(closure_row(f"epaxos_path_{label}", a))
        del a
        torch.cuda.empty_cache()
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


def card_vs_cpu_phase(path: str, proto, cfg, count: str):
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, simulate
    for label, fuzz in (("fault_free", FAULT_FREE),
                        ("fuzz", FuzzConfig(**FUZZ_ARGS))):
        t0 = time.perf_counter()
        on_cpu = simulate(proto, cfg, SMALL_GROUPS, SMALL_STEPS, fuzz,
                          seed=SEED, device="cpu")
        on_card = simulate(proto, cfg, SMALL_GROUPS, SMALL_STEPS, fuzz,
                           seed=SEED, device=DEVICE)
        compare_runs(on_cpu, on_card, f"{path} {label}")
        log("card_vs_cpu " + json.dumps({
            "protocol": path, "schedule": label, "groups": SMALL_GROUPS,
            "steps": SMALL_STEPS, "equal": True,
            count: int(on_card.metrics[count]),
            "violations": int(on_card.violations),
            "seconds": time.perf_counter() - t0}))


# ---- phase 4: the main paths --------------------------------------------

def main_path_run(path: str, proto, cfg, fuzz, label: str, smi: str,
                  fault_free: bool):
    from paxi_tpu_torch.sim import simulate

    spec = PATHS[path]
    steps = spec["steps"]
    warmup_s = None
    if fault_free:
        t0 = time.perf_counter()
        simulate(proto, cfg, GROUPS, WARMUP_STEPS, fuzz, seed=SEED + 1,
                 device=DEVICE)
        warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, steps, fuzz, seed=SEED,
                   device=DEVICE)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    n_types = len(proto.mailbox_spec(cfg))
    done = int(res.metrics[spec["count"]])
    row = {
        "schedule": label,
        "metric": spec["metric"],
        spec["metric"]: done / wall_s,
        **{k: int(res.metrics[k]) for k in ("committed_slots", "executed",
                                            "recovered")
           if k in res.metrics},
        "wall_s": wall_s, "warmup_s": warmup_s,
        "invariant_violations": int(res.violations),
        "inscan_violations": res.inscan_violations,
        "commit_latency": res.latency_summary(),
        "groups": GROUPS, "replicas": REPLICAS, "steps": steps,
        "config": spec["cfg"], "device": smi,
        "kernels": launches,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "counters": {k: int(v) for k, v in res.counters.items()},
    }
    log(spec["line"] + " " + json.dumps(row))
    if int(res.violations) != 0 or res.inscan_violations != 0:
        fail(f"{path} {label}: safety violations on the main path")
    if fault_free:
        want = spec["expect"](steps)
        got = {k: int(res.metrics[k]) for k in ("committed_slots",
                                                "executed")
               if k in res.metrics}
        if any(v != want for v in got.values()):
            fail(f"{path} {label}: {got} != {want}")
        if int(res.metrics.get("recovered", 0)) != 0:
            fail(f"{path} {label}: recovered instances on a fault-free run")
    want_launches = {"wheel_deliver": steps * n_types,
                     "wheel_insert": steps * n_types,
                     "transitive_closure": steps if path == "epaxos" else 0,
                     "make_remote_lane_shift": 0}
    for name, n in launches.items():
        if n != want_launches[name]:
            fail(f"{path} {label}: {name} launched {n} times, expected "
                 f"{want_launches[name]}")
    return row, res


def closure_events(acc):
    """Record CUDA events around every closure call of the EPaxos step
    (the kernel launch itself, not the layout copies around it)."""
    def timed(real, adj):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(adj)
        b.record()
        acc.append((a, b))
        return out

    return closure_calls(timed)


def step_split_phase(path: str, proto, cfg, fuzz, label: str,
                     n_steps: int = 8):
    """Device time of each stage of one lock-step round at the main
    path's shape, by CUDA events between the stages (the runner's
    ``_group_step`` sequence, after ``n_steps`` warm steps); for epaxos
    also the closure kernel's share of the protocol step."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.metrics.simcount import step_counts
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import lanes
    from paxi_tpu_torch.sim import mailbox as mb
    from paxi_tpu_torch.sim.runner import (flush_measurements, init_carry,
                                           make_scan_body)
    from paxi_tpu_torch.sim.types import StepCtx

    dev = torch.device(DEVICE)
    stages = ("deliver", "protocol_step", "faults_and_counts", "insert",
              "invariants", "flush")
    acc = {s: [] for s in stages}
    closure_ms = []
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, GROUPS, tr.PRNGKey(SEED), dev)
        body = make_scan_body(proto, cfg, fuzz)
        for t in range(n_steps):
            carry, _ = body(carry, t)
        for t in range(n_steps, 2 * n_steps):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
            cl = []
            state, wheel, fs, rng = carry
            ev[0].record()
            rng, k_step, k_fault, k_ins = tr.split(rng, 4)
            inbox, wheel = ops.wheel_deliver(wheel)
            ev[1].record()
            with closure_events(cl):
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
            closure_ms.append(sum(a.elapsed_time(b) for a, b in cl))
    split = {s: statistics.mean(v) for s, v in acc.items()}
    row = {"protocol": path, "schedule": label, "groups": GROUPS,
           "steps_timed": n_steps, "mean_ms": split,
           "total_ms": sum(split.values())}
    if path == "epaxos":
        row["closure_kernel_ms"] = statistics.mean(closure_ms)
        row["closure_share_of_protocol_step"] = (
            row["closure_kernel_ms"] / split["protocol_step"])
    log("step_split " + json.dumps(row))


def new_path_run(path: str, smi: str):
    """A new kernel's single-card run at 100,000 groups, fault-free, with
    its rate; its committed count and launch counts (read around it) must
    be the expected ones."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig, simulate

    spec = NEW_PATHS[path]
    proto, cfg = sim_protocol(path), SimConfig(**spec["cfg"])
    steps = spec["steps"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, steps, seed=SEED, device=DEVICE)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    done = int(res.metrics["committed_slots"])
    row = {"schedule": "fault_free", "metric": spec["metric"],
           spec["metric"]: done / wall_s, "committed_slots": done,
           "wall_s": wall_s, "invariant_violations": int(res.violations),
           "inscan_violations": res.inscan_violations,
           "commit_latency": res.latency_summary(),
           "groups": GROUPS, "steps": steps, "config": spec["cfg"],
           "device": smi, "kernels": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           **{k: int(v) for k, v in res.metrics.items()
              if k in ("steals", "commands_proposed")}}
    log(spec["line"] + " " + json.dumps(row))
    if int(res.violations) != 0 or res.inscan_violations != 0:
        fail(f"{path}: safety violations")
    if done != spec["expect"]:
        fail(f"{path}: committed {done}, expected {spec['expect']}")
    n_types = len(proto.mailbox_spec(cfg))
    want_launches = {"wheel_deliver": steps * n_types,
                     "wheel_insert": steps * n_types,
                     "transitive_closure": 0, "make_remote_lane_shift": 0}
    if launches != want_launches:
        fail(f"{path}: kernel launches {launches}, expected "
             f"{want_launches}")
    return row


# ---- phase 5: capture, replay, shrink, scenarios, checkpoints -------------

def geo_fuzz(drop: float = GEO_DROP):
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FuzzConfig
    return FuzzConfig(p_drop=drop, scenario=NAMED["wan3z"])


def expect_launches(label: str, launches, steps: int, n_types: int) -> None:
    want = {"wheel_deliver": steps * n_types,
            "wheel_insert": steps * n_types,
            "transitive_closure": 0, "make_remote_lane_shift": 0}
    if launches != want:
        fail(f"{label}: kernel launches {launches}, expected {want}")


def meta_of(trace) -> dict:
    """A trace's meta as its file stores it (JSON-normalized)."""
    return json.loads(json.dumps(trace.meta))


def witness_phase(smi: str):
    """The thin-Q1 geo witness at GROUPS groups: capture (every group's
    schedule recorded on the card), two replays, a save/load round trip and
    its replay; then the real wpaxos under the same schedule.  Returns the
    trace and the capture's launch counts."""
    import os
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig, simulate

    proto, cfg, fuzz = (sim_protocol("wpaxos_thinq1"),
                        SimConfig(**WITNESS_CFG), geo_fuzz())
    n_types = len(proto.mailbox_spec(cfg))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr_ = T.capture(proto, cfg, fuzz, SEED, GROUPS, WITNESS_STEPS,
                    device=DEVICE)
    capture_s = time.perf_counter() - t0
    launches = capture_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if tr_ is None:
        fail("wpaxos_thinq1 under GEO3Z found no violating group")
    expect_launches("witness capture", launches, WITNESS_STEPS, n_types)
    m = tr_.meta
    sched_bytes = sum(v.nbytes for v in (tr_.sched["conn"],
                                         tr_.sched["crashed"]))
    sched_bytes += sum(v.nbytes for f in tr_.sched["faults"].values()
                       for v in f.values())
    log("witness_path " + json.dumps({
        "phase": "capture", "protocol": "wpaxos_thinq1",
        "schedule": "GEO3Z (p_drop 0.05, wan3z)", "groups": GROUPS,
        "steps": WITNESS_STEPS, "config": WITNESS_CFG, "group": m["group"],
        "group_violations": m["group_violations"],
        "first_violation_step": m["first_violation_step"],
        "n_events": tr_.n_events(), "wall_s": capture_s,
        "recorded_schedule_bytes": sched_bytes * GROUPS,
        "peak_memory_bytes": peak, "kernels": launches,
        "schedule_hash": m["schedule_hash"], "device": smi}))

    reset_launch_counts()
    t0 = time.perf_counter()
    r = T.check_determinism(tr_, device=DEVICE)
    replay_s = (time.perf_counter() - t0) / 2
    launches = launch_counts()
    expect_launches("witness replays", launches, 2 * WITNESS_STEPS, n_types)
    for what, got, want in (
            ("state hash", r.state_hash, m["capture_state_hash"]),
            ("counters", r.counters, m["capture_counters"]),
            ("latency histogram", r.lat_hist, m.get("capture_lat_hist")),
            ("violations", r.violations, m["group_violations"])):
        if got != want:
            fail(f"witness replay: {what} {got} != capture's {want}")

    os.makedirs(SCRATCH_DIR, exist_ok=True)
    t0 = time.perf_counter()
    path = T.save(os.path.join(SCRATCH_DIR, "witness"), tr_)
    loaded = T.load(path)
    io_s = time.perf_counter() - t0
    if meta_of(loaded) != meta_of(tr_):
        fail("witness trace: the loaded meta differs from the saved one")
    r2 = T.replay(loaded, device=DEVICE)
    if r2.state_hash != m["capture_state_hash"] \
            or r2.counters != m["capture_counters"]:
        fail("witness trace: the loaded trace replays to another state")
    log("witness_path " + json.dumps({
        "phase": "replay", "replays": 3, "replay_wall_s": replay_s,
        "state_hash": r.state_hash, "equal_to_capture": True,
        "violations": r.violations,
        "first_violation_step": r.first_violation_step(),
        "file_bytes": os.path.getsize(path), "save_load_s": io_s,
        "kernels_two_replays": launches}))

    reset_launch_counts()
    t0 = time.perf_counter()
    real = simulate(sim_protocol("wpaxos"), cfg, GROUPS, WITNESS_STEPS, fuzz,
                    seed=SEED, device=DEVICE)
    real_s = time.perf_counter() - t0
    launches = launch_counts()
    log("witness_path " + json.dumps({
        "phase": "real_wpaxos", "groups": GROUPS, "steps": WITNESS_STEPS,
        "invariant_violations": int(real.violations),
        "inscan_violations": real.inscan_violations,
        "committed_slots": int(real.metrics["committed_slots"]),
        "wall_s": real_s, "kernels": launches}))
    if int(real.violations) != 0 or real.inscan_violations != 0:
        fail("the real wpaxos violates under the witness's schedule")
    expect_launches("real wpaxos", launches, WITNESS_STEPS, n_types)
    return capture_launches


def hunt_phase():
    """The same case at the hunt's 16 groups: the record run on the card
    against the CPU's (every schedule plane, the per-group violations, the
    trace), then ``shrink`` on the card."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    from paxi_tpu_torch.sim.checkpoint import flatten
    from paxi_tpu_torch.sim.runner import make_recorded_run

    proto, cfg, fuzz = (sim_protocol("wpaxos_thinq1"),
                        SimConfig(**WITNESS_CFG), geo_fuzz())
    t0 = time.perf_counter()
    recs = {dev: make_recorded_run(proto, cfg, fuzz, device=dev)(
        tr.PRNGKey(SEED), HUNT_GROUPS, WITNESS_STEPS)
        for dev in ("cpu", DEVICE)}
    a, b = (flatten({"sched": r[4], "viol_steps": r[3], "state": r[0]})
            for r in (recs["cpu"], recs[DEVICE]))
    for k in a:
        if a[k].dtype != b[k].dtype or not (a[k] == b[k]).all():
            fail(f"hunt capture: {k} differs between CPU and card")
    traces = {dev: T.capture(proto, cfg, fuzz, SEED, HUNT_GROUPS,
                             WITNESS_STEPS, device=dev)
              for dev in ("cpu", DEVICE)}
    if traces["cpu"] is None or \
            meta_of(traces["cpu"]) != meta_of(traces[DEVICE]):
        fail("hunt capture: the card's trace differs from the CPU's")
    tr_ = traces[DEVICE]
    log("witness_card_vs_cpu " + json.dumps({
        "groups": HUNT_GROUPS, "steps": WITNESS_STEPS, "equal": True,
        "planes_compared": len(a), "group": tr_.meta["group"],
        "group_violations": tr_.meta["group_violations"],
        "first_violation_step": tr_.meta["first_violation_step"],
        "total_violations": int(recs["cpu"][2]),
        "capture_state_hash": tr_.meta["capture_state_hash"],
        "seconds": time.perf_counter() - t0}))

    reset_launch_counts()
    t0 = time.perf_counter()
    mini, stats = T.shrink(tr_, max_trials=SHRINK_TRIALS, device=DEVICE)
    shrink_s = time.perf_counter() - t0
    launches = launch_counts()
    r = T.replay(mini, device=DEVICE)
    log("shrink_path " + json.dumps({
        "groups": HUNT_GROUPS, **stats, "wall_s": shrink_s,
        "replay_violations": r.violations,
        "replay_state_hash": r.state_hash, "kernels": launches}))
    if stats["events_after"] > stats["events_before"]:
        fail("shrink grew the trace")
    if not r.violations > 0 or r.violations != mini.meta["group_violations"]:
        fail("the shrunk trace does not violate as recorded")
    if r.state_hash != mini.meta["replay_state_hash"]:
        fail("the shrunk trace replays to another state")


def scenario_phase(smi: str):
    """bench_all.py's wpaxos_wan3z_geo row at GROUPS groups: wpaxos 3 x 3
    under the wan3z matrix alone; the zone-local and cross-zone commit
    latency split."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.scenarios import NAMED, latency_split, with_scenario
    from paxi_tpu_torch.sim import FAULT_FREE, SimConfig, simulate

    proto, cfg = sim_protocol("wpaxos"), SimConfig(**SCENARIO_CFG)
    fuzz = with_scenario(FAULT_FREE, NAMED["wan3z"])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, SCENARIO_STEPS, fuzz, seed=SEED,
                   device=DEVICE)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    done = int(res.metrics["committed_slots"])
    row = {"protocol": "wpaxos", "schedule": "wan3z (fault-free inside)",
           "groups": GROUPS, "steps": SCENARIO_STEPS, "config": SCENARIO_CFG,
           "wheel_depth": fuzz.wheel, "committed_slots": done,
           "committed_wpaxos_slots_per_sec": done / wall_s,
           **latency_split({k: int(v) for k, v in res.metrics.items()}),
           "steals": int(res.metrics["steals"]),
           "invariant_violations": int(res.violations),
           "inscan_violations": res.inscan_violations,
           "commit_latency": res.latency_summary(), "wall_s": wall_s,
           "kernels": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "counters": {k: int(v) for k, v in res.counters.items()},
           "device": smi}
    log("scenario_path " + json.dumps(row))
    if int(res.violations) != 0 or res.inscan_violations != 0:
        fail("wpaxos under wan3z: safety violations")
    if done <= 0 or "commit_lat_cross_rounds" not in row:
        fail("wpaxos under wan3z committed nothing across zones")
    expect_launches("scenario path", launches, SCENARIO_STEPS,
                    len(proto.mailbox_spec(cfg)))
    return row


def checkpoint_phase(smi: str, straight):
    """The fuzzed paxos path at GROUPS groups, resumed from a checkpoint:
    CHECKPOINT_SPLIT steps through ``continue_run``, ``save_carry``,
    ``load_carry``, the rest; equal to ``straight``, phase 4's run of the
    same seed and schedule."""
    import os
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import (FuzzConfig, SimConfig, continue_run,
                                    load_carry, save_carry)
    from paxi_tpu_torch.sim.runner import init_carry
    from paxi_tpu_torch.trace import state_hash

    spec = PATHS["paxos"]
    proto, cfg = sim_protocol("paxos"), SimConfig(**spec["cfg"])
    fuzz, steps = FuzzConfig(**FUZZ_ARGS), spec["steps"]
    dev = torch.device(DEVICE)
    reset_launch_counts()
    carry = init_carry(proto, cfg, fuzz, GROUPS, tr.PRNGKey(SEED), dev)
    first, carry = continue_run(proto, cfg, carry, 0, CHECKPOINT_SPLIT,
                                fuzz)
    os.makedirs(SCRATCH_DIR, exist_ok=True)
    path = os.path.join(SCRATCH_DIR, "paxos_carry.npz")
    t0 = time.perf_counter()
    save_carry(path, carry, {"step": CHECKPOINT_SPLIT})
    save_s = time.perf_counter() - t0
    like = init_carry(proto, cfg, fuzz, GROUPS, tr.PRNGKey(SEED + 1), dev)
    del carry
    t0 = time.perf_counter()
    carry, meta = load_carry(path, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    second, carry = continue_run(proto, cfg, carry, CHECKPOINT_SPLIT,
                                 steps - CHECKPOINT_SPLIT, fuzz)
    launches = launch_counts()
    h_straight, h_resumed = state_hash(straight.state), state_hash(
        second.state)
    diff = [k for k, v in straight.metrics.items()
            if int(v) != int(second.metrics[k]) + (
                int(first.metrics[k]) if k.startswith("net_") else 0)]
    viols = int(first.violations) + int(second.violations)
    log("checkpoint_path " + json.dumps({
        "protocol": "paxos", "groups": GROUPS, "steps": steps,
        "split_at": CHECKPOINT_SPLIT, "fuzz": FUZZ_ARGS,
        "file_bytes": os.path.getsize(path), "save_s": save_s,
        "load_s": load_s, "meta": meta, "state_hash": h_resumed,
        "equal_to_straight_run": h_straight == h_resumed and not diff,
        "committed_slots": int(second.metrics["committed_slots"]),
        "invariant_violations": viols, "kernels": launches,
        "device": smi}))
    if h_straight != h_resumed:
        fail("the resumed paxos run's state differs from the straight run")
    if diff or viols != int(straight.violations) or viols != 0:
        fail(f"the resumed paxos run differs in {diff} or violates")
    expect_launches("checkpoint path", launches, steps,
                    len(proto.mailbox_spec(cfg)))
    os.remove(path)


# ---- the ring shift (make_remote_lane_shift) -----------------------------

def epaxos_planes(groups: int, device, seed: int):
    """Every plane of an epaxos state of ``groups`` groups at the main
    path's configuration, filled with seeded random values of its dtype
    (the shift moves bytes; what they hold does not matter to it)."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    state = sim_protocol("epaxos").init_state(
        SimConfig(**PATHS["epaxos"]["cfg"]), None, groups, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = {}
    for k, v in state.items():
        if v.dtype == torch.bool:
            out[k] = torch.rand(v.shape, generator=gen, device=device) < 0.5
        else:
            out[k] = torch.randint(-2 ** 31, 2 ** 31 - 1, v.shape,
                                   generator=gen, device=device,
                                   dtype=v.dtype)
    return out


def shift_check(shift, mesh, planes) -> int:
    """Max abs difference of ``shift.many`` over every plane and the plain
    version plane by plane (launches made here are not counted by any
    path)."""
    from paxi_tpu_torch.ops import exchange as ops
    vals = list(planes.values())
    err = 0
    for got, x in zip(shift.many(vals), vals):
        want = ops.lane_shift_plain(x, mesh)
        err = max(err, int((got.long() - want.long()).abs().max()))
    shift.check()
    return err


def shift_world1_phase():
    """The shift at world 1 over every plane of an epaxos state at the
    main path's 100,000 groups: exact against the plain version (over
    ``shift.many`` and plane by plane), timed beside the plain version and
    ``out.copy_(x)``, each as SHIFT_INNER calls back to back (the next
    call's host set-up overlaps the card's work); ``shift.many`` and
    ``out.copy_(x)`` also one call an event pair, where the card waits for
    the host set-up of every call."""
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=DEVICE)
    planes = epaxos_planes(GROUPS, mesh.device, SEED + 11)
    vals = list(planes.values())
    shift = ops.make_remote_lane_shift(mesh)
    err = shift_check(shift, mesh, planes)
    for x in vals:
        err = max(err, int((shift(x).long() - x.long()).abs().max()))
    nbytes = sum(x.numel() * x.element_size() for x in vals)
    outs = [torch.empty_like(x) for x in vals]
    ms = median_ms(lambda: shift.many(vals), inner=SHIFT_INNER)
    single_ms = median_ms(lambda: shift.many(vals))
    per_plane_ms = median_ms(lambda: [shift(x) for x in vals],
                             inner=SHIFT_INNER)
    plain_ms = median_ms(lambda: [ops.lane_shift_plain(x, mesh)
                                  for x in vals], inner=SHIFT_INNER)
    library_ms = median_ms(lambda: [o.copy_(x) for o, x in zip(outs, vals)],
                           inner=SHIFT_INNER)
    library_single_ms = median_ms(
        lambda: [o.copy_(x) for o, x in zip(outs, vals)])
    shift.close()
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    row = {"kernel": "make_remote_lane_shift", "world": 1,
           "shape": "epaxos state planes", "groups": GROUPS,
           "planes": len(vals), "max_abs_err": err, "ms": ms,
           "launches_a_call": 1, "ms_plane_by_plane": per_plane_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "out.copy_(x)", "bytes": nbytes, "bound_ms": bound_ms,
           "bound_by": "bytes", "share_of_bound": bound_ms / ms,
           "calls_a_timed_run": SHIFT_INNER, "ms_single_call": single_ms,
           "library_ms_single_call": library_single_ms}
    log("kernel " + json.dumps(row))
    if err != 0:
        fail("make_remote_lane_shift differs from its plain version at "
             "world 1")
    del planes, vals, outs
    torch.cuda.empty_cache()
    return row


# ---- phase 6: four ranks on the one card ---------------------------------

def sharded_case(mesh, name: str, cfg_kw, fuzz_kw, n_groups: int,
                 n_steps: int):
    """One sharded run, gathered on every rank; rank 0 returns
    ``(state, metrics, violations)`` as numpy, the others None."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.parallel import gather_state, make_sharded_run
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig

    run = make_sharded_run(sim_protocol(name), SimConfig(**cfg_kw),
                           FuzzConfig(**fuzz_kw), mesh)
    state, metrics, viol = run(tr.PRNGKey(SEED), n_groups, n_steps)
    whole = gather_state(state, mesh, n_groups)
    if mesh.rank:
        return None
    return ({k: v.cpu().numpy() for k, v in whole.items()},
            {k: int(v) for k, v in metrics.items()}, int(viol))


def sharded_checks():
    """phase 6's card-against-CPU cases: (label, protocol, config, fuzz)."""
    return [(f"{name}_{label}", name, cfg, fz)
            for name, cfg in SHARDED_CHECKS.items()
            for label, fz in (("fault_free", {}), ("fuzz", FUZZ_ARGS))]


def sharded_small_rank(mesh):
    """The card-against-CPU cases on one rank (run on either device)."""
    return {label: sharded_case(mesh, name, cfg, fz, SMALL_GROUPS,
                                SMALL_STEPS)
            for label, name, cfg, fz in sharded_checks()}


def card_rank(mesh):
    """Everything phase 6 does on one rank sharing the card."""
    import torch.distributed as dist
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.dryrun import dryrun_multichip
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.parallel import make_sharded_run
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, SimConfig

    out = {"rank": mesh.rank, "device": str(mesh.device)}
    # the shift against its plain version at 25,000 groups a rank
    planes = epaxos_planes(GROUPS // mesh.world, mesh.device,
                           SEED + 100 + mesh.rank)
    vals = list(planes.values())
    shift = ops.make_remote_lane_shift(mesh)
    out["shift_err"] = shift_check(shift, mesh, planes)
    out["shift_bytes"] = sum(x.numel() * x.element_size() for x in vals)
    dist.barrier(group=mesh.group)
    out["shift_ms"] = median_ms(lambda: shift.many(vals), reps=10)
    dist.barrier(group=mesh.group)
    out["shift_plain_ms"] = median_ms(
        lambda: [ops.lane_shift_plain(x, mesh) for x in vals], reps=3)
    # the shift's own path: every shard once around the ring, back home
    dist.barrier(group=mesh.group)
    reset_launch_counts()
    t0 = time.perf_counter()
    cur = vals
    for _ in range(mesh.world):
        cur = shift.many(cur)
    shift.check()
    out["ring_wall_s"] = time.perf_counter() - t0
    out["ring_launches"] = launch_counts()
    out["ring_home"] = all(torch.equal(a, b) for a, b in zip(cur, vals))
    shift.close()
    del planes, vals, cur
    torch.cuda.empty_cache()
    # the sharded runs on the card, compared with the CPU's by the parent
    out["small"] = sharded_small_rank(mesh)
    out["dryrun"] = dryrun_multichip(mesh, verbose=False)
    # the full-width sharded north star
    spec = PATHS["paxos"]
    run = make_sharded_run(sim_protocol("paxos"), SimConfig(**spec["cfg"]),
                           FAULT_FREE, mesh)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    dist.barrier(group=mesh.group)
    reset_launch_counts()
    t0 = time.perf_counter()
    _, metrics, viol = run(tr.PRNGKey(SEED), GROUPS, spec["steps"])
    torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)
    out["north_star"] = {
        "wall_s": time.perf_counter() - t0,
        "launches": launch_counts(),
        "metrics": {k: int(v) for k, v in metrics.items()},
        "violations": int(viol),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(mesh.device)}
    return out


def four_ranks_phase(smi: str):
    """Phase 6: four ranks on the one card, then the same sharded runs on
    four CPU ranks for the comparison.  Returns the four-rank shift row
    and the sharded north star's row."""
    from paxi_tpu_torch.parallel.launch import spawn
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig

    t0 = time.perf_counter()
    ranks = spawn(SHARD_WORLD, card_rank, backend="gloo", device=DEVICE,
                  timeout=900)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = spawn(SHARD_WORLD, sharded_small_rank, device="cpu",
                   timeout=900)[0]
    cpu_s = time.perf_counter() - t0

    # the shift over four ranks
    err = max(r["shift_err"] for r in ranks)
    ring_launches = sum(r["ring_launches"]["make_remote_lane_shift"]
                        for r in ranks)
    nbytes = ranks[0]["shift_bytes"]
    shift_row = {"kernel": "make_remote_lane_shift", "world": SHARD_WORLD,
           "ranks_share_one_card": True,
           "shape": "epaxos state planes", "groups_per_rank":
               GROUPS // SHARD_WORLD, "max_abs_err": err,
           "ms_by_rank": [r["shift_ms"] for r in ranks],
           "plain_ms_by_rank": [r["shift_plain_ms"] for r in ranks],
           "library": None,
           "library_note": "no one PyTorch call: NCCL refuses two ranks on "
                           "one card, and gloo moves through the host",
           "bytes_per_rank": nbytes,
           "bound_ms": SHARD_WORLD * 2 * nbytes / HBM_BYTES_PER_S * 1e3,
           "ring_wall_s_by_rank": [r["ring_wall_s"] for r in ranks],
           "ring_launches": ring_launches,
           "ring_home": all(r["ring_home"] for r in ranks)}
    log("kernel " + json.dumps(shift_row))
    if err != 0:
        fail("make_remote_lane_shift differs from its plain version over "
             "four ranks")
    if not shift_row["ring_home"]:
        fail("a shard did not come home after one turn of the ring")
    # ranks x turns calls of shift.many, two launches (send, receive) a
    # call whatever the planes
    want = SHARD_WORLD * SHARD_WORLD * 2
    if ring_launches != want:
        fail(f"the ring path launched the shift {ring_launches} times, "
             f"expected {want}")

    # the sharded runs: card against CPU
    card_small = ranks[0]["small"]
    for label, name, cfg, fz in sharded_checks():
        (sa, ma, va), (sb, mb, vb) = on_cpu[label], card_small[label]
        for k in sa:
            if sa[k].dtype != sb[k].dtype or not (sa[k] == sb[k]).all():
                fail(f"sharded {label}: state plane {k} differs between "
                     "CPU and card")
        if ma != mb or va != vb:
            fail(f"sharded {label}: metrics or violations differ: "
                 f"{ma} {va} vs {mb} {vb}")
        if vb != 0:
            fail(f"sharded {label}: {vb} violations")
        log("sharded_card_vs_cpu " + json.dumps({
            "case": label, "protocol": name, "world": SHARD_WORLD,
            "groups": SMALL_GROUPS, "steps": SMALL_STEPS, "equal": True,
            "committed_slots": mb["committed_slots"], "violations": vb}))

    # dryrun_multichip at world 4
    for name, res in ranks[0]["dryrun"].items():
        log("dryrun_multichip " + json.dumps({
            "world": SHARD_WORLD, "protocol": name,
            "committed_slots": res["metrics"]["committed_slots"],
            "violations": res["violations"]}))

    # the sharded north star
    ns = [r["north_star"] for r in ranks]
    m = ns[0]["metrics"]
    steps = PATHS["paxos"]["steps"]
    row = {"protocol": "paxos", "world": SHARD_WORLD,
           "ranks_share_one_card": True,
           "note": "correctness, not a rate: four processes time-slicing "
                   "one card say nothing about four cards",
           "groups": GROUPS, "groups_per_rank": GROUPS // SHARD_WORLD,
           "replicas": REPLICAS, "steps": steps,
           "config": PATHS["paxos"]["cfg"],
           "committed_slots": m["committed_slots"],
           "invariant_violations": ns[0]["violations"],
           "inscan_violations": m["inscan_violations"],
           "wall_s": max(n["wall_s"] for n in ns),
           "peak_memory_bytes_by_rank": [n["peak_memory_bytes"] for n in ns],
           "kernels": {k: sum(n["launches"][k] for n in ns)
                       for k in ns[0]["launches"]},
           "card_phase_s": card_s, "cpu_phase_s": cpu_s, "device": smi}
    log("sharded_path " + json.dumps(row))
    want = PATHS["paxos"]["expect"](steps)
    if m["committed_slots"] != want:
        fail(f"sharded north star committed {m['committed_slots']}, "
             f"expected {want}")
    if ns[0]["violations"] != 0 or m["inscan_violations"] != 0:
        fail("sharded north star: safety violations")
    n_types = len(sim_protocol("paxos").mailbox_spec(
        SimConfig(**PATHS["paxos"]["cfg"])))
    for n in ns:
        if n["launches"]["wheel_deliver"] != steps * n_types \
                or n["launches"]["wheel_insert"] != steps * n_types:
            fail(f"sharded north star: a rank's exchange launches "
                 f"{n['launches']} != {steps * n_types}")
    return shift_row, row


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
    _build.build(["exchange", "closure", "lane_shift"])
    build_s = time.perf_counter() - t0
    log("device " + json.dumps({
        "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s, "nvcc_s": _build.BUILD_SECONDS}))

    protos = {p: sim_protocol(p) for p in PATHS}
    cfgs = {p: SimConfig(**PATHS[p]["cfg"]) for p in PATHS}

    # 2. kernels against their plain versions (the exchange also on the
    # wpaxos mailbox at the six-slot wheel of the wan3z scenario)
    xrows = {p: exchange_phase(p, protos[p].mailbox_spec(cfgs[p]))
             for p in PATHS}
    wan_cfg = SimConfig(**SCENARIO_CFG)
    xrows["wpaxos_wan3z"] = exchange_phase(
        "wpaxos", sim_protocol("wpaxos").mailbox_spec(wan_cfg),
        depths=(geo_fuzz().wheel,), replicas=wan_cfg.n_replicas)
    crows = closure_phase()
    prows = closure_path_phase()
    srow = shift_world1_phase()

    # 3. the card against the CPU
    for p in PATHS:
        card_vs_cpu_phase(p, protos[p], cfgs[p], PATHS[p]["count"])
    for p in NEW_PATHS:
        card_vs_cpu_phase(p, sim_protocol(p), SimConfig(**NEW_PATHS[p]["cfg"]),
                          "committed_slots")

    # 4. the main paths, fault-free then fuzzed, and a step's split
    free, fuzzed = {}, {}
    for p in PATHS:
        free[p] = main_path_run(p, protos[p], cfgs[p], FAULT_FREE,
                                "fault_free", smi, True)[0]
        fuzzed[p] = main_path_run(p, protos[p], cfgs[p],
                                  FuzzConfig(**FUZZ_ARGS), "fuzz", smi,
                                  False)[1]
    for p in PATHS:
        step_split_phase(p, protos[p], cfgs[p], FAULT_FREE, "fault_free")
        step_split_phase(p, protos[p], cfgs[p], FuzzConfig(**FUZZ_ARGS),
                         "fuzz")
    for p in NEW_PATHS:
        new_path_run(p, smi)

    # 5. capture, replay, shrink, the scenario path and a checkpoint
    witness_launches = witness_phase(smi)
    hunt_phase()
    scenario = scenario_phase(smi)
    checkpoint_phase(smi, fuzzed.pop("paxos"))
    del fuzzed

    # 6. four ranks on the one card
    shift4, north = four_ranks_phase(smi)

    # 7. the kernel summary: launches from the epaxos main path (the one
    # that runs all three earlier kernels), by path beside them; the shift
    # from its own path (phase 6's ring), since no run path calls it
    launches = free["epaxos"]["kernels"]
    by_path = {k: {**{p: free[p]["kernels"][k] for p in PATHS},
                   "sharded_north_star": north["kernels"][k],
                   "witness_capture": witness_launches[k],
                   "scenario_path": scenario["kernels"][k]}
               for k in launches}
    kernels = []
    for kname, replaces in (("wheel_deliver", "paxi_tpu/ops/exchange.py:93"),
                            ("wheel_insert", "paxi_tpu/ops/exchange.py:140")):
        row = xrows["epaxos"][(kname, 1)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "paxi_tpu_torch/ops/csrc/exchange.cu",
            "replaces": replaces, "launches": launches[kname],
            "launches_by_path": by_path[kname],
            "max_abs_err": max(r["max_abs_err"] for x in xrows.values()
                               for (k, _), r in x.items() if k == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "wpaxos_wan3z_d6": {k: xrows["wpaxos_wan3z"][(kname, 6)][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "share_of_bound")}})
    row = crows[0]              # main-path shape, the sparser density
    kernels.append({
        "name": "transitive_closure", "route": "cuda",
        "source": "paxi_tpu_torch/ops/csrc/closure.cu",
        "replaces": "paxi_tpu/ops/closure.py:52",
        "launches": launches["transitive_closure"],
        "launches_by_path": by_path["transitive_closure"],
        "max_abs_err": max(r["max_abs_err"] for r in crows + prows),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None,
        "ms_epaxos_path_graphs": {r["shape"]: r["ms"] for r in prows}})
    kernels.append({
        "name": "make_remote_lane_shift", "route": "cuda",
        "source": "paxi_tpu_torch/ops/csrc/lane_shift.cu",
        "replaces": "paxi_tpu/ops/exchange.py:182",
        "launches": shift4["ring_launches"],
        "launches_by_path": {**by_path["make_remote_lane_shift"],
                             "ring_four_ranks": shift4["ring_launches"]},
        "max_abs_err": max(srow["max_abs_err"], shift4["max_abs_err"]),
        "ms": srow["ms"], "plain_ms": srow["plain_ms"],
        "bound_ms": srow["bound_ms"], "bound_by": "bytes",
        "library_ms": srow["library_ms"],
        "calls_a_timed_run": srow["calls_a_timed_run"],
        "ms_single_call": srow["ms_single_call"],
        "library_ms_single_call": srow["library_ms_single_call"],
        "plain_ms_four_ranks_one_card": shift4["plain_ms_by_rank"],
        "ms_four_ranks_one_card": shift4["ms_by_rank"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
