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
   the two exchange kernels, one launch a half over every message type of
   a step, at 100,000 groups x 5 replicas for the paxos and the epaxos
   mailbox (wheel depth 1 and 3) and at 9 replicas for the wpaxos mailbox
   at the six-slot wheel of the wan3z scenario, the outbox planes laid as
   protocols send them (transposed ``dst_major`` views; the checks add
   planes broadcast over dst, misaligned slices and a ragged 13 groups),
   each timed alone, as the whole wrapper call and as its plain version,
   against the bytes bound of ``csrc/exchange.cu``; the closure
   kernel at the EPaxos execution step's shape (500,000 graphs of 80 nodes, two
   densities), on the graphs the EPaxos path itself hands the closure at
   step 30 of its fault-free and fuzzed runs, and at 130 and 256 nodes,
   and the ring shift (``make_remote_lane_shift``, one ``shift.many`` call
   a state) at world 1 over every plane of an epaxos state of 100,000
   groups; CUDA-event times (median), bytes moved, the bound, and for the
   shift ``out.copy_(x)`` as the library yardstick;
3. card against CPU: the same seed and a small shape (256 groups x 12
   steps) run on both devices
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
   launch of each exchange kernel a step;
5. record, replay, shrink, scenarios and checkpoints: the hunt's seeded
   bug (``wpaxos_thinq1``, 9 replicas in 3 zones, under p_drop 0.05 inside
   the wan3z zone-latency matrix) captured at 100,000 groups x 100 steps
   (every group's schedule recorded on the card), replayed twice and from
   its saved file to the capture's state hash, counters and latency
   histogram, and the real wpaxos under the same schedule with 0
   violations; the same case at the hunt's 16 groups recorded on the card
   and on the CPU (every plane equal), then shrunk on the card (4
   replays); wpaxos 3 x 3 under wan3z alone at 100,000 groups (bench_all's
   ``wpaxos_wan3z_geo``) with its zone-local and cross-zone latency; and
   the fuzzed paxos path resumed from a checkpoint (52 steps,
   ``save_carry``, ``load_carry``, 52 more) equal to the straight run;
6. four ranks sharing the card (``parallel.launch.spawn``, gloo): the
   shift kernel against its plain version at 25,000 groups a rank, both
   timed, and the shift's own path (every state rotated once around the
   ring by ``shift.many``, two launches a call, launch counts read around
   it); the sharded runs of paxos, sdpaxos and wpaxos
   at 256 groups x 12 steps, fault-free and fuzzed, against the same
   sharded runs on four CPU ranks (identical gathered state, metrics and
   violations); ``dryrun_multichip``; and the sharded north star, paxos
   at 100,000 groups x 5 x 64 for 104 steps over the four ranks, which
   must commit 10,000,000 slots with 0 violations (correctness: four
   processes time-slicing one card say nothing of four cards);
7. workloads (``bench_all.py --workload``'s matrix): paxos 3 x 16 x 64
   keys and the wpaxos 3 x 3 grid (16 objects over 32 keys) under the
   uniform, zipf99 and flash specs at 100,000 groups (paxos 120 steps,
   wpaxos 45), each read with its own launch counts, with the per-class
   latency split and, for wpaxos, the steals; paxos uniform and zipf99
   must commit 11,600,000 and wpaxos zipf99 steal at least 10 more than
   uniform; the lowering pin at full width (paxos_pg, the per-group
   kernel, against the lane-major run: equal kv planes and class counts
   under zipf99, both gated under flash); the time of the workload's hash
   planes at a step's shapes; every cell and paxos_pg card against CPU at
   64 groups x 12 steps, fault-free and fuzzed; and, inside phase 6's
   spawn, the sharded zipf99 paxos (global group ids), a padded paxos_pg
   run of 257 groups and a sharded pinned replay of a paxos_pg capture,
   each against its one-device run on the card; phase 2 also times the
   exchange kernels at the two new mailbox shapes (3 and 9 replicas);
8. the protocols of slice 8 (``bench_all.py``'s protocol rows at 100,000
   groups): ``abd_register``, ``chain_pipeline``, ``wankeeper_zones``,
   ``wankeeper_wan3z_geo`` (with its zone-local and cross-zone latency),
   ``blockchain_forks`` (under bench_all's FUZZ) and ``bpaxos_grid``, and
   kpaxos and dynamo at the hunt's configurations, each read with its own
   launch counts and held to its count (``PROTO_ROWS``); the seeded twins:
   ``wankeeper_nofloor`` at the hunt's BUG_DEMO case captured at 100,000
   groups x 80 steps (a violating group found, one replay equal to the
   capture) and ``bpaxos_noread`` at 100,000 groups (it must violate; card
   against CPU at 16 groups); every new kernel and twin card against
   CPU at 64 groups x 12 steps, fault-free and fuzzed; phase 2 also checks
   and times the exchange at the wankeeper (6 replicas, 9 types), bpaxos
   (7, 5 types) and blockchain (5, one type, wheel depth 2) mailboxes;
9. switchpaxos and the demo kernels (slice 9): the exchange pair at the
   switchpaxos mailbox (6 types, 22 planes; 5 replicas at wheel depth 1
   and 3, 3 replicas at the wan3z depth); ``bench_all.py``'s switchnet
   pair at 100,000 groups x 100 steps under wan3z (``switchpaxos_wan3z``
   beside ``paxos_wan3z_base``, the same geometry: the switch must
   commit at least a round sooner at the median) and the hunt's
   switchpaxos case under the seqchurn sequencer windows and DROP at
   100,000 x 140 (stamp gaps detected), each held to the JAX package's
   count (``SWITCH_ROWS``; seqchurn's includes the reference's own 74
   oracle and 227 in-scan violations at this width) with one launch of
   each exchange half a step; the ``switchpaxos_nogap`` twin captured at
   100,000 x 80 under DROP (a violating group found, one replay equal),
   and the seqchurn row's own violation captured and replayed the same
   way; switchpaxos fault-free and under DROP, PART, KILL and seqchurn
   at 64 x 12,
   nogap at 16 groups and the per-group ``fragile_counter`` and
   ``relay_churn`` demos at their hunt shapes, card against CPU (the
   twins and demos must violate); a step split of the three rows; the
   seqchurn witness is saved as the hunt's corpus seed;
10. the drivers (slice 10), each read with its own launch counts:
   ``cli.main`` in-process at the main path (``sim -algorithm paxos
   -groups 100000 -replicas 5 -slots 64 -steps 104``: 10,000,000
   committed, 0 violations, 104 launches of each exchange half) and one
   short ``python -m paxi_tpu_torch sim`` subprocess; a hunt
   micro-campaign through ``cli.main`` (``hunt run --protocols
   switchpaxos,switchpaxos_nogap --budget 1 --quick --shrink-trials 4``,
   host replay on, its corpus seeded with phase 9's 100k seqchurn
   witness): the nogap witness captured, shrunk and replayed to its hash,
   every witness classified by the host replay on the virtual-clock
   fabric (asyncio on the CPU; none unclassified), the 100k witness
   through the backlog with its coverage logged, each run's violations
   and progress equal to the CPU's; one line a witness (verdict, host
   outcome with its span count, the host replay's wall s), its host
   outcome read twice more from its file, equal to each other (spans
   included) and to the campaign's; the nogap run captured again on the
   CPU, its hash and host outcome equal to the card capture's; ``trace
   host --all`` over the 100k witness; ``scenario run -host`` (paxos
   under wan3z) equal to the JAX package's line on the CPU; the
   ``bench_all`` twin's ``paxos_3rep`` row at its card shape
   (16,384 groups x 104 steps: 1,638,400 committed); and the
   ``fuzz_soak`` twin's record of paxos x DROP x seed 0 (64 x 150) equal
   to the CPU's;
11. the bench twin and the sliding-window twins (slice 11): ``python -m
   paxi_tpu_torch.bench`` as a subprocess at the north star (10,000,000
   committed, 0 and 0 violations, exit code 0, the committed slots and
   latency histogram of phase 4's ``main_path``), its sweep (256, 4,096
   and 32,768 groups x 36 steps: 32 slots a group each, written under
   ``build/bench/``), then the worker in-process with the launches of its
   timed run counted (104 of each exchange half); the layout A/B,
   ``--kernel paxos_sw`` beside ``paxos`` at the same shape (equal
   committed slots, violations and latency sum; each one's rate and
   ``scripts/torch_step_profile.py`` profile, and ``paxos_sw``'s step
   split beside phase 4's of ``paxos``); the other four
   twins at their fixed-cell rows' shapes, seeds and counts
   (``SW_ROWS``); every twin card against CPU at 64 x 12 under DROP; and
   ``python -m paxi_tpu_torch.workload.demo`` on the card, its four
   stage lines equal to the CPU's;
12. the host-sync audit (slice 12): every kernel of the sim registry and
   every sliding-window twin at 1,024 groups, under the schedule its row
   runs (paxos and epaxos also fault-free, wpaxos under GEO3Z): 2 warm-up
   steps, then 4 steps of ``run_steps`` under
   ``torch.cuda.set_sync_debug_mode("warn")``, one line a run with its
   syncs a step and their ``file:line`` sites (each warning's innermost
   frame in the package); every site must be a line the port's lint
   (``python -m paxi_tpu_torch lint``) reports under PXK104 or PXK107,
   kept or baselined, and the flagged lines that never fired are printed
   as static-only; the phase must take under 30 s;
13. the host twins (slice 14): a hunt micro-campaign through ``cli.main``
   (``hunt run --protocols bpaxos_noread,relay_churn --budget 1 --quick
   --shrink-trials 4``, host replay on, no corpus seed): every witness
   classified on its twin (none unclassified; the noread and relay_churn
   controls ``reproduced``), each run's violations
   and progress equal to the CPU's, one line a witness with its host
   outcome read twice more from its file; phase 5's ``wpaxos_thinq1`` and
   phase 8's ``wankeeper_nofloor`` witnesses (100k captures) classified
   twice each, equal, a verdict with a host outcome replayed twice more;
   ``scenario run -host`` for epaxos, wpaxos (3 x 3) and wankeeper (3 x
   3, 24 steps) under wan3z and relay_churn under churn, each equal to
   the JAX package's line on the CPU (``SCENARIO_TWIN_LINES``); the phase
   must take under 60 s;
14. serving (slice 15; asyncio on the card machine's CPU, no kernel, the
   launch counts read 0): ``python -m paxi_tpu_torch server -simulation``
   (paxos x 3, head sampling 0.2) as a process and ``client -N 200``
   against it as a process (exit 0, 0 errors, 0 anomalies), ``metrics
   -url`` scraped from it, ``spans render|export`` over every node's
   ``GET /spans`` (0 orphans); ``bench-host`` closed loop with
   ``-trace_sample`` (0 anomalies, its span phases); ``python -m
   paxi_tpu_torch.bench_host`` at ``BENCH_HOST_T=1`` over its CONFIGS but
   wpaxos (``BENCH_HOST_SKIP``: the reference's own steal livelock), every
   linearizable row 0 anomalies and 0 errors, dynamo and blockchain
   ``eventual``; ``python -m paxi_tpu_torch.soak_host`` on paxos at
   ``SOAK_HOST_T=4`` (0 anomalies); the sweep and the soak run in their
   own processes beside the server and the client, and the soak, whose
   fault windows hold an op they catch for the 10 s request timeout (13
   or 33 s a run, in both packages), goes on beside phase 15 and is read
   after it; the native checker built,
   and on the client history's largest key equal to the pure-Python
   loop.  One line a row: ops/s, p50/p99, errors, anomalies, the card's
   ``nvidia-smi`` line and the host CPU's model (host figures); the
   phase must take under 45 s;
15. the sharded tier (slice 16; asyncio on the card machine's CPU and the
   stale-read checker's tensor code, no kernel, the launch counts read
   0): ``python -m paxi_tpu_torch bench-host --shards 2 -shard_fleet 6
   -shard_workers 2 -rates 300,800 -step_s 1.5 -K 64 -txns 4 -migrate
   -routers 2`` as a process (the reference's shard smoke, with a
   stateless secondary router), its artifact held to that smoke's
   assertions (the disjoint, crossing and migrate phases each completing
   ops, 0 anomalies, 2PC committed with 0 atomicity violations, router
   forwards, the migration complete with keys installed and its
   seeded-keys oracle clean, blip and steady p99 reported) and one
   ``shard_row`` line (host figures); beside it one traced cross-shard
   2PC on a virtual-clock fabric, stitched into one tree over both groups
   with 0 orphans (``shard_spans``), and ``sim/lincheck``'s
   ``stale_read_anomalies`` on the card at 100k groups x 16 ops, equal to
   the CPU's, every planted stale, future and initial-value read found
   (``sim_lincheck``); the phase must take under 25 s;
16. the kernel summary line, the ``nvidia-smi`` line, and last the result
   line ``{"ok": true, "device": {...}}``.

The rows of phases 4, 8 and 9 and the hunt cases come from the drivers
themselves: ``paxi_tpu_torch.bench_all._cfgs`` at the card's shapes and
``paxi_tpu_torch.hunt.cases``.

It needs one card, imports nothing of JAX, and exits non-zero when CUDA
is not available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from paxi_tpu_torch import bench_all
from paxi_tpu_torch.hunt import cases as hunt_cases

DEVICE = "cuda"
SEED = 0
GROUPS, REPLICAS = 100_000, 5
SHARD_WORLD = 4                      # ranks sharing the card in phase 6
# the card-against-CPU runs (phases 3 and 6); 60 steps until phase 5
# came, 30 until phase 8 did, 20 until phase 13 did
SMALL_GROUPS, SMALL_STEPS = 256, 12
WARMUP_STEPS = 8                     # the main paths' warm-up run
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
# H100 SXM int32 lanes: 64 a clock an SM, 132 SMs at 1.98 GHz (NVIDIA's
# Hopper white paper); the closure kernel's word updates run there
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TIMED_REPS = 20
EXCHANGE_LAUNCHES_A_STEP = 1         # each exchange half, every message type
SHIFT_INNER = 4                      # shift calls a timed run (world 1)
FUZZ_ARGS = dict(p_drop=0.1, max_delay=3)


def non_default(obj) -> dict:
    """A config dataclass's fields that differ from their defaults, as
    keywords (a row's ``cfg``, a schedule's arguments)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) != f.default}


def cfg_kwargs(cfg) -> dict:
    """A SimConfig as keywords: its replica count and every other field
    that differs from its default."""
    return {"n_replicas": cfg.n_replicas, **non_default(cfg)}


# the rows come from the drivers themselves: bench_all.py's ``_cfgs`` and
# ``_wl_cfgs`` at the card's shapes, and the hunt's case tables
BENCH_ROWS = {r[0]: r for r in bench_all._cfgs(DEVICE)}
HUNT_CASES = {(c[0], c[1].n_replicas): c
              for c in hunt_cases.CASES + hunt_cases.DEMO_CASES}


def bench_row(label: str, steps=None) -> dict:
    """A ``bench_all._cfgs`` row's protocol, configuration, depth and
    schedule; chip_smoke runs it at its own group count."""
    _, proto, cfg, fuzz, _, depth, _, _ = BENCH_ROWS[label]
    sched = next(k for k, v in SCHEDULE_ARGS.items() if v == fuzz)
    row = dict(protocol=proto, cfg=cfg_kwargs(cfg), steps=steps or depth)
    if sched != "fault_free":
        row["schedule"] = sched
    return row


def hunt_cfg(name: str, replicas: int) -> dict:
    return cfg_kwargs(HUNT_CASES[name, replicas][1])


# the named schedules rows and checks run under: bench_all.py's FUZZ and
# wan3z geo axis, the hunt's DROP (seqchurn's down windows ride in its
# config), PART and KILL, and the demo kernels' churn scenarios
SCHEDULE_ARGS = {
    "fault_free": bench_all.FAULT_FREE,
    "wan3z": bench_all.GEO_WAN3Z,
    "bench_fuzz": bench_all.FUZZ,
    "hunt_drop": hunt_cases.DROP,
    "part": hunt_cases.PART,
    "kill": hunt_cases.KILL,
    "churn": HUNT_CASES["relay_churn", 3][2][0],
    "wan3z_churn": HUNT_CASES["relay_churn", 3][2][1],
}
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
    "epaxos": dict(cfg=bench_row("epaxos_conflict")["cfg"],
                   steps=bench_row("epaxos_conflict")["steps"],
                   line="epaxos_path",
                   metric="epaxos_conflict_executed_per_sec",
                   count="executed", expect=lambda steps: 74 * GROUPS),
}
# the new kernels' single-card runs: bench_all.py's configurations at the
# BASELINE.json scale, and what a run of seed SEED must count.  A row
# names its protocol (default: its key), its schedule (default
# fault-free) and, in ``expect``, each count it is held to; the rate is
# the first count a second
NEW_PATHS = {
    # fault-free sdpaxos commits one slot a group a step from step 4 on
    "sdpaxos": dict(cfg=bench_row("sdpaxos_tokens")["cfg"],
                    steps=bench_row("sdpaxos_tokens")["steps"],
                    line="sdpaxos_path",
                    metric="committed_sdpaxos_slots_per_sec",
                    expect={"committed_slots": 76 * GROUPS}),
    # wpaxos draws its demand and steals from the seed, so its count is
    # that seed's: the card equals the CPU on the same seed (phases 3 and
    # 6) and the CPU the JAX package (tests/test_torch_wpaxos_sim.py)
    "wpaxos": dict(cfg=bench_row("wpaxos_3x3_grid")["cfg"],
                   steps=bench_row("wpaxos_3x3_grid")["steps"],
                   line="wpaxos_path",
                   metric="committed_wpaxos_slots_per_sec",
                   expect={"committed_slots": 18_041_564}),
}
# phase 8: bench_all.py's protocol rows (``_cfgs``) at GROUPS groups, and
# kpaxos and dynamo at the hunt's configurations (hunt/cases.py).  A count
# that depends on the seed's draws is the JAX package's on the CPU at the
# same shape and seed (``scripts/reference_counts.py ROW``); the others
# hold for every group alike


def proto_row(row: dict, **kw) -> dict:
    return dict(row, line="protocol_path", **kw)


PROTO_ROWS = {
    # fault-free abd draws nothing: a replica completes an op every 4
    # steps (query, reply, store, ack) from step 0
    "abd_register": proto_row(bench_row("abd_register"),
                              metric="abd_ops_per_sec",
                              expect={"ops_done": 5 * ((60 - 1) // 4)
                                      * GROUPS}),
    # the head commits one write a step from step 4 on
    "chain_pipeline": proto_row(bench_row("chain_pipeline"),
                                metric="chain_slots_per_sec",
                                expect={"committed_slots": (110 - 4)
                                        * GROUPS}),
    # three static leaders, one slot a partition a step from step 2 on
    "kpaxos_path": proto_row(dict(protocol="kpaxos",
                                  cfg=hunt_cfg("kpaxos", 3), steps=104),
                             metric="kpaxos_slots_per_sec",
                             expect={"committed_slots": 3 * (104 - 2)
                                     * GROUPS}),
    # every replica writes once a step inside the 40-step write window
    "dynamo_path": proto_row(dict(protocol="dynamo",
                                  cfg=hunt_cfg("dynamo", 5), steps=60),
                             metric="dynamo_writes_per_sec",
                             expect={"writes": 5 * 40 * GROUPS}),
    # the demand is drawn from the seed: the JAX package's count
    "wankeeper_zones": proto_row(bench_row("wankeeper_zones"),
                                 metric="wankeeper_writes_per_sec",
                                 expect={"committed_slots": 9_059_250}),
    "wankeeper_wan3z_geo": proto_row(bench_row("wankeeper_wan3z_geo"),
                                     split=True,
                                     metric="wankeeper_writes_per_sec",
                                     expect={"committed_slots": 9_525_400}),
    # mining and the fault schedule are drawn from the seed
    "blockchain_forks": proto_row(bench_row("blockchain_forks"),
                                  metric="blockchain_blocks_per_sec",
                                  expect={"committed_slots": 4_068_791}),
    # two proxies, each a slot a step (2 * steps - 5 a group); the batch
    # sizes, hence the commands, are drawn from the seed
    "bpaxos_grid": proto_row(bench_row("bpaxos_grid"),
                             metric="bpaxos_cmds_per_sec",
                             expect={"committed_cmds": 50_749_712,
                                     "committed_slots": (2 * 104 - 5)
                                     * GROUPS}),
}
# phase 9: bench_all.py's switchnet pair (``_cfgs``, bench_all.py:139-150:
# the same geometry under the wan3z matrix alone) and the hunt's
# switchpaxos case under the seqchurn sequencer schedule and DROP
# (paxi_tpu/hunt/cases.py:101-103; ``apply_switch(cfg, SEQ_CHURN)`` is the
# sw_down_* knobs below) at GROUPS groups.  Every count is drawn from the
# seed or the zone jitter: the JAX package's on the CPU at the same shape
# and seed (``scripts/reference_counts.py ROW``).  Neither kernel keeps
# zone-local and cross-zone latency counters (in the reference neither), so
# these rows have no local/cross split: their p50s are the measure
SWITCH_CFG = bench_row("switchpaxos_wan3z")["cfg"]
# the hunt's switchpaxos geometry (its nogap twin's too), and its seqchurn
# case (the last CASES row: ``apply_switch(cfg, SEQ_CHURN)``)
HUNT_SWITCH_CFG = hunt_cfg("switchpaxos_nogap", 5)
SEQCHURN_CFG = cfg_kwargs(hunt_cases.CASES[-1][1])
SWITCH_ROWS = {
    "switchpaxos_wan3z": dict(bench_row("switchpaxos_wan3z"),
                              line="switch_path",
                              metric="switchpaxos_slots_per_sec",
                              expect={"committed_slots": 6_716_530}),
    "paxos_wan3z_base": dict(bench_row("paxos_wan3z_base"),
                             line="switch_path",
                             metric="paxos_slots_per_sec",
                             expect={"committed_slots": 4_355_335}),
    # the reference itself violates here at 100k groups (74 oracle and
    # 227 in-scan violations; none at the hunt's 32 groups): a safety bug
    # of the reference's switchpaxos under drops (the witness's first
    # violation comes before the first down window), which the port
    # reproduces bit for bit and is held to (PERF.md section 6)
    "switchpaxos_seqchurn": dict(protocol="switchpaxos", cfg=SEQCHURN_CFG,
                                 steps=140, schedule="seqchurn_drop",
                                 line="switch_path",
                                 metric="switchpaxos_slots_per_sec",
                                 expect={"committed_slots": 7_732_715},
                                 violations=(74, 227)),
}
# the nogap twin (DEMO_CASES, cases.py:143-148): captured at GROUPS x
# NOGAP_STEPS under the hunt's DROP, card against CPU at NOGAP_SMALL_GROUPS
NOGAP_STEPS, NOGAP_SMALL_GROUPS = 80, 16
# the demo kernels' hunt cases (DEMO_CASES): (config, schedules, groups,
# steps); every schedule must violate


def schedule_key(fuzz) -> str:
    return next(k for k, v in SCHEDULE_ARGS.items() if v == fuzz)


DEMO_CASES = {c[0]: (cfg_kwargs(c[1]), tuple(map(schedule_key, c[2])),
                     c[3], c[4])
              for c in hunt_cases.DEMO_CASES
              if c[0] in ("fragile_counter", "relay_churn")}
SWITCH_SMALL_GROUPS, SWITCH_SMALL_STEPS = 64, 12   # 20 until phase 14
# bench_all.py's FUZZ schedule (blockchain_forks)
BENCH_FUZZ_ARGS = non_default(bench_all.FUZZ)
# the seeded twins (hunt/cases.py BUG_DEMO and DEMO_CASES), under DROP, at
# GROUPS x TWIN_STEPS; card against CPU at TWIN_SMALL_GROUPS
TWIN_CFGS = {"wankeeper_nofloor": hunt_cfg("wankeeper_nofloor", 6),
             "bpaxos_noread": hunt_cfg("bpaxos_noread", 7)}
TWIN_DROP_ARGS = non_default(hunt_cases.DROP)
# the hunt's PART and KILL
HUNT_PART_ARGS = non_default(hunt_cases.PART)
HUNT_KILL_ARGS = non_default(hunt_cases.KILL)
TWIN_STEPS, TWIN_SMALL_GROUPS = 80, 16
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
WITNESS_CFG = hunt_cfg("wpaxos_thinq1", 9)
# (the shrink's trials 40 until phase 14 came, 61 s on the card; 10 until
# phase 15 came, 20.3 s; 4 now)
WITNESS_STEPS, HUNT_GROUPS, SHRINK_TRIALS, GEO_DROP = 100, 16, 4, 0.05
# bench_all.py's wpaxos_wan3z_geo row: wpaxos 3 x 3 under wan3z alone
SCENARIO_CFG = NEW_PATHS["wpaxos"]["cfg"]
SCENARIO_STEPS = 100
CHECKPOINT_SPLIT = 52                # of the paxos path's 104 fuzzed steps
SCRATCH_DIR = "build/chip_smoke"     # trace and checkpoint files
# phase 7: bench_all.py's workload matrix (_wl_cfgs) at GROUPS groups
WL_CFGS = {r[1]: cfg_kwargs(r[2]) for r in bench_all._wl_cfgs(DEVICE)}
WL_NAMES = ("uniform", "zipf99", "flash")
# wpaxos cut from bench_all's 120 steps to 60 for time (PERF.md section
# 4); 60 still holds flash's first surge, steps 30-41
# wpaxos 60 steps until phase 14 came; 45 still hold flash's first surge
# (steps 30-41); at 60, zipf99 stole 158,452 times, uniform 9,982
WL_STEPS = {"paxos": 120, "wpaxos": 45}
# a workloadless fault-free paxos 3 x 16 group commits steps - 4 slots; a
# spec without a flash gate changes keys, reads and classes only
WL_EXPECT = {("paxos", "uniform"): 116 * GROUPS,
             ("paxos", "zipf99"): 116 * GROUPS}
# the card-against-CPU shape of phases 7 and 8 (30 steps until phase 9
# came; PERF.md section 4)
WL_SMALL_GROUPS, WL_SMALL_STEPS = 64, 12
WL_SHARD_GROUPS, PG_SHARD_GROUPS = 256, 257  # 257: three pad groups
PG_PIN = dict(group=131, steps=SMALL_STEPS)  # the sharded pinned replay
# phase 10: the drivers.  The CLI's main path is bench.py's north star
# (PATHS["paxos"] at GROUPS); a short subprocess runs ``__main__``
CLI_ARGV = ["sim", "-algorithm", "paxos", "-groups", str(GROUPS),
            "-replicas", str(REPLICAS), "-slots", "64", "-steps", "104"]
CLI_SUBPROCESS_ARGV = ["sim", "-algorithm", "paxos", "-groups", "1024",
                       "-replicas", "5", "-slots", "64", "-steps", "20"]
# the hunt micro-campaign: seed 0 of the nogap case (16 groups x 80 under
# DROP) violates, so a budget of 1 finds a witness; phase 9 saves its
# 100k seqchurn witness into WITNESS_DIR, the campaign's corpus seed
HUNT_ARGV = ["--protocols", "switchpaxos,switchpaxos_nogap", "--budget", "1",
             "--quick", "--shrink-trials", "4"]
WITNESS_DIR = SCRATCH_DIR + "/traces"
HUNT_DIR = SCRATCH_DIR + "/hunt"
# the host runtime under a scenario (``scenario run -host``), held to the
# line ``python -m paxi_tpu scenario run -host`` prints for the same
# arguments on the CPU, exit code 1 included (both host runtimes count
# one linearizability anomaly in this run; ROADMAP Queue 3)
SCENARIO_HOST_ARGV = ["scenario", "run", "-host", "-scenario", "wan3z",
                      "-algorithm", "paxos", "-replicas", "3", "-zones", "3",
                      "-steps", "40"]
SCENARIO_HOST_WANT = (1, {
    "anomalies": 1, "oracle_violations": 0, "ops_ok": 25, "ops_failed": 0,
    "steps": 40, "fabric_stats": {
        "submitted": 153, "delivered": 153, "dropped_fault": 0,
        "delayed_fault": 0, "dropped_crash": 0, "dropped_cut": 0,
        "dropped_no_listener": 0, "edge_delayed": 115},
    "span_count": 133, "runtime": "host", "algorithm": "paxos",
    "scenario": "wan3z"})
# bench_all's paxos_3rep at its own card shape (16,384 groups x 104 steps):
# fault-free paxos commits steps - 4 slots a group (the JAX package's
# count on the CPU: ``scripts/reference_counts.py bench_paxos_3rep``)
DRIVER_ROWS = {
    "bench_paxos_3rep": dict(
        bench_row("paxos_3rep"), groups=BENCH_ROWS["paxos_3rep"][4],
        expect={"committed_slots": BENCH_ROWS["paxos_3rep"][4] * (104 - 4)}),
}
# fuzz_soak's record of paxos x DROP x seed 0 at the case's 64 x 150
SOAK_CASE = ("paxos", "drop", 0)
# phase 11: the bench twin (``python -m paxi_tpu_torch.bench``, the north
# star: PATHS["paxos"] at GROUPS), its sweep (36 steps: steps 5-36 commit
# one slot a group each), the layout A/B (``--kernel paxos_sw``) and each
# other sliding-window twin at its fixed-cell row's shape, seed and count
# (the JAX package's sim_sw equals its sim there at 512 groups:
# ``scripts/reference_counts.py --sw ROW``)
BENCH_SWEEP = (256, 4096, 32768)
BENCH_SWEEP_STEPS = 36
PROFILE_STEPS = 4                    # torch_step_profile's warm and timed
SW_ROWS = {
    "sdpaxos_sw": dict(NEW_PATHS["sdpaxos"], protocol="sdpaxos_sw"),
    "wpaxos_sw": dict(NEW_PATHS["wpaxos"], protocol="wpaxos_sw"),
    "wankeeper_sw": dict(PROTO_ROWS["wankeeper_zones"],
                         protocol="wankeeper_sw"),
    "bpaxos_sw": dict(PROTO_ROWS["bpaxos_grid"], protocol="bpaxos_sw"),
}
for _row in SW_ROWS.values():
    _row["line"] = "sw_twin"
# every twin card against CPU at 64 x 12 under the hunt's DROP, at its
# row's configuration (paxos_sw at the main path's)
SW_SMALL_GROUPS, SW_SMALL_STEPS = 64, 12           # 20 until phase 14
SW_SMALL_CFGS = {"paxos_sw": PATHS["paxos"]["cfg"],
                 **{k: r["cfg"] for k, r in SW_ROWS.items()}}


# phase 12: the host-sync audit.  Every registered kernel and every
# sliding-window twin at AUDIT_GROUPS groups: AUDIT_WARMUP steps, then
# AUDIT_STEPS of ``run_steps`` under the CUDA sync debug mode; each under
# the schedule its row runs (paxos and epaxos also fault-free), wpaxos
# under GEO3Z so the scenario planes run
AUDIT_GROUPS, AUDIT_WARMUP, AUDIT_STEPS = 1024, 2, 4
AUDIT_SECONDS = 30
AUDIT_RUNS = (
    ("paxos", PATHS["paxos"]["cfg"], "fault_free"),
    ("paxos", PATHS["paxos"]["cfg"], "fuzz"),
    ("paxos_pg", PATHS["paxos"]["cfg"], "fault_free"),
    ("epaxos", PATHS["epaxos"]["cfg"], "fault_free"),
    ("epaxos", PATHS["epaxos"]["cfg"], "fuzz"),
    ("sdpaxos", NEW_PATHS["sdpaxos"]["cfg"], "fault_free"),
    ("wpaxos", NEW_PATHS["wpaxos"]["cfg"], "geo3z"),
    ("wpaxos_thinq1", WITNESS_CFG, "geo3z"),
    ("wankeeper", PROTO_ROWS["wankeeper_zones"]["cfg"], "fault_free"),
    ("wankeeper_nofloor", TWIN_CFGS["wankeeper_nofloor"], "hunt_drop"),
    ("bpaxos", PROTO_ROWS["bpaxos_grid"]["cfg"], "fault_free"),
    ("bpaxos_noread", TWIN_CFGS["bpaxos_noread"], "hunt_drop"),
    ("chain", PROTO_ROWS["chain_pipeline"]["cfg"], "fault_free"),
    ("kpaxos", PROTO_ROWS["kpaxos_path"]["cfg"], "fault_free"),
    ("abd", PROTO_ROWS["abd_register"]["cfg"], "fault_free"),
    ("dynamo", PROTO_ROWS["dynamo_path"]["cfg"], "fault_free"),
    ("blockchain", PROTO_ROWS["blockchain_forks"]["cfg"], "bench_fuzz"),
    ("switchpaxos", SWITCH_CFG, "wan3z"),
    ("switchpaxos_nogap", HUNT_SWITCH_CFG, "hunt_drop"),
    ("fragile_counter", DEMO_CASES["fragile_counter"][0],
     DEMO_CASES["fragile_counter"][1][0]),
    ("relay_churn", DEMO_CASES["relay_churn"][0],
     DEMO_CASES["relay_churn"][1][0]),
    *((k, c, "fault_free") for k, c in SW_SMALL_CFGS.items()),
)

# phase 13: the host twins (slice 14).  A hunt micro-campaign over the
# seeded twins with a matching host twin (bpaxos_noread, relay_churn: the
# reproduced controls), host replay on, its corpus seeded with nothing;
# phase 5's and phase 8's 100k witnesses classified on their base
# protocols' twins; and ``scenario run -host``
# lines, each held to the line ``python -m paxi_tpu scenario run -host``
# prints for the same arguments on the CPU, exit code included.  The
# wankeeper twin's watchdog sleeps 50 ms of wall time between token
# retries (both packages): its line is taken at 24 steps, whose replay
# (~20 ms on a CPU) ends before the first tick and whose ops all complete.
# The wankeeper BUG_DEMO stays out of the campaign: its 16-group run takes
# 13.2 s on the card (dispatch-bound), ~66 s with its capture and shrink,
# for a witness whose p2b drops leave it unmappable; phase 8's 100k
# witness of it is classified below instead
TWIN_HUNT_PROTOCOLS = ("bpaxos_noread", "relay_churn")
TWIN_HUNT_ARGV = ["--protocols", ",".join(TWIN_HUNT_PROTOCOLS),
                  "--budget", "1", "--quick", "--shrink-trials", "4"]
TWIN_HUNT_DIR = SCRATCH_DIR + "/hunt_twins"
NOFLOOR_WITNESS = SCRATCH_DIR + "/twin_witnesses/wankeeper_nofloor_100k"
THINQ1_WITNESS = SCRATCH_DIR + "/witness"        # phase 5 saves it
TWIN_SECONDS = 60

# phase 14, serving (slice 15): the host runtime's client REST API, as
# asyncio Python on the CPU; no kernel runs.  Every row it prints is a
# host figure of the card's machine
SERVING_DIR = SCRATCH_DIR + "/serving"
SERVING_SECONDS = 45
SERVE_OPS = 200                      # client -N, paxos x 3
SERVE_TRACE_SAMPLE = 0.2             # the server's head sampling
BENCH_HOST_CLOSED_ARGV = ["bench-host", "-T", "2", "-warmup", "0.5",
                          "-K", "64", "-trace_sample", "0.2"]
# bench_host's CONFIGS on the card's machine, at BENCH_HOST_T=1, but
# wpaxos: under bench_host's load (K=8, concurrency 4, seed 1) both
# packages' wpaxos twins stop at the same 224th op, two replicas (1.1 and
# 2.1) stealing key 7 from each other without end, and each of the four
# streams then fails after 10 s on every one of the six replicas (61 s, 4
# errors; ROADMAP Queue 3)
BENCH_HOST_SKIP = ("wpaxos",)
SOAK_PROTOCOL = "paxos"
# SOAK_HOST_T: the run's seconds (8 by default).  Each fault window that
# catches an op in flight holds that op for the server's 10 s request
# timeout (12.5-33 s a paxos run at 8 s); at 4 s the crash, drop and flaky
# windows open under load and the leader crash (4.5 s) as it ends
SOAK_SECONDS = 4
SOAK_OUT = SERVING_DIR + "/SOAK_HOST.json"
SOAK_WAIT_S = 120                    # the soak process's own time limit

# phase 15, the sharded tier (slice 16): the reference's own shard smoke
# (``scripts/verify.sh --shard``: two paxos groups of three behind the
# router, the disjoint and crossing ramps, a live range migration, the
# 2PC burst) with a stateless secondary router, a traced cross-shard 2PC
# on a virtual-clock fabric, and the stale-read checker (``sim/lincheck``,
# tensor code, no kernel) on the card against the CPU.  The ramp's rows
# are host figures of the card's machine
SHARD_DIR = SCRATCH_DIR + "/shard"
SHARD_SECONDS = 25
SHARD_FLEET, SHARD_ROUTERS = 6, 2
SHARD_ARGV = ["bench-host", "--shards", "2", "-shard_fleet",
              str(SHARD_FLEET), "-shard_workers", "2", "-rates", "300,800",
              "-step_s", "1.5", "-K", "64", "-txns", "4", "-migrate",
              "-routers", str(SHARD_ROUTERS)]
# shard_ramp's layout: the groups' HTTP ports from the base, the primary
# router 98 above it, each secondary one more
SHARD_PORTS = [*range(SHARD_FLEET), *range(98, 98 + SHARD_ROUTERS)]
SHARD_PHASES = ["disjoint", "crossing", "migrate"]
# the checker at the sim's scale: seeded random histories of 16 ops in
# 100k groups, and every LINCHECK_STRIDE-th group replaced by a planted
# history with a known count: (key, is_read, val, start, end) rows
LINCHECK_GROUPS, LINCHECK_OPS, LINCHECK_STRIDE = 100_000, 16, 997
LINCHECK_PLANTED = {
    "stale": ([(0, False, 7, 0, 1), (0, False, 8, 2, 3),
               (0, True, 7, 4, 5)], 1),
    "future": ([(0, True, 7, 0, 1), (0, False, 7, 2, 3)], 1),
    "initial": ([(0, False, 7, 0, 1), (0, True, 0, 2, 3)], 1),
    "clean": ([(0, False, 7, 0, 1), (0, True, 7, 2, 3),
               (0, False, 8, 4, 5), (0, True, 8, 6, 7)], 0),
}


def scenario_host_line(algorithm: str, extra, rc: int, steps: int,
                       scenario: str = "wan3z", **line):
    """A ``scenario run -host`` argv and the JAX package's (rc, line)."""
    return (["scenario", "run", "-host", "-scenario", scenario,
             "-algorithm", algorithm] + list(extra),
            (rc, {**line, "steps": steps, "runtime": "host",
                  "algorithm": algorithm, "scenario": scenario}))


def fabric_stats(submitted, delivered, edge_delayed=None, dropped_crash=0):
    out = {"submitted": submitted, "delivered": delivered,
           "dropped_fault": 0, "delayed_fault": 0,
           "dropped_crash": dropped_crash, "dropped_cut": 0,
           "dropped_no_listener": 0}
    if edge_delayed is not None:
        out["edge_delayed"] = edge_delayed
    return out


SCENARIO_TWIN_LINES = {
    "epaxos": scenario_host_line(
        "epaxos", ["-replicas", "3", "-zones", "3"], 0, 120, anomalies=0,
        oracle_violations=0, ops_ok=65, ops_failed=0,
        fabric_stats=fabric_stats(498, 498, 468), span_count=65),
    # the wpaxos twin's history counts 6 linearizability anomalies under
    # the wan3z latencies in both packages (PERF.md section 7)
    "wpaxos": scenario_host_line(
        "wpaxos", ["-replicas", "9", "-zones", "3"], 1, 120, anomalies=6,
        oracle_violations=0, ops_ok=65, ops_failed=0,
        fabric_stats=fabric_stats(1873, 1873, 1299), span_count=114),
    "wankeeper": scenario_host_line(
        "wankeeper", ["-replicas", "9", "-zones", "3", "-steps", "24"], 0,
        24, anomalies=0, oracle_violations=0, ops_ok=17, ops_failed=0,
        fabric_stats=fabric_stats(160, 160, 46), span_count=28),
    "relay_churn": scenario_host_line(
        "relay_churn", ["-replicas", "3"], 1, 120, scenario="churn",
        anomalies=0, oracle_violations=8, ops_ok=0, ops_failed=0,
        fabric_stats=fabric_stats(316, 192, dropped_crash=124),
        span_count=0),
}
# one interpreter runs every line (``cli.main`` as ``python -m
# paxi_tpu_torch`` calls it), apart from the script's own heap
SCENARIO_LINES_CODE = """
import contextlib, io, json, sys
from paxi_tpu_torch import cli
for argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    print(json.dumps({"rc": rc, "line": json.loads(buf.getvalue())}))
"""


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

# how the outbox planes lie in phase 2: every other field plane (and the
# valid plane of every other type) a ring.dst_major view, as protocols
# send replies; the correctness checks add a plane broadcast over dst and
# a slice one group in (misaligned), and a ragged group count
LAYS = ("contiguous", "dst_major")
CHECK_LAYS = ("contiguous", "dst_major", "broadcast", "sliced")
RAGGED_GROUPS = 13


def lay(x: torch.Tensor, how: str) -> torch.Tensor:
    """``x (R, R, G)`` as a tensor that lies ``how``, equal in value (a
    broadcast takes dst 0's values)."""
    if how == "dst_major":
        return x.transpose(0, 1).contiguous().transpose(0, 1)
    if how == "broadcast":
        return x[:, :1].expand(x.shape)
    if how == "sliced":
        wide = torch.zeros(x.shape[:-1] + (x.shape[-1] + 1,),
                           dtype=x.dtype, device=x.device)
        wide[..., 1:] = x
        return wide[..., 1:]
    return x


def step_inputs(spec, d: int, gen: torch.Generator,
                replicas: int = REPLICAS, groups: int = GROUPS,
                lays=LAYS):
    """Seeded random inputs of one step's exchange: the wheel, the outbox
    (its planes laid in turn as ``lays``), the fault state and the fault
    planes."""
    from paxi_tpu_torch.sim import mailbox as mb
    dev = torch.device(DEVICE)
    R, G = replicas, groups

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    wheel, outbox, faults = {}, {}, {}
    for j, (name, fields) in enumerate(spec.items()):
        w = ints((d, 1 + len(fields), R, R, G), 1000)
        w[:, 0] = ints((d, R, R, G), 2)
        wheel[name] = mb.WheelBox(tuple(fields), w)
        outbox[name] = {"valid": lay(ints((R, R, G), 2).bool(),
                                     lays[j % len(lays)])}
        for i, f in enumerate(fields):
            outbox[name][f] = lay(ints((R, R, G), 1000), lays[i % len(lays)])
        faults[name] = {"drop": ints((R, R, G), 5) == 0,
                        "delay": ints((R, R, G), d) + 1,
                        "dup": ints((R, R, G), 3) == 0}
    fs = {"conn": ints((R, R, G), 6) != 0, "crashed": ints((R, G), 6) == 0}
    return wheel, outbox, fs, faults


def exchange_bytes(spec, d: int, replicas: int, groups: int):
    """The least bytes one step's deliver and insert move (the formula of
    csrc/exchange.cu), each input read once and each output written once:
    a type of F planes on E = R*R*G edges, deliver reads d*F*E*4 and
    writes E (valid) + (F-1)*E*4 + d*F*E*4; insert reads d*F*E*4 +
    (F-1)*E*4 + E (valid) + E (drop) + E (dup) + 4E (delay) and writes
    d*F*E*4; conn (E bytes) and crashed (R*G) once a step."""
    E = replicas * replicas * groups
    deliver = insert = 0
    for fields in spec.values():
        F = 1 + len(fields)
        deliver += d * F * E * 4 + E + (F - 1) * E * 4 + d * F * E * 4
        insert += d * F * E * 4 + (F - 1) * E * 4 + 7 * E + d * F * E * 4
    return deliver, insert + E + replicas * groups


def exchange_err(wheel, outbox, fs, faults):
    """Max |kernel - plain| of one step's deliver and insert, and the
    launches each half made."""
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import mailbox as mb

    def diff(a, b):
        if a.dtype == torch.bool:
            return int((a != b).sum()) if a.dtype == b.dtype else 1
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    before = (ops.wheel_deliver.launches, ops.wheel_insert.launches)
    inbox, rolled = ops.wheel_deliver(wheel)
    new = ops.wheel_insert(wheel, outbox, fs, faults)
    launched = (ops.wheel_deliver.launches - before[0],
                ops.wheel_insert.launches - before[1])
    want_inbox, want_rolled = mb.wheel_deliver(wheel)
    want = mb.wheel_insert(wheel, outbox, fs, faults)
    torch.cuda.synchronize()
    err_d = max(max(diff(inbox[n][k], v) for k, v in want_inbox[n].items())
                for n in wheel)
    err_d = max(err_d, max(diff(rolled[n].planes, want_rolled[n].planes)
                           for n in wheel))
    err_i = max(diff(new[n].planes, want[n].planes) for n in want)
    return err_d, err_i, launched


def exchange_phase(path: str, spec, depths=(1, 3),
                   replicas: int = REPLICAS):
    """Both exchange kernels on one mailbox, one step's worth (every
    message type in one launch a half), at each wheel depth of
    ``depths``: exact against the plain versions at the main path's
    shape (outbox planes laid as ``LAYS``) and at ``RAGGED_GROUPS``
    groups with every lay of ``CHECK_LAYS``; the kernel alone (its
    prepared launches, four an event pair), the whole wrapper call and the
    plain version timed."""
    from paxi_tpu_torch.ops import exchange as ops
    from paxi_tpu_torch.sim import mailbox as mb

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    rows = {}
    for d in depths:
        err = {"wheel_deliver": 0, "wheel_insert": 0}
        for groups, lays in ((RAGGED_GROUPS, CHECK_LAYS),
                             (GROUPS, CHECK_LAYS)):
            e_d, e_i, _ = exchange_err(*step_inputs(spec, d, gen, replicas,
                                                    groups, lays))
            err["wheel_deliver"] = max(err["wheel_deliver"], e_d)
            err["wheel_insert"] = max(err["wheel_insert"], e_i)
        wheel, outbox, fs, faults = args = step_inputs(spec, d, gen,
                                                       replicas)
        e_d, e_i, launched = exchange_err(*args)
        err["wheel_deliver"] = max(err["wheel_deliver"], e_d)
        err["wheel_insert"] = max(err["wheel_insert"], e_i)
        deliver_bytes, insert_bytes = exchange_bytes(spec, d, replicas,
                                                     GROUPS)
        d_plans = ops.deliver_plan(wheel)[0]
        i_plans = ops.insert_plan(*args)[0]
        timings = {
            "wheel_deliver": (
                median_ms(lambda: ops.launch(d_plans), inner=4),
                median_ms(lambda: ops.wheel_deliver(wheel)),
                median_ms(lambda: mb.wheel_deliver(wheel)),
                deliver_bytes, launched[0]),
            "wheel_insert": (
                median_ms(lambda: ops.launch(i_plans), inner=4),
                median_ms(lambda: ops.wheel_insert(*args)),
                median_ms(lambda: mb.wheel_insert(*args)),
                insert_bytes, launched[1]),
        }
        for name, (ms, wrapper_ms, plain_ms, nbytes, n_launch) \
                in timings.items():
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "mailbox": path, "wheel_depth": d,
                   "groups": GROUPS, "replicas": replicas,
                   "message_types": len(spec),
                   "planes": sum(1 + len(f) for f in spec.values()),
                   "launches_a_step": n_launch,
                   "max_abs_err": err[name], "ms": ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "share_of_bound": bound_ms / ms}
            log("kernel " + json.dumps(row))
            if err[name] != 0:
                fail(f"{name} differs from its plain version at d={d} "
                     f"({path} mailbox)")
            if n_launch != EXCHANGE_LAUNCHES_A_STEP:
                fail(f"{name} made {n_launch} launches for a step")
            rows[(name, d)] = row
        del wheel, outbox, fs, faults, args, d_plans, i_plans
        torch.cuda.empty_cache()
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

def same_run(want, got, label: str) -> None:
    """Every plane, metric and violation count of two runs' ``(state,
    metrics, violations)`` (tensors or numpy) equal."""
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    (sa, ma, va), (sb, mb, vb) = want[:3], got[:3]
    for k in sa:
        a, b = host(sa[k]), host(sb[k])
        if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
            fail(f"{label}: state plane {k} differs")
    for k in ma:
        if int(ma[k]) != int(mb[k]):
            fail(f"{label}: metric {k} differs: {int(ma[k])} vs "
                 f"{int(mb[k])}")
    if int(va) != int(vb):
        fail(f"{label}: violations differ")


def compare_runs(a, b, label: str) -> None:
    """Two SimResults (the CPU's and the card's) equal, as ``same_run``."""
    same_run((a.state, a.metrics, a.violations),
             (b.state, b.metrics, b.violations), label)


def card_vs_cpu_phase(path: str, proto, cfg, count: str,
                      groups: int = SMALL_GROUPS, steps: int = SMALL_STEPS):
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, simulate
    for label, fuzz in (("fault_free", FAULT_FREE),
                        ("fuzz", FuzzConfig(**FUZZ_ARGS))):
        t0 = time.perf_counter()
        on_cpu = simulate(proto, cfg, groups, steps, fuzz, seed=SEED,
                          device="cpu")
        on_card = simulate(proto, cfg, groups, steps, fuzz, seed=SEED,
                           device=DEVICE)
        compare_runs(on_cpu, on_card, f"{path} {label}")
        log("card_vs_cpu " + json.dumps({
            "protocol": path, "schedule": label, "groups": groups,
            "steps": steps, "equal": True,
            count: int(on_card.metrics[count]),
            "violations": int(on_card.violations),
            "seconds": time.perf_counter() - t0}))


def card_vs_cpu_case(name: str, cfg_kw, sched: str, groups: int,
                     steps: int, violate: bool) -> None:
    """One run on the CPU and on the card from the same seed, equal on
    every plane, metric and violation count; a seeded twin or demo must
    violate (``violate``), any other kernel must not."""
    from paxi_tpu_torch.profiling import resolve_kernel
    from paxi_tpu_torch.sim import SimConfig, simulate
    proto, cfg, fuzz = resolve_kernel(name), SimConfig(**cfg_kw), \
        schedule_of(sched)
    t0 = time.perf_counter()
    runs = [simulate(proto, cfg, groups, steps, fuzz, seed=SEED, device=d)
            for d in ("cpu", DEVICE)]
    compare_runs(*runs, f"{name} {sched}")
    viol = int(runs[1].violations)
    log("card_vs_cpu " + json.dumps({
        "protocol": name, "schedule": sched, "config": cfg_kw,
        "groups": groups, "steps": steps, "equal": True,
        "violations": viol, "seconds": time.perf_counter() - t0}))
    if violate and not viol > 0:
        fail(f"{name} under {sched} did not violate")
    if not violate and (viol or runs[1].inscan_violations):
        fail(f"{name} under {sched}: safety violations")


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
    want_launches = {"wheel_deliver": steps * EXCHANGE_LAUNCHES_A_STEP,
                     "wheel_insert": steps * EXCHANGE_LAUNCHES_A_STEP,
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
            sent = outbox
            outbox, faults = mb.full_edges(outbox, faults, GROUPS)
            wv = ({n: b.planes[:, 0] != 0 for n, b in wheel.items()}
                  if fuzz.wheel > 1 else None)
            step_counts(inbox, sent, faults, fs, cfg.n_replicas,
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


def schedule_of(name: str):
    """A row's schedule: ``fault_free``, ``wan3z`` (the zone-latency
    matrix alone), ``bench_fuzz`` (bench_all.py's FUZZ), or one of the
    hunt's (``hunt_drop``, ``seqchurn_drop``, ``part``, ``kill``,
    ``churn``, ``wan3z_churn``)."""
    return {**SCHEDULE_ARGS, "seqchurn_drop": hunt_cases.DROP}[name]


# metrics a row prints beside its counts where its protocol has them
ROW_EXTRAS = ("steals", "commands_proposed", "transfers", "root_execute",
              "recoveries", "reads_done", "tail_applied", "mined", "reorgs",
              "converged", "converged_keys", "fast_commits", "gap_events",
              "sw_overflows")


def new_path_run(key: str, smi: str, paths=None):
    """A new kernel's single-card run at 100,000 groups under its row's
    schedule, with its rate; each count and the launch counts (read around
    the run) must be the expected ones."""
    from paxi_tpu_torch.profiling import resolve_kernel
    from paxi_tpu_torch.scenarios import latency_split
    from paxi_tpu_torch.sim import SimConfig, simulate

    spec = (NEW_PATHS if paths is None else paths)[key]
    name = spec.get("protocol", key)
    sched = spec.get("schedule", "fault_free")
    proto, cfg = resolve_kernel(name), SimConfig(**spec["cfg"])
    fuzz = schedule_of(sched)
    steps = spec["steps"]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, steps, fuzz, seed=SEED, device=DEVICE)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    metrics = {k: int(v) for k, v in res.metrics.items()}
    counts = {k: metrics[k] for k in spec["expect"]}
    row = {"row": key, "protocol": name, "schedule": sched,
           "metric": spec["metric"],
           spec["metric"]: next(iter(counts.values())) / wall_s, **counts,
           "wall_s": wall_s, "ms_per_step": wall_s / steps * 1e3,
           "invariant_violations": int(res.violations),
           "inscan_violations": res.inscan_violations,
           "commit_latency": res.latency_summary(),
           "groups": GROUPS, "steps": steps, "config": spec["cfg"],
           "wheel_depth": fuzz.wheel, "device": smi, "kernels": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           **{k: metrics[k] for k in ROW_EXTRAS if k in metrics}}
    if spec.get("split"):
        row.update(latency_split(metrics))
    log(spec["line"] + " " + json.dumps(row))
    # a row whose reference run violates is held to the JAX package's
    # (oracle, in-scan) counts at the same shape and seed; any other to 0
    want_viol = spec.get("violations", (0, 0))
    got_viol = (int(res.violations), res.inscan_violations or 0)
    if got_viol != want_viol:
        fail(f"{key}: (oracle, in-scan) violations {got_viol}, expected "
             f"{want_viol}")
    for k, want in spec["expect"].items():
        if counts[k] != want:
            fail(f"{key}: {k} {counts[k]}, expected {want}")
    if spec.get("split") and not ("commit_lat_local_rounds" in row
                                  and "commit_lat_cross_rounds" in row):
        fail(f"{key}: no zone-local or cross-zone latency")
    expect_launches(key, launches, steps)
    return row


# ---- phase 5: capture, replay, shrink, scenarios, checkpoints -------------

def geo_fuzz(drop: float = GEO_DROP):
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FuzzConfig
    return FuzzConfig(p_drop=drop, scenario=NAMED["wan3z"])


def expect_launches(label: str, launches, steps: int) -> None:
    want = {"wheel_deliver": steps * EXCHANGE_LAUNCHES_A_STEP,
            "wheel_insert": steps * EXCHANGE_LAUNCHES_A_STEP,
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
    expect_launches("witness capture", launches, WITNESS_STEPS)
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
    expect_launches("witness replays", launches, 2 * WITNESS_STEPS)
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
    expect_launches("real wpaxos", launches, WITNESS_STEPS)
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
    expect_launches("scenario path", launches, SCENARIO_STEPS)
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
    expect_launches("checkpoint path", launches, steps)
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


# ---- phase 7: workloads ---------------------------------------------------

def wl_config(cfg_kw, workload=None):
    """``SimConfig(**cfg_kw)`` serving the named ``workload`` (or none)."""
    from paxi_tpu_torch.sim import SimConfig
    from paxi_tpu_torch.workload import apply_workload, named_workload
    cfg = SimConfig(**cfg_kw)
    return apply_workload(cfg, named_workload(workload)) if workload \
        else cfg


def class_row(res) -> dict:
    """The per-class n, p50 and p99 of a run (``workload.class_split``)."""
    from paxi_tpu_torch.workload import class_split
    return {c: {k: v[k] for k in ("n", "p50_rounds", "p99_rounds")}
            for c, v in class_split(res.state).items()}


def workload_cell(path: str, wl: str, smi: str):
    """One cell of the matrix at GROUPS groups, fault-free, read with the
    launch counts set to 0 just before it."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import simulate

    proto, cfg = sim_protocol(path), wl_config(WL_CFGS[path], wl)
    steps = WL_STEPS[path]
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, steps, seed=SEED, device=DEVICE)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    done = int(res.metrics["committed_slots"])
    row = {"cell": f"{path}_{wl}", "protocol": path, "workload": wl,
           "groups": GROUPS, "steps": steps, "config": WL_CFGS[path],
           "committed_slots": done, "slots_per_s": done / wall_s,
           "wall_s": wall_s, "ms_per_step": wall_s / steps * 1e3,
           "classes": class_row(res),
           **{f"wl_{c}_n": int(res.metrics[f"wl_{c}_n"])
              for c in ("hot", "warm", "cold")},
           **({"steals": int(res.metrics["steals"])}
              if "steals" in res.metrics else {}),
           "invariant_violations": int(res.violations),
           "inscan_violations": res.inscan_violations,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "kernels": launches, "device": smi}
    log("workload_cell " + json.dumps(row))
    if int(res.violations) != 0 or res.inscan_violations != 0:
        fail(f"workload {path} {wl}: safety violations")
    want = WL_EXPECT.get((path, wl))
    if want is not None and done != want:
        fail(f"workload {path} {wl}: committed {done}, expected {want}")
    expect_launches(f"workload {path} {wl}", launches, steps)
    return row, res


def lowering_pin_phase(lane, smi: str):
    """paxos_pg at full width under zipf99 and flash against the
    lane-major cells ``lane`` ({wl: SimResult}): zipf99 must give equal kv
    planes and class counts; flash gates both below zipf99 (their commits
    are reported: the reference's two lowerings need not agree there)."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import simulate

    proto = sim_protocol("paxos_pg")
    steps = WL_STEPS["paxos"]
    for wl in ("zipf99", "flash"):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        res = simulate(proto, wl_config(WL_CFGS["paxos"], wl), GROUPS,
                       steps, seed=SEED, device=DEVICE)
        wall_s = time.perf_counter() - t0
        ref = lane[wl]
        done = int(res.metrics["committed_slots"])
        counts = {c: (int(res.metrics[f"wl_{c}_n"]),
                      int(ref.metrics[f"wl_{c}_n"]))
                  for c in ("hot", "warm", "cold")}
        kv_equal = bool(torch.equal(res.state["kv"], ref.state["kv"]))
        row = {"workload": wl, "groups": GROUPS, "steps": steps,
               "paxos_pg_committed": done,
               "paxos_committed": int(ref.metrics["committed_slots"]),
               "paxos_pg_slots_per_s": done / wall_s,
               "paxos_slots_per_s": ref.metrics["committed_slots"].item()
               / lane[wl + "_wall_s"],
               "kv_equal": kv_equal, "class_counts_pg_vs_lane": counts,
               "invariant_violations": int(res.violations),
               "inscan_violations": res.inscan_violations,
               "kernels": launch_counts(),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "device": smi}
        log("lowering_pin " + json.dumps(row))
        if int(res.violations) != 0 or res.inscan_violations != 0:
            fail(f"paxos_pg {wl}: safety violations")
        if any(n for n in row["kernels"].values()):
            fail(f"paxos_pg {wl}: a hand-written kernel launched; the "
                 "per-group exchange is tensor code")
        if wl == "zipf99":
            if not kv_equal or any(a != b for a, b in counts.values()):
                fail("lowering pin: paxos and paxos_pg differ under zipf99")
            if done != WL_EXPECT[("paxos", "zipf99")]:
                fail(f"paxos_pg zipf99 committed {done}")
        elif not 0 < done < int(lane["zipf99"].metrics["committed_slots"]):
            fail(f"paxos_pg flash is not gated: {done}")
        del res
        torch.cuda.empty_cache()


def plane_calls(path: str):
    """The calls of one step's workload hash planes at GROUPS groups, by
    name: paxos's class plane (R, S, G), its executor's key and read planes
    (R, G) x exec_window and its demand gate (1, G); wpaxos's demand keys
    (R, G) on R channels."""
    from paxi_tpu_torch.sim import cell
    from paxi_tpu_torch.workload import compile as wlc

    dev = torch.device(DEVICE)
    cfg = wl_config(WL_CFGS[path], "flash")
    spec, K, R = cfg.workload, cfg.n_keys, cfg.n_replicas
    gid = torch.arange(GROUPS, dtype=torch.int32, device=dev)[None, :]
    base = torch.randint(0, 10_000, (R, GROUPS), dtype=torch.int32,
                         device=dev)
    if path == "wpaxos":
        chan = wlc.CH_DEMAND + torch.arange(R, dtype=torch.int32,
                                            device=dev)[:, None]
        return {"demand_keys": lambda: wlc.key_plane(spec, K, gid, 37,
                                                     chan=chan)}
    A = cell.cell_abs(base, cfg.n_slots)
    return {
        "class_plane": lambda: wlc.class_plane(spec, K, gid[None], A),
        "key_and_read_planes": lambda: [
            (wlc.key_plane(spec, K, gid, base + e),
             wlc.read_plane(spec, gid, base + e))
            for e in range(cfg.exec_window)],
        "demand_gate": lambda: wlc.demand_gate(spec, gid, 37)}


def workload_planes_phase(smi: str):
    """The time of a step's workload hash planes at GROUPS groups."""
    out = {path: {k: median_ms(f, reps=10)
                  for k, f in plane_calls(path).items()}
           for path in WL_CFGS}
    log("workload_planes " + json.dumps({"groups": GROUPS, "ms": out,
                                         "device": smi}))


def workload_small_phase():
    """Every matrix cell and paxos_pg, fault-free and fuzzed, card against
    CPU at WL_SMALL_GROUPS x WL_SMALL_STEPS on every plane."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, simulate

    cases = [(p, wl) for p in WL_CFGS for wl in WL_NAMES] \
        + [("paxos_pg", None), ("paxos_pg", "zipf99"), ("paxos_pg", "flash")]
    for path, wl in cases:
        cfg = wl_config(WL_CFGS["paxos" if path == "paxos_pg" else path], wl)
        for label, fuzz in (("fault_free", FAULT_FREE),
                            ("fuzz", FuzzConfig(**FUZZ_ARGS))):
            t0 = time.perf_counter()
            runs = [simulate(sim_protocol(path), cfg, WL_SMALL_GROUPS,
                             WL_SMALL_STEPS, fuzz, seed=SEED, device=d)
                    for d in ("cpu", DEVICE)]
            compare_runs(*runs, f"{path} {wl} {label}")
            log("card_vs_cpu " + json.dumps({
                "protocol": path, "workload": wl, "schedule": label,
                "groups": WL_SMALL_GROUPS, "steps": WL_SMALL_STEPS,
                "equal": True,
                "committed_slots": int(runs[1].metrics["committed_slots"]),
                "violations": int(runs[1].violations),
                "seconds": time.perf_counter() - t0}))


def pg_pin_schedule():
    """The traced group's schedule of a paxos_pg record run on the card
    (PG_SHARD_GROUPS groups, fuzzed, zipf99), for phase 6's sharded pinned
    replay, and the one-device pinned replay and run it is held to."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import (make_pinned_run, make_recorded_run,
                                           make_run)

    proto = sim_protocol("paxos_pg")
    cfg = wl_config(WL_CFGS["paxos"], "zipf99")
    fuzz = FuzzConfig(**FUZZ_ARGS)
    g = PG_PIN["group"]
    rec = make_recorded_run(proto, cfg, fuzz, device=DEVICE)(
        tr.PRNGKey(SEED), PG_SHARD_GROUPS, PG_PIN["steps"])

    def pick(x):
        if isinstance(x, dict):
            return {k: pick(v) for k, v in x.items()}
        return x[:, g].cpu().numpy()
    sched = pick(rec[4])
    pinned = make_pinned_run(proto, cfg, fuzz, g, device=DEVICE)(
        tr.PRNGKey(SEED), PG_SHARD_GROUPS, sched)
    plain = make_run(proto, cfg, fuzz, device=DEVICE)(
        tr.PRNGKey(SEED), PG_SHARD_GROUPS, SMALL_STEPS)
    return sched, pinned, plain


def workload_sharded_lines(pg, card_small, pg_ref, smi: str):
    """Phase 7's sharded checks, run inside phase 6's spawn: the zipf99
    paxos run against its one-device run on the card (kv, class counts,
    commits: the global group ids), the padded paxos_pg run and the
    sharded pinned replay each against its one-device run, every plane."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import simulate

    one = simulate(sim_protocol("paxos"),
                   wl_config(WL_CFGS["paxos"], "zipf99"), WL_SHARD_GROUPS,
                   SMALL_STEPS, seed=SEED, device=DEVICE)
    st, m, _ = card_small["paxos_zipf99"]
    keys = ["committed_slots"] + [f"wl_{c}_n" for c in ("hot", "warm",
                                                        "cold")]
    if not (st["kv"] == one.state["kv"].cpu().numpy()).all() \
            or any(m[k] != int(one.metrics[k]) for k in keys):
        fail("sharded zipf99 paxos differs from its one-device run")
    sched, pinned, plain = pg_ref
    same_run(plain, pg["run"], "sharded paxos_pg (257 groups)")
    same_run(pinned[:3], pg["pinned"][:3], "sharded pinned replay")
    if not (pinned[3].cpu().numpy() == pg["pinned"][3]).all():
        fail("sharded pinned replay: per-step violations differ")
    log("workload_sharded " + json.dumps({
        "world": SHARD_WORLD, "ranks_share_one_card": True,
        "zipf99_paxos": {"groups": WL_SHARD_GROUPS, "steps": SMALL_STEPS,
                         "kv_and_class_counts_equal_one_device": True,
                         **{k: m[k] for k in keys}},
        "paxos_pg_pad": {"groups": PG_SHARD_GROUPS, "steps": SMALL_STEPS,
                         "pad_groups": (-PG_SHARD_GROUPS) % SHARD_WORLD,
                         "equal_one_device": True,
                         "committed_slots": pg["run"][1]["committed_slots"]},
        "pinned_replay": {"group": PG_PIN["group"], "steps": PG_PIN["steps"],
                          "equal_make_pinned_run": True,
                          "violations": pg["pinned"][2]},
        "device": smi}))


# ---- phase 8: the protocols of slice 8 and their seeded twins ----------

def capture_replay_phase(name: str, cfg_kw, fuzz_args, steps: int,
                         smi: str, line: str = "twin_path",
                         save_as: str = ""):
    """A kernel that violates at GROUPS groups under ``fuzz_args`` (a
    seeded twin, or a row whose reference run violates): captured (every
    group's schedule recorded on the card; a violating group must be
    found) and replayed once to the capture's hash, counters, histogram
    and violations; with ``save_as`` the trace is saved under that path.
    Returns the capture's and the replay's launch counts and the trace's
    schedule hash."""
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig

    fuzz = FuzzConfig(**fuzz_args)
    proto, cfg = sim_protocol(name), SimConfig(**cfg_kw)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr_ = T.capture(proto, cfg, fuzz, SEED, GROUPS, steps, device=DEVICE)
    capture_s = time.perf_counter() - t0
    capture_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if tr_ is None:
        fail(f"{name} found no violating group")
    expect_launches(f"{name} capture", capture_launches, steps)
    m = tr_.meta
    sched_bytes = sum(v.nbytes for v in (tr_.sched["conn"],
                                         tr_.sched["crashed"]))
    sched_bytes += sum(v.nbytes for f in tr_.sched["faults"].values()
                       for v in f.values())
    reset_launch_counts()
    t0 = time.perf_counter()
    r = T.replay(tr_, device=DEVICE)
    replay_s = time.perf_counter() - t0
    replay_launches = launch_counts()
    expect_launches(f"{name} replay", replay_launches, steps)
    for what, got, want in (
            ("state hash", r.state_hash, m["capture_state_hash"]),
            ("counters", r.counters, m["capture_counters"]),
            ("latency histogram", r.lat_hist, m.get("capture_lat_hist")),
            ("violations", r.violations, m["group_violations"])):
        if got != want:
            fail(f"{name} replay: {what} {got} != capture's {want}")
    log(line + " " + json.dumps({
        "protocol": name, "schedule": fuzz_args,
        "groups": GROUPS, "steps": steps, "config": cfg_kw,
        "group": m["group"], "group_violations": m["group_violations"],
        "first_violation_step": m["first_violation_step"],
        "n_events": tr_.n_events(), "capture_wall_s": capture_s,
        "replay_wall_s": replay_s, "replay_equal_to_capture": True,
        "recorded_schedule_bytes": sched_bytes * GROUPS,
        "peak_memory_bytes": peak, "kernels": capture_launches,
        "state_hash": r.state_hash, "device": smi}))
    if save_as:
        import os
        os.makedirs(os.path.dirname(save_as), exist_ok=True)
        T.save(save_as, tr_)
    del tr_, r
    torch.cuda.empty_cache()
    return capture_launches, replay_launches, m["schedule_hash"]


def twin_phase(smi: str):
    """The seeded twins at GROUPS groups under DROP: ``wankeeper_nofloor``
    captured, replayed and saved for phase 13 (``capture_replay_phase``);
    ``bpaxos_noread``
    run, which must violate; noread card against CPU at
    TWIN_SMALL_GROUPS.  Returns the capture's and the noread run's launch
    counts."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig, simulate

    capture_launches = capture_replay_phase(
        "wankeeper_nofloor", TWIN_CFGS["wankeeper_nofloor"], TWIN_DROP_ARGS,
        TWIN_STEPS, smi, save_as=NOFLOOR_WITNESS)[0]
    fuzz = FuzzConfig(**TWIN_DROP_ARGS)
    proto = sim_protocol("bpaxos_noread")
    cfg = SimConfig(**TWIN_CFGS["bpaxos_noread"])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = simulate(proto, cfg, GROUPS, TWIN_STEPS, fuzz, seed=SEED,
                   device=DEVICE)
    wall_s = time.perf_counter() - t0
    noread_launches = launch_counts()
    log("twin_path " + json.dumps({
        "protocol": "bpaxos_noread", "schedule": TWIN_DROP_ARGS,
        "groups": GROUPS, "steps": TWIN_STEPS,
        "config": TWIN_CFGS["bpaxos_noread"],
        "invariant_violations": int(res.violations),
        "committed_slots": int(res.metrics["committed_slots"]),
        "recoveries": int(res.metrics["recoveries"]), "wall_s": wall_s,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "kernels": noread_launches, "device": smi}))
    if not int(res.violations) > 0:
        fail("bpaxos_noread did not violate under DROP")
    expect_launches("noread run", noread_launches, TWIN_STEPS)
    del res

    card_vs_cpu_case("bpaxos_noread", TWIN_CFGS["bpaxos_noread"],
                     "hunt_drop", TWIN_SMALL_GROUPS, TWIN_STEPS, True)
    return capture_launches, noread_launches


def slice8_small_phase():
    """Every slice-8 kernel and twin, fault-free and fuzzed, card against
    CPU at WL_SMALL_GROUPS x WL_SMALL_STEPS on every plane."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    cases = {}
    for r in PROTO_ROWS.values():          # a protocol's first row
        cases.setdefault(r["protocol"], r["cfg"])
    cases.update(TWIN_CFGS)
    for name, cfg_kw in cases.items():
        card_vs_cpu_phase(name, sim_protocol(name), SimConfig(**cfg_kw),
                          "committed_slots", WL_SMALL_GROUPS,
                          WL_SMALL_STEPS)


# ---- phase 9: switchpaxos, its nogap twin and the demo kernels ----------

def switch_pair_phase(smi: str):
    """bench_all.py's switchnet pair and the hunt's seqchurn case at
    GROUPS groups (``SWITCH_ROWS``), each held to its count with one launch
    of each exchange half a step; the switch must commit at least one
    round sooner than paxos at the median (the reference's ``verify.sh
    --bench`` check) and seqchurn must detect stamp gaps."""
    rows = {k: new_path_run(k, smi, SWITCH_ROWS) for k in SWITCH_ROWS}
    p50 = {k: rows[k]["commit_latency"]["p50_rounds"]
           for k in ("switchpaxos_wan3z", "paxos_wan3z_base")}
    log("switch_pair " + json.dumps({
        "p50_rounds": p50,
        "p99_rounds": {k: rows[k]["commit_latency"]["p99_rounds"]
                       for k in p50},
        "rounds_saved_at_p50": p50["paxos_wan3z_base"]
        - p50["switchpaxos_wan3z"], "device": smi}))
    if not p50["switchpaxos_wan3z"] + 1 <= p50["paxos_wan3z_base"]:
        fail(f"switch p50 not a round under paxos: {p50}")
    if not rows["switchpaxos_seqchurn"]["gap_events"] > 0:
        fail("switchpaxos under seqchurn detected no stamp gap")
    return rows


def slice9_small_phase():
    """Switchpaxos fault-free and under the hunt's schedules, the nogap
    twin, and the two per-group demo kernels, card against CPU."""
    for sched in ("fault_free", "hunt_drop", "part", "kill"):
        card_vs_cpu_case("switchpaxos", HUNT_SWITCH_CFG, sched,
                         SWITCH_SMALL_GROUPS, SWITCH_SMALL_STEPS, False)
    card_vs_cpu_case("switchpaxos", SEQCHURN_CFG, "seqchurn_drop",
                     SWITCH_SMALL_GROUPS, SWITCH_SMALL_STEPS, False)
    card_vs_cpu_case("switchpaxos_nogap", HUNT_SWITCH_CFG, "hunt_drop",
                     NOGAP_SMALL_GROUPS, NOGAP_STEPS, True)
    for name, (cfg_kw, scheds, groups, steps) in DEMO_CASES.items():
        for sched in scheds:
            card_vs_cpu_case(name, cfg_kw, sched, groups, steps, True)


# ---- phase 10: the drivers -------------------------------------------------

def captured(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def cli_phase(smi: str):
    """The CLI's main path in-process at full width (held to 10,000,000
    committed slots, 0 violations, one launch of each exchange half a
    step), then ``python -m paxi_tpu_torch`` in a short subprocess."""
    from paxi_tpu_torch import cli
    reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = captured(cli.main, CLI_ARGV)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    line = json.loads(out)
    steps = PATHS["paxos"]["steps"]
    log("cli_path " + json.dumps({
        "argv": CLI_ARGV, "rc": rc,
        "committed_slots": line["committed_slots"],
        "invariant_violations": line["invariant_violations"],
        "inscan_violations": line["inscan_violations"],
        "committed_paxos_slots_per_sec": line["committed_slots"] / wall_s,
        "wall_s": wall_s, "kernels": launches, "device": smi}))
    if rc != 0 or line["invariant_violations"] != 0 \
            or line["inscan_violations"] != 0:
        fail(f"cli sim: rc {rc}, violations {line['invariant_violations']}")
    if line["committed_slots"] != PATHS["paxos"]["expect"](steps):
        fail(f"cli sim committed {line['committed_slots']}")
    expect_launches("cli main path", launches, steps)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paxi_tpu_torch"] + CLI_SUBPROCESS_ARGV,
        capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent))
    sub = json.loads(proc.stdout.strip().splitlines()[-1]) \
        if proc.returncode == 0 else {}
    log("cli_subprocess " + json.dumps({
        "argv": CLI_SUBPROCESS_ARGV, "rc": proc.returncode,
        "committed_slots": sub.get("committed_slots"),
        "invariant_violations": sub.get("invariant_violations"),
        "wall_s": time.perf_counter() - t0}))
    if proc.returncode != 0 or sub["committed_slots"] != 16 * 1024 \
            or sub["invariant_violations"] != 0:
        fail(f"python -m paxi_tpu_torch sim: rc {proc.returncode}, "
             f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
    return launches


def host_replay(trace):
    """One host replay of ``trace`` on the virtual-clock fabric (asyncio
    on the CPU): its ``HostOutcome`` and wall s."""
    import asyncio
    from paxi_tpu_torch.hunt import replay_witness
    t0 = time.perf_counter()
    out = asyncio.run(replay_witness(trace))
    return out, time.perf_counter() - t0


def campaign_runs_on_cpu(state: dict, protocols):
    """Each run of a campaign's ``state`` run again on the CPU (its case,
    schedule and seed): its violations and progress must equal the
    card's.  Returns the run -> case lookup."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import make_run

    cases = hunt_cases.hunt_cases(list(protocols), quick=True)

    def case_of(run):
        name, cfg, scheds, groups, steps, pkey = \
            cases[run["protocol"]][int(run["run"].split(":")[0])]
        fz = next(f for f in scheds
                  if hunt_cases.sched_name(f) == run["schedule"])
        return name, cfg, fz, groups, steps, pkey

    for run in state["runs"]:
        name, cfg, fz, groups, steps, pkey = case_of(run)
        _, metrics, viols = make_run(sim_protocol(name), cfg, fz,
                                     device="cpu")(
            tr.PRNGKey(run["seed"]), groups, steps)
        cpu = (int(viols), int(metrics[pkey]))
        if cpu != (run["violations"], run["progress"]):
            fail(f"hunt run {run['protocol']} {run['run']}: card "
                 f"{(run['violations'], run['progress'])}, CPU {cpu}")
    return case_of


def witness_host_lines(state: dict, corpus, label: str) -> dict:
    """One ``label`` line a witness of a campaign's ``state``: its verdict,
    and its host outcome read twice from its file, equal to each other
    (spans included) and to the campaign's.  Returns witness -> verdict."""
    verdicts = {}
    for h, wit in sorted(state["witnesses"].items()):
        cl = wit["classification"]
        line = {"witness": h, "protocol": wit["protocol"],
                "outcome": cl["outcome"], "reason": cl["reason"],
                "host": cl.get("host"), "host_replay_wall_s": None}
        if cl["outcome"] not in ("reproduced", "diverged", "unmappable"):
            fail(f"hunt run: witness {h[:16]} unclassified: {cl}")
        if cl.get("host") is not None:
            trace = corpus.load(wit.get("minimal") or h)
            (a, sa), (b, sb) = host_replay(trace), host_replay(trace)
            if a.to_json() != b.to_json() or a.spans != b.spans:
                fail(f"hunt witness {h[:16]}: two host replays differ: "
                     f"{a.to_json()} / {b.to_json()}")
            if a.to_json() != cl["host"]:
                fail(f"hunt witness {h[:16]}: host replay {a.to_json()} "
                     f"!= the campaign's {cl['host']}")
            line.update(host_replay_wall_s=[sa, sb], replays_equal=True)
        log(label + " " + json.dumps(line))
        verdicts[h] = cl["outcome"]
    return verdicts


def hunt_campaign_phase(witness_hash: str, smi: str):
    """``hunt run`` on the card with host replay on: the nogap witness
    captured, shrunk and replayed to its hash, every witness classified
    (``reproduced``/``diverged``/``unmappable``, none unclassified), phase
    9's 100k seqchurn witness classified through the backlog, each run's
    violations and progress equal to the same (case, seed) run on the CPU;
    then each witness's host outcome read twice more from its file (equal
    to each other and to the campaign's, spans included), and the nogap
    capture's host outcome equal to the same run captured on the CPU."""
    import shutil
    from paxi_tpu_torch import cli
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.hunt import Corpus
    from paxi_tpu_torch.protocols import sim_protocol

    shutil.rmtree(HUNT_DIR, ignore_errors=True)
    argv = ["hunt", "run", "--dir", HUNT_DIR, "--traces-dir", WITNESS_DIR] \
        + HUNT_ARGV
    reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = captured(cli.main, argv)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(HUNT_DIR + "/state.json") as f:
        state = json.load(f)
    with open(HUNT_DIR + "/HUNT_REPORT.json") as f:
        totals = json.load(f)["summary"]["totals"]
    log("hunt_campaign " + json.dumps({
        "argv": argv, "rc": rc, "totals": totals, "runs": state["runs"],
        "wall_s": wall_s, "kernels": launches, "device": smi}))
    if rc != 0 or totals["unclassified"] != 0:
        fail(f"hunt run: rc {rc}, totals {totals}\n{out[-2000:]}")
    if not (launches["wheel_deliver"] > 0 and launches["wheel_insert"] > 0):
        fail(f"hunt run launched no exchange kernel: {launches}")

    case_of = campaign_runs_on_cpu(state,
                                   ["switchpaxos", "switchpaxos_nogap"])

    corpus = Corpus(HUNT_DIR + "/corpus")
    caught = [r.get("witness") for r in state["runs"]
              if r["protocol"] == "switchpaxos_nogap"]
    nogap = [w for w in state["witnesses"].values()
             if w["capture"] in caught]
    if len(nogap) != 1:
        fail(f"hunt run: {len(nogap)} nogap witnesses from its runs")
    w = nogap[0]
    if not (w["capture"] in corpus and w["minimal"] in corpus
            and w["events_after"] <= w["events_before"]):
        fail(f"hunt run: the nogap witness was not captured and shrunk: {w}")
    mini = corpus.load(w["minimal"])
    r = T.replay(mini, device=DEVICE)
    if r.state_hash != mini.meta["replay_state_hash"] \
            or r.violations != mini.meta["group_violations"]:
        fail("hunt run: the shrunk nogap witness replays to another state")
    backlog = state["witnesses"].get(witness_hash)
    if backlog is None or "coverage" not in backlog["classification"]:
        fail("hunt run: the 100k seqchurn witness was not classified")
    c = backlog["classification"]
    log("hunt_witness_coverage " + json.dumps({
        "witness": witness_hash, "protocol": backlog["protocol"],
        "origin": corpus.index[witness_hash]["origin"],
        "violations": backlog["violations"],
        "events": backlog["events_before"], "outcome": c["outcome"],
        "reason": c["reason"], **c["coverage"]}))
    log("hunt_nogap_witness " + json.dumps({
        "capture": w["capture"], "minimal": w["minimal"],
        "violations": w["violations"], "events_before": w["events_before"],
        "events_after": w["events_after"],
        "outcome": w["classification"]["outcome"],
        "replay_state_hash": r.state_hash, "replay_equal": True}))

    witness_host_lines(state, corpus, "hunt_witness_host")

    # the nogap run captured again on the CPU: the same schedule, the
    # same host outcome and span timeline as the card's capture
    run = next(r for r in state["runs"] if r.get("witness") == w["capture"])
    name, cfg, fz, groups, steps, _ = case_of(run)
    t0 = time.perf_counter()
    cpu_t = T.capture(sim_protocol(name), cfg, fz, run["seed"], groups,
                      steps, proto_name=name, device="cpu")
    cpu_capture_s = time.perf_counter() - t0
    card_out, card_s = host_replay(corpus.load(w["capture"]))
    cpu_out, cpu_s = host_replay(cpu_t)
    same = (cpu_t.meta["schedule_hash"] == w["capture"]
            and cpu_out.to_json() == card_out.to_json()
            and cpu_out.spans == card_out.spans)
    log("hunt_nogap_cpu_capture " + json.dumps({
        "card_capture": w["capture"],
        "cpu_capture": cpu_t.meta["schedule_hash"],
        "cpu_capture_wall_s": cpu_capture_s, "host": card_out.to_json(),
        "host_replay_wall_s": {"card_capture": card_s,
                               "cpu_capture": cpu_s},
        "equal": same}))
    if not same:
        fail(f"hunt nogap: the CPU capture's host outcome "
             f"{cpu_out.to_json()} != the card's {card_out.to_json()}")

    # trace host --all over the 100k seqchurn witness
    path = str(corpus.path_of(witness_hash))
    rc, out = captured(cli.main, ["trace", "host", path, "--all"])
    cov = json.loads(out)["coverage"]
    log("trace_host_all " + json.dumps({
        "witness": witness_hash, "rc": rc,
        "trace_protocol": json.loads(out)["trace_protocol"],
        "coverage": {k: cov[k] for k in ("switchpaxos",
                                         "switchpaxos_nogap", "paxos")}}))
    if rc != 0 or cov["switchpaxos"] != c["coverage"]:
        fail(f"trace host --all: rc {rc}, {cov.get('switchpaxos')} != the "
             f"hunt's coverage {c['coverage']}")

    # scenario run -host: paxos under wan3z on the host fabric
    t0 = time.perf_counter()
    rc, out = captured(cli.main, SCENARIO_HOST_ARGV)
    got = (rc, json.loads(out))
    log("scenario_host " + json.dumps({
        "argv": SCENARIO_HOST_ARGV, "rc": rc, "line": got[1],
        "wall_s": time.perf_counter() - t0,
        "equal_to_reference": got == SCENARIO_HOST_WANT}))
    if got != SCENARIO_HOST_WANT:
        fail(f"scenario run -host: {got} != {SCENARIO_HOST_WANT}")
    return launches


def bench_twin_phase(smi: str):
    """bench_all's paxos_3rep row at its card shape through the twin's
    own line function (a warm run, then the timed run), held to its
    count with one launch of each exchange half a step a run."""
    spec = DRIVER_ROWS["bench_paxos_3rep"]
    row = BENCH_ROWS["paxos_3rep"]
    reset_launch_counts()
    line = bench_all.protocol_line(row, device=DEVICE)
    launches = launch_counts()
    log("bench_all_path " + json.dumps({**line, "kernels": launches,
                                        "nvidia_smi": smi}))
    for k, want in spec["expect"].items():
        if line[k] != want:
            fail(f"bench_all paxos_3rep: {k} {line[k]}, expected {want}")
    if line["invariant_violations"] or line.get("inscan_violations"):
        fail("bench_all paxos_3rep: safety violations")
    expect_launches("bench_all paxos_3rep", launches, 2 * spec["steps"])
    return launches


def soak_twin_phase(smi: str):
    """fuzz_soak's record of one (case, schedule, seed) on the card and on
    the CPU: equal apart from ``wall_s``, 0 violations."""
    from paxi_tpu_torch import fuzz_soak
    name, sched, seed = SOAK_CASE
    case = next(c for c in hunt_cases.CASES if c[0] == name)
    fz = next(f for f in case[2] if hunt_cases.sched_name(f) == sched)
    args = (name, case[1], fz, seed, case[3], case[4], case[5])
    reset_launch_counts()
    card = fuzz_soak.soak_record(*args, device=DEVICE)
    launches = launch_counts()
    cpu = fuzz_soak.soak_record(*args, device="cpu")
    log("fuzz_soak_path " + json.dumps({**card, "cpu_wall_s": cpu["wall_s"],
                                        "kernels": launches,
                                        "device": smi}))
    card.pop("wall_s")
    cpu.pop("wall_s")
    if card != cpu:
        fail(f"fuzz_soak record: card {card} != CPU {cpu}")
    if card["violations"] != 0:
        fail("fuzz_soak record: violations")
    expect_launches("fuzz_soak record", launches, case[4])
    return launches


# ---- phase 11: the bench twin, the layout A/B, the sliding-window twins ---

ROOT = Path(__file__).resolve().parent


def bench_in_process(kernel: str):
    """``paxi_tpu_torch.bench.worker`` in this process for ``kernel``, no
    sweep, with the launch counts set to 0 just before its timed run and
    read just after: ``(exit code, line, launches)``."""
    from paxi_tpu_torch import bench
    env = {"BENCH_SCALING": "0", "BENCH_KERNEL": kernel}
    saved = {k: os.environ.get(k) for k in env}
    launches = {}

    @contextlib.contextmanager
    def timed():
        reset_launch_counts()
        yield
        launches.update(launch_counts())

    os.environ.update(env)
    try:
        rc, out = captured(lambda: bench.worker(device=DEVICE, timed=timed))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, json.loads(out.strip().splitlines()[-1]), launches


def north_star_bench_phase(main_row: dict, smi: str):
    """``python -m paxi_tpu_torch.bench`` as a user runs it (a subprocess,
    the card's default shape): its line held to the main path's count,
    violations and latency histogram (phase 4's ``main_path``), exit code
    0; its sweep to 32 slots a group at each point; then the worker again
    in-process, the launches of its timed run counted (one of each
    exchange half a step).  Returns the in-process line and launches."""
    steps = PATHS["paxos"]["steps"]
    want = PATHS["paxos"]["expect"](steps)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "paxi_tpu_torch.bench"],
                          capture_output=True, text=True, timeout=900,
                          cwd=str(ROOT))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"python -m paxi_tpu_torch.bench: rc {proc.returncode}\n"
             f"{proc.stdout[-1000:]}\n{proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    curve = json.loads(proc.stderr.split("bench-scaling: ")[1]
                       .splitlines()[0])
    rc, again, launches = bench_in_process("paxos")
    log("bench_twin " + json.dumps({
        **line, "rc": proc.returncode, "subprocess_wall_s": wall_s,
        "in_process": {k: again[k] for k in (
            "value", "committed_slots", "wall_s", "compile_s", "warmup_s",
            "invariant_violations", "inscan_violations")},
        "kernels_timed_run": launches, "nvidia_smi": smi}))
    log("bench_scaling " + json.dumps(curve))
    backend = "cuda" if torch.device(DEVICE).type == "cuda" else "plain"
    for got in (line, again):
        if got["committed_slots"] != want or got["steps"] != steps \
                or got["groups"] != GROUPS or got["kernel"] != "paxos" \
                or got["backend"] != backend:
            fail(f"bench twin line {got}")
        if got["invariant_violations"] != 0 or got["inscan_violations"] != 0:
            fail("bench twin: safety violations")
        if got["committed_slots"] != main_row["committed_slots"] \
                or got["commit_latency"] != main_row["commit_latency"]:
            fail(f"bench twin: {got['commit_latency']} != main path "
                 f"{main_row['commit_latency']}")
    if rc != 0:
        fail(f"bench twin in-process: rc {rc}")
    expect_launches("bench twin timed run", launches, steps)
    points = curve["points"]
    if [p["groups"] for p in points] != list(BENCH_SWEEP) + [GROUPS]:
        fail(f"bench sweep points {points}")
    for p in points[:-1]:
        if p["steps"] != BENCH_SWEEP_STEPS \
                or p["committed"] != (BENCH_SWEEP_STEPS - 4) * p["groups"]:
            fail(f"bench sweep point {p}")
    if not (ROOT / "build" / "bench" / "BENCH_SCALING.json").exists():
        fail("bench sweep: no build/bench/BENCH_SCALING.json")
    return again, launches


def layout_ab_phase(paxos_line: dict, smi: str):
    """``--kernel paxos_sw`` beside ``--kernel paxos`` at the north star
    (one in-process worker call each, in this order): equal committed
    slots, violations and commit-latency sum, each with its rate; then
    ``paxos_sw``'s step split (CUDA events between the runner's stages;
    ``paxos``'s is phase 4's) and each one's profile
    (``scripts/torch_step_profile.py``)."""
    from paxi_tpu_torch.profiling import resolve_kernel
    from paxi_tpu_torch.sim import FAULT_FREE, SimConfig
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_step_profile

    rc, sw_line, launches = bench_in_process("paxos_sw")
    # the commit-latency sum (the histogram snapshot's, in seconds of one
    # round each); the sample count may differ (the pending plane)
    lat = {k: line["sim_metrics"]["histograms"][0]["sum"]
           for k, line in (("paxos", paxos_line), ("paxos_sw", sw_line))}
    log("layout_ab " + json.dumps({
        "paxos": {k: paxos_line[k] for k in (
            "value", "committed_slots", "wall_s", "invariant_violations",
            "inscan_violations", "commit_latency")},
        "paxos_sw": {k: sw_line[k] for k in (
            "value", "committed_slots", "wall_s", "invariant_violations",
            "inscan_violations", "commit_latency")},
        "sw_over_fixed_wall": sw_line["wall_s"] / paxos_line["wall_s"],
        "commit_lat_sum": lat, "kernels_timed_run_sw": launches,
        "groups": GROUPS, "steps": sw_line["steps"], "device": smi}))
    if rc != 0 or sw_line["invariant_violations"] \
            or sw_line["inscan_violations"]:
        fail(f"paxos_sw: rc {rc}, violations")
    if sw_line["committed_slots"] != paxos_line["committed_slots"] \
            or lat["paxos"] != lat["paxos_sw"]:
        fail(f"layout A/B: paxos_sw {sw_line['committed_slots']}, "
             f"{lat['paxos_sw']} != paxos {paxos_line['committed_slots']}, "
             f"{lat['paxos']}")
    expect_launches("paxos_sw timed run", launches, sw_line["steps"])
    # paxos's step split is phase 4's (the same configuration)
    step_split_phase("paxos_sw", resolve_kernel("paxos_sw"),
                     SimConfig(**PATHS["paxos"]["cfg"]), FAULT_FREE,
                     "fault_free")
    for kname in ("paxos", "paxos_sw"):
        rows, summary = torch_step_profile.profile_steps(
            kname, GROUPS, steps=PROFILE_STEPS, top=8)
        log("layout_ab_profile " + json.dumps({
            **summary, "top": [dict(f, kind=k) for k, f in rows]}))
        torch.cuda.empty_cache()
    return launches


def sw_small_phase():
    """Every sliding-window twin at its row's configuration, card against
    CPU at 64 x 12 under the hunt's DROP: equal state, metrics (the
    ``net_*`` counters among them) and violations, and no violation."""
    for name, cfg_kw in SW_SMALL_CFGS.items():
        card_vs_cpu_case(name, cfg_kw, "hunt_drop", SW_SMALL_GROUPS,
                         SW_SMALL_STEPS, violate=False)


def workload_demo_phase():
    """``python -m paxi_tpu_torch.workload.demo`` on the card (its own
    asserts run there): its four stage lines equal the CPU's."""
    from paxi_tpu_torch.workload import demo
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "paxi_tpu_torch.workload.demo"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    card_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"workload demo: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    rc, cpu = captured(demo.main, ["--device", "cpu"])
    card = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    cpu = [json.loads(x) for x in cpu.strip().splitlines()]
    log("workload_demo " + json.dumps({
        "stages": [x["stage"] for x in card], "equal_to_cpu": card == cpu,
        "steals": card[-1].get("steals"), "card_wall_s": card_s}))
    if rc != 0 or len(card) != 4 or card != cpu:
        fail(f"workload demo: card {card} != CPU {cpu}")



# ---- phase 12: the host-sync audit ---------------------------------------

def audit_fuzz(name: str):
    from paxi_tpu_torch.sim import FuzzConfig
    if name == "fuzz":
        return FuzzConfig(**FUZZ_ARGS)
    if name == "geo3z":
        return geo_fuzz()
    return schedule_of(name)


def repo_site(stack) -> str:
    """The innermost frame of ``stack`` inside the port's package, as a
    repo-relative ``path:line``; else the innermost frame outside the
    ``warnings`` module, the whole chain of frames spelled out."""
    pkg = str(ROOT / "paxi_tpu_torch") + os.sep
    for frame in reversed(stack):
        if frame.filename.startswith(pkg):
            return f"{Path(frame.filename).relative_to(ROOT)}:{frame.lineno}"
    import warnings
    own = warnings.__file__
    return " < ".join(f"{f.filename}:{f.lineno}" for f in reversed(stack)
                      if f.filename != own)


def audit_run(name: str, cfg_kw, sched: str):
    """``(syncs a step, {site: count}, launches)`` of one kernel's audited
    steps: AUDIT_WARMUP steps, then AUDIT_STEPS of ``run_steps`` with the
    CUDA sync debug mode at "warn", every warning's innermost repo frame
    recorded (``warnings.showwarning`` sees the whole stack) and the
    kernel launches of those steps counted."""
    import traceback
    import warnings
    from collections import Counter

    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.profiling import resolve_kernel
    from paxi_tpu_torch.sim import SimConfig, runner
    proto, cfg, fuzz = resolve_kernel(name), SimConfig(**cfg_kw), \
        audit_fuzz(sched)
    body = runner.make_scan_body(proto, cfg, fuzz)
    sites = Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            sites[repo_site(traceback.extract_stack()[:-1])] += 1

    with torch.inference_mode():
        carry = runner.init_carry(proto, cfg, fuzz, AUDIT_GROUPS,
                                  tr.PRNGKey(SEED), DEVICE)
        carry = runner.run_steps(body, carry, AUDIT_WARMUP)[0]
        torch.cuda.synchronize()
        reset_launch_counts()
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = runner.run_steps(body, carry, AUDIT_STEPS,
                                       t0=AUDIT_WARMUP)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    launches = launch_counts()
    del out, carry
    return sum(sites.values()) / AUDIT_STEPS, dict(sites), launches


def sync_audit_phase(smi: str):
    """Phase 12: every runtime host-sync site of the audited steps must be
    a line the port's lint reports under PXK104 or PXK107 (kept or
    baselined); a flagged line that never fires is printed as
    static-only.  Returns ``({run label: syncs a step}, the kernel
    launches of the audited steps)``."""
    import warnings

    from paxi_tpu_torch import analysis
    from paxi_tpu_torch.analysis import purity
    t0 = time.perf_counter()
    # the first switch into the debug mode reports a sync of its own (the
    # harness's, torch/cuda/__init__.py): take it here, outside the runs
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    report = analysis.run_lint(rules=["kernel-purity"])
    flagged = purity.flagged_spans(
        ROOT, report.violations + [v for v, _ in report.suppressed])
    lint_s = time.perf_counter() - t0
    per_step, fired, missed = {}, set(), []
    launches = dict.fromkeys(launch_counts(), 0)
    for name, cfg_kw, sched in AUDIT_RUNS:
        t_run = time.perf_counter()
        rate, sites, ran = audit_run(name, cfg_kw, sched)
        t_run = time.perf_counter() - t_run
        launches = {k: v + ran[k] for k, v in launches.items()}
        label = f"{name}/{sched}"
        per_step[label] = rate
        for site, n in sites.items():
            path, _, line = site.rpartition(":")
            span = next((sp for sp in flagged.get(path, ())
                         if sp[0] <= int(line) <= sp[1]), None)
            if span is None:
                missed.append(site)
            else:
                fired.add((path, span))
        log("sync_audit " + json.dumps({
            "kernel": name, "fuzz": sched, "groups": AUDIT_GROUPS,
            "steps": AUDIT_STEPS, "syncs_a_step": rate,
            "sites": {k: v / AUDIT_STEPS for k, v in sorted(sites.items())},
            "launches": ran, "wall_s": t_run, "nvidia_smi": smi}))
        torch.cuda.empty_cache()
    static_only = sorted(f"{path}:{a}" for path, spans in flagged.items()
                         for a, b in spans if (path, (a, b)) not in fired)
    seconds = time.perf_counter() - t0
    log("sync_audit_summary " + json.dumps({
        "runs": len(AUDIT_RUNS), "lint_s": lint_s, "seconds": seconds,
        "launches": launches,
        "runtime_sites_missed_by_lint": sorted(set(missed)),
        "static_only": static_only, "nvidia_smi": smi}))
    if missed:
        fail(f"sync audit: runtime sync sites the lint does not report "
             f"under PXK104/PXK107: {sorted(set(missed))}")
    if seconds > AUDIT_SECONDS:
        fail(f"sync audit took {seconds:.1f} s, over {AUDIT_SECONDS} s")
    return per_step, launches


# ---- phase 13: the host twins ------------------------------------------------

def twin_campaign_phase(smi: str):
    """``hunt run`` over the seeded twins on the card, host replay on:
    every witness classified (none unclassified), each control with a
    ``reproduced`` witness, each run's violations and
    progress equal to the CPU's, each witness's host outcome read twice
    more from its file.  Returns the campaign's launch counts."""
    import shutil
    from paxi_tpu_torch import cli
    from paxi_tpu_torch.hunt import Corpus

    shutil.rmtree(TWIN_HUNT_DIR, ignore_errors=True)
    argv = ["hunt", "run", "--dir", TWIN_HUNT_DIR, "--traces-dir",
            TWIN_HUNT_DIR + "/no_seeds"] + TWIN_HUNT_ARGV
    reset_launch_counts()
    t0 = time.perf_counter()
    rc, out = captured(cli.main, argv)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    with open(TWIN_HUNT_DIR + "/state.json") as f:
        state = json.load(f)
    with open(TWIN_HUNT_DIR + "/HUNT_REPORT.json") as f:
        totals = json.load(f)["summary"]["totals"]
    log("twin_campaign " + json.dumps({
        "argv": argv, "rc": rc, "totals": totals, "runs": state["runs"],
        "wall_s": wall_s, "kernels": launches, "device": smi}))
    if rc != 0 or totals["unclassified"] != 0:
        fail(f"hunt run (twins): rc {rc}, totals {totals}\n{out[-2000:]}")
    if not (launches["wheel_deliver"] > 0 and launches["wheel_insert"] > 0):
        fail(f"hunt run (twins) launched no exchange kernel: {launches}")
    t0 = time.perf_counter()
    campaign_runs_on_cpu(state, TWIN_HUNT_PROTOCOLS)
    cpu_s = time.perf_counter() - t0
    verdicts = witness_host_lines(state, Corpus(TWIN_HUNT_DIR + "/corpus"),
                                  "twin_witness_host")
    for protocol in TWIN_HUNT_PROTOCOLS:
        got = [verdicts[h] for h, w in state["witnesses"].items()
               if w["protocol"] == protocol]
        if "reproduced" not in got:
            fail(f"hunt run (twins): the {protocol} control's witnesses "
                 f"classify {got}, none reproduced")
    log("twin_campaign_cpu " + json.dumps({
        "runs": len(state["runs"]), "equal": True, "cpu_s": cpu_s}))
    return launches


def twin_witness_phase():
    """Phase 5's wpaxos_thinq1 and phase 8's wankeeper_nofloor witnesses
    (100k captures, saved) classified with host replay on, each twice
    with equal verdicts; a verdict that carries a host outcome is replayed
    twice more, equal to it and to each other (spans included)."""
    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.hunt import classify_witness

    for path in (THINQ1_WITNESS, NOFLOOR_WITNESS):
        trace = T.load(path)
        t0 = time.perf_counter()
        a, b = classify_witness(trace), classify_witness(trace)
        classify_s = (time.perf_counter() - t0) / 2
        if a.to_json() != b.to_json():
            fail(f"{trace.protocol} witness: two verdicts differ: "
                 f"{a.to_json()} / {b.to_json()}")
        line = {"protocol": trace.protocol,
                "schedule_hash": trace.meta["schedule_hash"],
                "n_groups": trace.meta["n_groups"],
                "group": trace.meta["group"],
                "group_violations": trace.meta["group_violations"],
                "outcome": a.outcome, "reason": a.reason, "host": a.host,
                "coverage": a.coverage, "classify_wall_s": classify_s,
                "host_replay_wall_s": None}
        if a.host is not None:
            (x, sx), (y, sy) = host_replay(trace), host_replay(trace)
            if x.to_json() != y.to_json() or x.spans != y.spans \
                    or x.to_json() != a.host:
                fail(f"{trace.protocol} witness: host replays differ: "
                     f"{x.to_json()} / {y.to_json()} / {a.host}")
            line.update(host_replay_wall_s=[sx, sy], replays_equal=True)
        log("twin_witness " + json.dumps(line))


def twin_scenario_phase():
    """``scenario run -host`` for each twin of ``SCENARIO_TWIN_LINES`` in
    one interpreter: each (exit code, line) the JAX package's."""
    lines = list(SCENARIO_TWIN_LINES.items())
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", SCENARIO_LINES_CODE,
         json.dumps([argv for _, (argv, _) in lines])],
        capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).resolve().parent))
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"scenario run -host (twins): {proc.stderr[-2000:]}")
    outs = [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]
    for (name, (argv, want)), got in zip(lines, outs):
        got = (got["rc"], got["line"])
        log("twin_scenario_host " + json.dumps({
            "argv": argv, "rc": got[0], "line": got[1],
            "equal_to_reference": got == want}))
        if got != want:
            fail(f"scenario run -host {name}: {got} != {want}")
    if len(outs) != len(lines):
        fail(f"scenario run -host (twins): {len(outs)} lines of "
             f"{len(lines)}")
    log("twin_scenario_host_wall_s " + json.dumps({"wall_s": wall_s}))


def host_twins_phase(smi: str):
    """Phase 13: the micro-campaign, the two 100k witnesses, the scenario
    lines.  Returns the campaign's launch counts."""
    t0 = time.perf_counter()
    launches = twin_campaign_phase(smi)
    twin_witness_phase()
    twin_scenario_phase()
    seconds = time.perf_counter() - t0
    log("host_twins_phase " + json.dumps({"seconds": seconds}))
    if seconds > TWIN_SECONDS:
        fail(f"the host twins took {seconds:.1f} s, over {TWIN_SECONDS} s")
    return launches


# ---- phase 14: serving ----------------------------------------------------

def ephemeral_low() -> int:
    """The lowest port the kernel hands out to outgoing connections: a
    listening port in that range can be taken by a client's socket
    between two clusters that reuse it (the card's machine reads 16000)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


_NEXT_BASE = [10000]


def free_base(n: int) -> int:
    """A base port whose ``n`` peer ports and ``n`` HTTP ports (1000
    above, ``local_config``'s layout) are free (``free_block``)."""
    return free_block([d + k for d in (0, 1000) for k in range(n)])


def free_block(offsets) -> int:
    """A base port whose ports ``base + o`` are free and below the
    ephemeral range, never one handed out before in this run (a process
    started a moment ago may not have bound its ports yet)."""
    import socket
    near = max(o for o in offsets if o < 1000)
    top = max(ephemeral_low() - 1 - max(offsets), _NEXT_BASE[0] + 1)
    for base in range(_NEXT_BASE[0], top, 97):
        ok = True
        for port in [base + o for o in offsets]:
            with socket.socket() as sk:
                try:
                    sk.bind(("127.0.0.1", port))
                except OSError:
                    ok = False
            if not ok:
                break
        if ok:
            _NEXT_BASE[0] = base + 97 * (1 + near // 97)
            return base
    fail("serving: no free port block below the ephemeral range")
    return 0


def cpu_model() -> str:
    """The host CPU: its model name where ``/proc/cpuinfo`` or ``lscpu``
    gives one (x86), else its implementer and part numbers (Arm), with
    the machine type and the count of logical CPUs."""
    import platform
    info = {}
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip().lower(), value.strip())
    name = info.get("model name") or info.get("cpu model") or ""
    if not name:
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip()
                         for ln in out.splitlines()
                         if ln.startswith("Model name:")), "")
    if not name and "cpu part" in info:
        name = (f"implementer {info.get('cpu implementer', '?')} part "
                f"{info['cpu part']}")
    return f"{name or 'unknown'} ({platform.machine()}), " \
        f"{os.cpu_count()} CPUs"


def serving_row(label: str, row: dict, host: dict) -> None:
    """One line a serving row: ops/s, p50/p99, errors, anomalies, and
    where the figure was taken (host figures of the card's machine)."""
    log("serving_row " + json.dumps({
        "row": label, "ops_s": row.get("ops_s"),
        "p50_ms": row.get("p50_ms"), "p99_ms": row.get("p99_ms"),
        "ops": row.get("ops"), "errors": row.get("errors"),
        "anomalies": row.get("anomalies"), **{k: v for k, v in row.items()
                                             if k not in ("ops_s", "p50_ms",
                                                          "p99_ms", "ops",
                                                          "errors",
                                                          "anomalies")},
        **host}))


def summary_row(summary: dict) -> dict:
    """A Stats.summary() (client, bench-host) as a serving row."""
    return {"ops_s": summary["throughput_ops_s"],
            "p50_ms": summary["latency_p50_ms"],
            "p99_ms": summary["latency_p99_ms"], "ops": summary["ops"],
            "errors": summary["errors"],
            "anomalies": summary.get("anomalies")}


def run_cli(argv) -> tuple:
    """``python -m paxi_tpu_torch ARGV`` as ``cli.main`` runs it in this
    process: (exit code, stdout)."""
    from paxi_tpu_torch import cli
    return captured(cli.main, argv)


def serve_and_client_phase(host: dict) -> str:
    """``server -simulation`` (paxos x 3, head sampling on) as a process,
    ``client -N`` against it as a process, ``metrics -url``, and ``spans
    render|export`` over every node's ``GET /spans``.  Returns the
    client's history file."""
    import asyncio
    import urllib.request

    from paxi_tpu_torch.core.config import Bconfig, local_config
    from paxi_tpu_torch.host.transport import wait_listening

    cfg = local_config(3, base_port=free_base(3))
    # 4 keys: ~50 ops a key, over the native checker's 32
    cfg.benchmark = Bconfig(T=0, N=SERVE_OPS, K=4, concurrency=4,
                            linearizability_check=True)
    cfg_path = SERVING_DIR + "/cluster.json"
    history = SERVING_DIR + "/client_history.json"
    cfg.to_json(cfg_path)
    root = str(Path(__file__).resolve().parent)
    server = subprocess.Popen(
        [sys.executable, "-m", "paxi_tpu_torch", "server", "-simulation",
         "-algorithm", "paxos", "-config", cfg_path], cwd=root,
        env={**os.environ, "PAXI_TRACE_SAMPLE": str(SERVE_TRACE_SAMPLE)},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        urls = [cfg.http_addrs[i] for i in cfg.ids]
        t0 = time.perf_counter()
        if not asyncio.run(wait_listening(urls[0], timeout_s=60)):
            fail("server -simulation never served its HTTP address: "
                 + (server.stderr.read().decode()[-2000:]
                    if server.poll() is not None else "still running"))
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paxi_tpu_torch", "client", "-config",
             cfg_path, "-N", str(SERVE_OPS), "-history_file", history],
            capture_output=True, text=True, timeout=180, cwd=root)
        client_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"client: rc {proc.returncode}\n{proc.stdout[-1000:]}\n"
                 f"{proc.stderr[-2000:]}")
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        if summary["ops"] != SERVE_OPS or summary["errors"] != 0 \
                or summary.get("anomalies") != 0:
            fail(f"client: {summary}")
        serving_row("client_paxos_r3", {
            **summary_row(summary), "server_up_s": up_s,
            "client_process_s": client_s}, host)
        rc, text = run_cli(["metrics", "-url", urls[0]])
        if rc != 0 or "paxi_client_requests_total" not in text:
            fail(f"metrics -url: rc {rc}\n{text[-2000:]}")
        with urllib.request.urlopen(urls[0] + "/metrics", timeout=10) as r:
            prom = r.read().decode()
        log("serving_metrics " + json.dumps({
            "url": urls[0], "lines": text.count("\n"),
            "prometheus_lines": prom.count("\n"),
            "client_requests": [ln for ln in text.splitlines()
                                if "paxi_client_requests_total" in ln]}))
        scrapes = []
        for url in urls:
            with urllib.request.urlopen(url + "/spans", timeout=10) as r:
                scrapes.append(json.load(r))
    finally:
        server.terminate()
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(timeout=10)
    spans_file = SERVING_DIR + "/spans.json"
    with open(spans_file, "w") as f:
        json.dump({"nodes": scrapes}, f)
    rc, text = run_cli(["spans", "render", "-file", spans_file])
    tail = text.strip().splitlines()[-1] if text.strip() else ""
    if rc != 0 or not tail.endswith(" 0 orphans") or tail.startswith("0 "):
        fail(f"spans render: rc {rc}, {tail!r}")
    rc, _ = run_cli(["spans", "export", "-file", spans_file, "-out",
                     SERVING_DIR + "/spans_chrome.json"])
    if rc != 0:
        fail(f"spans export: rc {rc}")
    log("serving_spans " + json.dumps({
        "sample_rate": SERVE_TRACE_SAMPLE, "render": tail,
        "spans_by_node": {d["node"]: len(d["spans"]) for d in scrapes}}))
    return history


def bench_host_cli_phase(host: dict) -> None:
    """``bench-host`` closed loop in this process with head sampling on:
    0 anomalies, 0 errors, the five-phase span decomposition present."""
    out = SERVING_DIR + "/bench_host_closed.json"
    argv = BENCH_HOST_CLOSED_ARGV + ["-base_port", str(free_base(3)),
                                     "-out", out]
    t0 = time.perf_counter()
    rc, text = run_cli(argv)
    wall_s = time.perf_counter() - t0
    line = json.loads(text.strip().splitlines()[-1])
    if rc != 0 or line.get("anomalies") != 0 or line["errors"] != 0 \
            or not line.get("span_phases"):
        fail(f"bench-host: rc {rc}, {line}")
    serving_row("bench_host_closed_paxos_r3", {
        **summary_row(line), "argv": argv, "wall_s": wall_s,
        "span_phases": line["span_phases"]}, host)


def start_module(module: str, args, env=None) -> subprocess.Popen:
    """``python -m MODULE ARGS`` from the checkout's root, its output
    piped; the caller ends it through ``finish_module``."""
    return subprocess.Popen(
        [sys.executable, "-m", module] + list(args),
        cwd=str(Path(__file__).resolve().parent),
        env={**os.environ, **(env or {})}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_module(proc: subprocess.Popen, timeout: float) -> tuple:
    """(exit code, stdout, stderr) of a ``start_module`` process, killed
    if it outlives ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    return proc.returncode, out, err


def bench_host_names():
    from paxi_tpu_torch import bench_host
    return [c[0] for c in bench_host.CONFIGS if c[0] not in BENCH_HOST_SKIP]


def start_bench_host_twin() -> subprocess.Popen:
    return start_module(
        "paxi_tpu_torch.bench_host",
        ["--protocols", ",".join(bench_host_names()), "--base-port",
         str(free_base(6)), "--out", SERVING_DIR + "/BENCH_HOST.json"],
        env={"BENCH_HOST_T": "1"})


def bench_host_twin_phase(proc: subprocess.Popen, host: dict) -> None:
    """``python -m paxi_tpu_torch.bench_host`` at BENCH_HOST_T=1 over its
    CONFIGS but BENCH_HOST_SKIP: every linearizable row 0 anomalies and 0
    errors, dynamo and blockchain labelled eventual."""
    from paxi_tpu_torch import bench_host
    names = bench_host_names()
    rc, stdout, stderr = finish_module(proc, 300)
    rows = [json.loads(x) for x in stdout.splitlines()
            if x.startswith("{")]
    lin = {c[0]: c[3] for c in bench_host.CONFIGS}
    bad = [r for r in rows if "error" in r or r["consistency"] != (
        "linearizable" if lin[r["protocol"]] else "eventual")
        or r["errors"] != 0 or (r["anomalies"] or 0) != 0]
    if rc != 0 or bad or [r["protocol"] for r in rows] != names:
        fail(f"bench_host: rc {rc}, rows "
             f"{[r.get('protocol') for r in rows]}, at fault "
             f"{[{k: v for k, v in r.items() if k != 'metrics'} for r in bad]}"
             f"\n{stderr[-2000:]}")
    for r in rows:
        serving_row(f"bench_host_{r['protocol']}", {
            "ops_s": r["value"], "p50_ms": r["latency"]["latency_p50_ms"],
            "p99_ms": r["latency"]["latency_p99_ms"], "ops": r["ops"],
            "errors": r["errors"], "anomalies": r["anomalies"],
            "consistency": r["consistency"], "replicas": r["replicas"],
            "zones": r["zones"], "row_wall_s": r["wall_s"]}, host)
    for name in BENCH_HOST_SKIP:
        log("serving_row_skipped " + json.dumps({
            "row": f"bench_host_{name}", "reason": "the reference's own "
            "steal livelock at op 224 (ROADMAP Queue 3)"}))
    log("serving_bench_host " + json.dumps({"rows": len(rows)}))


def native_check_phase(history_path: str) -> None:
    """The native checker was built and is used: on the key of the
    client's own history with the most ops, its count equals the
    pure-Python loop's."""
    from paxi_tpu_torch.host import history, native
    if not native.native_available():
        fail(f"the native checker did not build: {native.build_error}")
    with open(history_path) as f:
        dump = json.load(f)
    key, ops = max(dump.items(), key=lambda kv: len(kv[1]))
    ops = [history.Operation(
        o["input"].encode("latin1") if o["input"] is not None else None,
        o["output"].encode("latin1") if o["output"] is not None else None,
        o["start"], math.inf if o["end"] is None else o["end"])
        for o in ops]
    if len(ops) < 32:
        fail(f"client history: key {key} has {len(ops)} ops, under the "
             "native checker's 32")
    calls = native.calls
    t0 = time.perf_counter()
    got = history.check_key(ops)
    native_s = time.perf_counter() - t0
    if native.calls != calls + 1:
        fail("history.check_key did not go through the native checker")
    t0 = time.perf_counter()
    plain, left = 0, sorted(ops, key=lambda o: (o.start, o.end))
    while (bad := history._find_cycle_read(left)) is not None:
        plain += 1
        left = [o for o in left if o is not bad]
    plain_s = time.perf_counter() - t0
    log("serving_native_lincheck " + json.dumps({
        "library": native.library_path().name, "key": key, "ops": len(ops),
        "anomalies": got, "python_anomalies": plain, "native_s": native_s,
        "python_s": plain_s}))
    if got != plain or got != 0:
        fail(f"native checker {got} != python {plain} (or not 0)")


def serving_phase(smi: str):
    """Phase 14: the serving stack on the card's machine (asyncio on the
    CPU; no kernel runs, the launch counts read 0).  The soak and the
    bench_host sweep run in their own processes beside the server, the
    client and bench-host; the soak goes on beside phase 15 and is read
    after it (``soak_phase``).  Returns the launch counts and the soak's
    process."""
    import shutil
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    host = {"device": smi, "cpu": cpu_model(), "figures": "host"}
    reset_launch_counts()
    t0 = time.perf_counter()
    soak = start_module(
        "paxi_tpu_torch.soak_host",
        ["--protocols", SOAK_PROTOCOL, "--base-port", str(free_base(3)),
         "--out", SOAK_OUT], env={"SOAK_HOST_T": str(SOAK_SECONDS)})
    twin = start_bench_host_twin()
    try:
        history_path = serve_and_client_phase(host)
        bench_host_cli_phase(host)
        native_check_phase(history_path)
        bench_host_twin_phase(twin, host)
    except BaseException:
        end_processes(soak)
        raise
    finally:
        end_processes(twin)
    launches = launch_counts()
    seconds = time.perf_counter() - t0
    log("serving_phase " + json.dumps({"seconds": seconds,
                                       "kernels": launches}))
    if any(launches.values()):
        end_processes(soak)
        fail(f"the serving phase launched kernels: {launches}")
    if seconds > SERVING_SECONDS:
        end_processes(soak)
        fail(f"serving took {seconds:.1f} s, over {SERVING_SECONDS} s")
    return launches, soak


def end_processes(*procs) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def soak_phase(soak: subprocess.Popen, smi: str) -> None:
    """The paxos soak started in phase 14, read after phase 15: exit 0,
    0 anomalies, ops done.  Its fault windows hold an op they catch for
    the server's 10 s request timeout, so a run takes 13 or 33 s (both
    packages; 1 run in 5 the longer, with 4 errors) and is read where it
    has had that time."""
    host = {"device": smi, "cpu": cpu_model(), "figures": "host"}
    t0 = time.perf_counter()
    try:
        rc, soak_stdout, soak_stderr = finish_module(soak, SOAK_WAIT_S)
    finally:
        end_processes(soak)
    if rc != 0:
        fail(f"soak_host {SOAK_PROTOCOL}: rc {rc}\n"
             f"{soak_stdout[-1000:]}\n{soak_stderr[-2000:]}")
    with open(SOAK_OUT) as f:
        (row,) = json.load(f)
    if row["anomalies"] != 0 or row["ops"] <= 0:
        fail(f"soak_host {SOAK_PROTOCOL}: {row}")
    serving_row(f"soak_host_{SOAK_PROTOCOL}", {
        "ops_s": round(row["ops"] / row["duration_s"], 1),
        "p50_ms": row["latency"]["latency_p50_ms"],
        "p99_ms": row["latency"]["latency_p99_ms"], "ops": row["ops"],
        "errors": row["errors"], "anomalies": row["anomalies"],
        "duration_s": row["duration_s"], "soak_host_t": SOAK_SECONDS,
        "waited_after_phase_15_s": time.perf_counter() - t0,
        "fault_schedule": row["fault_schedule"]}, host)


# ---- phase 15: the sharded tier ------------------------------------------

def shard_ramp_check(r: dict) -> None:
    """The shard smoke's assertions (``scripts/verify.sh --shard``) on
    the ramp's artifact."""
    required = ("mode", "algorithm", "shards", "fleet",
                "replicas_per_group", "workers", "phases",
                "aggregate_peak_ops_s", "anomalies", "txn", "router")
    missing = [k for k in required if k not in r]
    if missing:
        fail(f"shard ramp: artifact missing keys {missing}")
    names = [p["phase"] for p in r["phases"]]
    mig = next((p for p in r["phases"] if p["phase"] == "migrate"), {})
    m = mig.get("migration", {})
    t = r["txn"] or {}
    checks = [
        (r["mode"] == "shard-ramp" and r["shards"] == 2, "mode/shards"),
        (r.get("routers") == SHARD_ROUTERS, "routers"),
        (names == SHARD_PHASES, f"phases {names}"),
        (all(sum(s["completed"] for s in p["steps"]) > 0
             for p in r["phases"]), "a phase completed nothing"),
        ((r["anomalies"] or 0) == 0, f"anomalies {r['anomalies']}"),
        (t.get("txns", 0) > 0 and t.get("committed", 0) > 0,
         f"2PC {t}"),
        (t.get("atomicity_violations") == 0, f"2PC atomicity {t}"),
        (r["router"]["forwards"] > 0, f"router {r['router']}"),
        (m.get("epoch") == "complete", f"migration epoch {m.get('epoch')}"),
        ((m.get("installed") or 0) > 0, "migration installed no key"),
        (m.get("oracle", {}).get("seeded_keys", 0) > 0
         and m["oracle"]["clean"], f"migration oracle {m.get('oracle')}"),
        (mig.get("steps", [{}])[0].get("completed", 0) > 0,
         "migrate phase completed nothing"),
        ((mig.get("anomalies") or 0) == 0,
         f"migrate anomalies {mig.get('anomalies')}"),
        ("migration_blip_p99_ms" in m and "blip_ratio" in m
         and m.get("steady_p99_ms") is not None, "blip/steady p99"),
    ]
    bad = [msg for ok, msg in checks if not ok]
    if bad:
        fail(f"shard ramp: {bad}")


def shard_spans_phase() -> dict:
    """One traced cross-shard 2PC on a virtual-clock fabric (the shard
    smoke's ``--spans`` case): the coordinator's record spans and every
    group's participant spans stitch into one tree over both groups, with
    no orphan."""
    import asyncio

    from paxi_tpu_torch.core.command import Command, Request, pack_tpc
    from paxi_tpu_torch.host.fabric import VirtualClockFabric
    from paxi_tpu_torch.obs import (TRACE_PROP, SpanCollector, TraceCtx,
                                    groups_of, label_group, merge, orphans,
                                    stitched_traces)
    from paxi_tpu_torch.shard import ShardCoordinator, ShardedCluster

    async def twopc():
        fab = VirtualClockFabric()
        sc = ShardedCluster("paxos", groups=2, n=3, http=False, fabric=fab,
                            tag="smoke2pc")
        await sc.start()
        try:
            async def submit(group, key, rec):
                # the router's /tpc hop on the fabric: a participant span
                # on the entry node, its child context in the request
                node = sc.leader_node(group)
                sp = node.spans.start("tpc", TraceCtx.decode(
                    rec.get("trace")), record=rec["kind"], txid=rec["txid"])
                props = {TRACE_PROP: sp.child().encode()} if sp else {}
                fut = asyncio.get_running_loop().create_future()

                def cb(rep):
                    node.spans.finish(sp)
                    if not fut.done():
                        fut.set_result((not rep.err, rep.value
                                        or (rep.err or "").encode()))
                node.handle_client_request(Request(
                    command=Command(int(key), pack_tpc(
                        rec["kind"], rec["txid"], ops=rec.get("ops"),
                        outcome=rec.get("outcome", ""))),
                    properties=props, reply_to=cb))
                return await fut

            col = SpanCollector(node="client", fabric=fab)
            cspans = SpanCollector(node="coord", fabric=fab)
            coord = ShardCoordinator(submit, lease_s=0.0, spans=cspans)
            gsize = sc.map.span // 2
            parts = {g: [(g * gsize + 7, f"t{g}".encode())]
                     for g in range(2)}
            root = col.start("txn", TraceCtx("t2pc"))
            task = asyncio.ensure_future(coord.run_txn(
                parts, txid="tx-smoke", trace=root.child()))
            for _ in range(600):
                if task.done():
                    break
                await fab.run(1)
            if not task.done():
                fail("traced 2PC: fabric steps exhausted")
            out = task.result()
            col.finish(root)
            lists = [cspans.export(), col.export()]
            for g in range(2):
                lists.append(label_group(
                    [d for r in sc.group(g).replicas.values()
                     for d in r.spans.export()], g))
            applied = [r.db.get(k) for g, ops in parts.items()
                       for r in sc.group(g).replicas.values()
                       for k, _ in ops]
            return out, merge(lists), fab.step, applied
        finally:
            await sc.stop()

    out, spans, steps, applied = asyncio.run(twopc())
    lost = orphans(spans)
    groups = sorted(groups_of(spans, "t2pc"))
    row = {"committed": out.committed, "txid": out.txid,
           "fabric_steps": steps, "spans": len(spans),
           "trace_spans": sum(d["trace"] == "t2pc" for d in spans),
           "kinds": sorted({d["kind"] for d in spans
                            if d["trace"] == "t2pc"}),
           "groups": groups, "orphans": len(lost),
           "stitched": "t2pc" in stitched_traces(spans)}
    log("shard_spans " + json.dumps(row))
    if not out.committed or lost or not row["stitched"] \
            or len(groups) < 2 or None in applied:
        fail(f"traced 2PC: {row}, orphans {lost[:3]}, applied {applied}")
    return row


def lincheck_planes():
    """Seeded random op planes of LINCHECK_GROUPS histories and the
    planted groups' known counts."""
    gen = torch.Generator().manual_seed(SEED)
    shape = (LINCHECK_GROUPS, LINCHECK_OPS)
    valid = torch.rand(shape, generator=gen) < 0.9
    key = torch.randint(0, 4, shape, generator=gen, dtype=torch.int32)
    is_read = torch.rand(shape, generator=gen) < 0.5
    val = torch.randint(0, 6, shape, generator=gen, dtype=torch.int32)
    start = torch.randint(0, 64, shape, generator=gen, dtype=torch.int32)
    end = start + torch.randint(0, 8, shape, generator=gen,
                                dtype=torch.int32)
    planted, names = {}, sorted(LINCHECK_PLANTED)
    for i, g in enumerate(range(1, LINCHECK_GROUPS, LINCHECK_STRIDE)):
        rows, want = LINCHECK_PLANTED[names[i % len(names)]]
        valid[g] = False
        for j, (k, rd, v, s, e) in enumerate(rows):
            valid[g, j], key[g, j], is_read[g, j] = True, k, rd
            val[g, j], start[g, j], end[g, j] = v, s, e
        planted[g] = want
    return (valid, key, is_read, val, start, end), planted


def lincheck_phase(smi: str) -> dict:
    """``stale_read_anomalies`` on the card at LINCHECK_GROUPS x
    LINCHECK_OPS against the same function on the CPU: equal counts,
    every planted group's known count found."""
    from paxi_tpu_torch.sim.lincheck import stale_read_anomalies
    planes, planted = lincheck_planes()
    t0 = time.perf_counter()
    want = stale_read_anomalies(*planes, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dev = [p.to(DEVICE) for p in planes]
    ms = median_ms(lambda: stale_read_anomalies(*dev, device=DEVICE))
    got = stale_read_anomalies(*dev, device=DEVICE)
    idx = torch.tensor(sorted(planted))
    row = {"groups": LINCHECK_GROUPS, "ops": LINCHECK_OPS,
           "device": got.device.type, "dtype": str(got.dtype),
           "ms": ms, "cpu_ms": cpu_ms,
           "max_abs_err": int((got.cpu() - want).abs().max()),
           "anomalies": int(want.sum()),
           "groups_with_anomalies": int((want > 0).sum()),
           "planted": len(planted),
           "planted_found": int((got.cpu()[idx] == torch.tensor(
               [planted[g] for g in sorted(planted)],
               dtype=torch.int32)).sum()),
           "nvidia_smi": smi}
    log("sim_lincheck " + json.dumps(row))
    if got.device.type != torch.device(DEVICE).type \
            or got.dtype != torch.int32 \
            or not torch.equal(got.cpu(), want) \
            or row["planted_found"] != len(planted):
        fail(f"sim_lincheck: {row}")
    return row


def shard_row(r: dict, wall_s: float, host: dict) -> None:
    """One line for the ramp: the aggregate peak, each phase's achieved
    ops/s and p50/p99 by step, the 2PC counts, the migration, the router's
    per-group command counts (host figures of the card's machine)."""
    m = next(p for p in r["phases"] if p["phase"] == "migrate")["migration"]
    log("shard_row " + json.dumps({
        "argv": SHARD_ARGV, "aggregate_peak_ops_s": r["aggregate_peak_ops_s"],
        "phases": {p["phase"]: [
            {"offered_ops_s": s["offered_ops_s"],
             "achieved_ops_s": s["achieved_ops_s"],
             "p50_ms": s["latency_p50_ms"], "p99_ms": s["latency_p99_ms"],
             "completed": s["completed"], "errors": s["errors"]}
            for s in p["steps"]] for p in r["phases"]},
        "anomalies": r["anomalies"], "txn": r["txn"],
        "migration": {k: m[k] for k in (
            "plan", "rebalancer_fallback", "installed", "chunks",
            "window_s", "steady_p99_ms", "migration_blip_p99_ms",
            "blip_ratio", "dualwrites", "map_version")},
        "migration_oracle_clean": m["oracle"]["clean"],
        "router_group_commands": r["router"]["group_commands"],
        "router_forwards": r["router"]["forwards"],
        "router_stale_reroutes": r["router"]["stale_reroutes"],
        "routers": r.get("routers", 1), "wall_s": wall_s, **host}))


def shard_phase(smi: str):
    """Phase 15: the sharded tier on the card's machine.  ``bench-host
    --shards 2`` runs as a process while this one traces a cross-shard
    2PC on the fabric and holds the stale-read checker on the card to
    the CPU; no kernel runs (the launch counts read 0).  Returns the
    launch counts."""
    import shutil
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)
    host = {"device": smi, "cpu": cpu_model(), "figures": "host"}
    reset_launch_counts()
    t0 = time.perf_counter()
    out = SHARD_DIR + "/shard_ramp.json"
    ramp = start_module("paxi_tpu_torch", SHARD_ARGV + [
        "-base_port", str(free_block(SHARD_PORTS)), "-out", out])
    try:
        shard_spans_phase()
        lincheck_phase(smi)
        rc, stdout, stderr = finish_module(ramp, 120)
    finally:
        if ramp.poll() is None:
            ramp.kill()
            ramp.wait(timeout=10)
    wall_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"bench-host --shards: rc {rc}\n{stdout[-2000:]}\n"
             f"{stderr[-2000:]}")
    with open(out) as f:
        r = json.load(f)
    shard_ramp_check(r)
    shard_row(r, wall_s, host)
    launches = launch_counts()
    seconds = time.perf_counter() - t0
    log("shard_phase " + json.dumps({"seconds": seconds,
                                     "kernels": launches}))
    if any(launches.values()):
        fail(f"the sharded tier launched kernels: {launches}")
    if seconds > SHARD_SECONDS:
        fail(f"the sharded tier took {seconds:.1f} s, over "
             f"{SHARD_SECONDS} s")
    return launches


# ---- phase 6: four ranks on the one card ---------------------------------

def sharded_case(mesh, name: str, cfg_kw, fuzz_kw, n_groups: int,
                 n_steps: int, workload=None):
    """One sharded run, gathered on every rank; rank 0 returns
    ``(state, metrics, violations)`` as numpy, the others None."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.parallel import gather_state, make_sharded_run
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig

    run = make_sharded_run(sim_protocol(name), wl_config(cfg_kw, workload),
                           FuzzConfig(**fuzz_kw), mesh)
    state, metrics, viol = run(tr.PRNGKey(SEED), n_groups, n_steps)
    whole = gather_state(state, mesh, n_groups)
    if mesh.rank:
        return None
    return ({k: v.cpu().numpy() for k, v in whole.items()},
            {k: int(v) for k, v in metrics.items()}, int(viol))


def sharded_checks():
    """phase 6's card-against-CPU cases: (label, protocol, config, fuzz,
    workload); the last is phase 7's zipf99 paxos, whose ranks offset
    their group ids."""
    return [(f"{name}_{label}", name, cfg, fz, None)
            for name, cfg in SHARDED_CHECKS.items()
            for label, fz in (("fault_free", {}), ("fuzz", FUZZ_ARGS))] \
        + [("paxos_zipf99", "paxos", WL_CFGS["paxos"], {}, "zipf99")]


def sharded_small_rank(mesh):
    """The card-against-CPU cases on one rank (run on either device)."""
    return {label: sharded_case(mesh, name, cfg, fz,
                                WL_SHARD_GROUPS if wl else SMALL_GROUPS,
                                SMALL_STEPS, wl)
            for label, name, cfg, fz, wl in sharded_checks()}


def sharded_pg_rank(mesh, sched):
    """Phase 7's per-group cases on one rank sharing the card: a padded
    paxos_pg run and the sharded pinned replay of ``sched``; rank 0
    returns them gathered as numpy."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.parallel import gather_state, make_sharded_pinned_run
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig

    out = {"run": sharded_case(mesh, "paxos_pg", WL_CFGS["paxos"],
                               FUZZ_ARGS, PG_SHARD_GROUPS, SMALL_STEPS,
                               "zipf99")}
    run = make_sharded_pinned_run(
        sim_protocol("paxos_pg"), wl_config(WL_CFGS["paxos"], "zipf99"),
        FuzzConfig(**FUZZ_ARGS), PG_PIN["group"], mesh)
    state, metrics, total, viols = run(tr.PRNGKey(SEED), PG_SHARD_GROUPS,
                                       sched)
    whole = gather_state(state, mesh, PG_SHARD_GROUPS)
    if mesh.rank:
        return None
    out["pinned"] = ({k: v.cpu().numpy() for k, v in whole.items()},
                     {k: int(v) for k, v in metrics.items()}, int(total),
                     viols.cpu().numpy())
    return out


def card_rank(mesh, pg_sched):
    """Everything phase 6 does on one rank sharing the card, and phase 7's
    sharded per-group cases (``pg_sched``: the traced group's schedule)."""
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
    out["pg"] = sharded_pg_rank(mesh, pg_sched)
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


def four_ranks_phase(smi: str, pg_sched):
    """Phase 6: four ranks on the one card, then the same sharded runs on
    four CPU ranks for the comparison.  Returns the four-rank shift row,
    the sharded north star's row, rank 0's phase 7 per-group results and
    the sharded card runs."""
    from paxi_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    ranks = spawn(SHARD_WORLD, card_rank, pg_sched, backend="gloo",
                  device=DEVICE, timeout=900)
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
    for label, name, cfg, fz, wl in sharded_checks():
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
            "workload": wl,
            "groups": WL_SHARD_GROUPS if wl else SMALL_GROUPS,
            "steps": SMALL_STEPS, "equal": True,
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
    want = steps * EXCHANGE_LAUNCHES_A_STEP
    for n in ns:
        if n["launches"]["wheel_deliver"] != want \
                or n["launches"]["wheel_insert"] != want:
            fail(f"sharded north star: a rank's exchange launches "
                 f"{n['launches']} != {want}")
    return shift_row, row, ranks[0]["pg"], card_small


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    from paxi_tpu_torch.ops import _build
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FAULT_FREE, FuzzConfig, SimConfig, simulate

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
    # and at phase 7's two mailbox shapes, wheel depth 1
    for p, cfg_kw in WL_CFGS.items():
        wcfg = SimConfig(**cfg_kw)
        xrows[f"{p}_workload"] = exchange_phase(
            p, sim_protocol(p).mailbox_spec(wcfg), depths=(1,),
            replicas=wcfg.n_replicas)
    # and at phase 8's three new mailbox shapes (blockchain's under
    # bench_all's FUZZ, a two-slot wheel)
    for row in ("wankeeper_zones", "bpaxos_grid", "blockchain_forks"):
        spec = PROTO_ROWS[row]
        rcfg = SimConfig(**spec["cfg"])
        xrows[spec["protocol"]] = exchange_phase(
            spec["protocol"],
            sim_protocol(spec["protocol"]).mailbox_spec(rcfg),
            depths=(schedule_of(spec.get("schedule", "fault_free")).wheel,),
            replicas=rcfg.n_replicas)
    crows = closure_phase()
    prows = closure_path_phase()
    srow = shift_world1_phase()

    # 3. the card against the CPU
    for p in PATHS:
        card_vs_cpu_phase(p, protos[p], cfgs[p], PATHS[p]["count"])
    for p, spec in NEW_PATHS.items():
        card_vs_cpu_phase(p, sim_protocol(spec.get("protocol", p)),
                          SimConfig(**spec["cfg"]), "committed_slots")

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

    # 7. workloads: the matrix, the lowering pin, the hash planes, card
    # against CPU; the sharded cases ride phase 6's spawn
    t7 = time.perf_counter()
    wl_rows, lane = {}, {}
    for p in WL_CFGS:
        simulate(sim_protocol(p), wl_config(WL_CFGS[p], "zipf99"), GROUPS,
                 WARMUP_STEPS, seed=SEED + 1, device=DEVICE)
        for wl in WL_NAMES:
            row, res = workload_cell(p, wl, smi)
            wl_rows[p, wl] = row
            if p == "paxos" and wl != "uniform":
                lane[wl], lane[wl + "_wall_s"] = res, row["wall_s"]
            del res
            torch.cuda.empty_cache()
    steals = {wl: wl_rows["wpaxos", wl]["steals"] for wl in WL_NAMES}
    if steals["zipf99"] < steals["uniform"] + 10:
        fail(f"wpaxos steals {steals}: zipf99 must steal at least 10 more "
             "than uniform")
    lowering_pin_phase(lane, smi)
    del lane
    torch.cuda.empty_cache()
    workload_planes_phase(smi)
    for p in WL_CFGS:
        step_split_phase(p, sim_protocol(p), wl_config(WL_CFGS[p], "zipf99"),
                         FAULT_FREE, "zipf99")
    workload_small_phase()
    pg_ref = pg_pin_schedule()
    t7 = time.perf_counter() - t7

    # 6. four ranks on the one card (with phase 7's sharded cases)
    t6 = time.perf_counter()
    shift4, north, pg_sharded, card_small = four_ranks_phase(smi, pg_ref[0])
    t6 = time.perf_counter() - t6
    workload_sharded_lines(pg_sharded, card_small, pg_ref, smi)

    # 8. the protocols of slice 8: bench_all's rows, the twins, card
    # against CPU
    t8 = time.perf_counter()
    proto_rows = {k: new_path_run(k, smi, PROTO_ROWS) for k in PROTO_ROWS}
    for row in ("wankeeper_zones", "wankeeper_wan3z_geo", "bpaxos_grid"):
        spec = PROTO_ROWS[row]
        step_split_phase(row, sim_protocol(spec["protocol"]),
                         SimConfig(**spec["cfg"]),
                         schedule_of(spec.get("schedule", "fault_free")),
                         spec.get("schedule", "fault_free"))
    torch.cuda.empty_cache()
    nofloor_launches, noread_launches = twin_phase(smi)
    slice8_small_phase()
    t8 = time.perf_counter() - t8

    # 9. switchpaxos: the exchange at its mailbox, bench_all's wan3z pair
    # and the seqchurn case at 100k, the nogap and seqchurn captures, card
    # against CPU, a step split
    t9 = time.perf_counter()
    sw_spec = sim_protocol("switchpaxos").mailbox_spec(
        SimConfig(**HUNT_SWITCH_CFG))
    xrows["switchpaxos"] = exchange_phase("switchpaxos", sw_spec)
    xrows["switchpaxos_wan3z"] = exchange_phase(
        "switchpaxos", sw_spec, depths=(schedule_of("wan3z").wheel,),
        replicas=SWITCH_CFG["n_replicas"])
    switch_rows = switch_pair_phase(smi)
    nogap_launches = capture_replay_phase(
        "switchpaxos_nogap", HUNT_SWITCH_CFG, TWIN_DROP_ARGS, NOGAP_STEPS,
        smi)
    # the reference's own seqchurn violation at this width: its witness
    seqchurn_launches = capture_replay_phase(
        "switchpaxos", SEQCHURN_CFG, TWIN_DROP_ARGS,
        SWITCH_ROWS["switchpaxos_seqchurn"]["steps"], smi,
        line="switch_witness",
        save_as=WITNESS_DIR + "/switchpaxos_seqchurn_100k")
    slice9_small_phase()
    for row in SWITCH_ROWS:
        spec = SWITCH_ROWS[row]
        step_split_phase(row, sim_protocol(spec["protocol"]),
                         SimConfig(**spec["cfg"]),
                         schedule_of(spec["schedule"]), spec["schedule"])
    torch.cuda.empty_cache()
    t9 = time.perf_counter() - t9

    # 10. the drivers: the CLI's main path, the hunt campaign, one
    # bench_all row and one fuzz_soak record through the twins
    t10 = time.perf_counter()
    driver_launches = {"cli_main_path": cli_phase(smi),
                       "hunt_campaign": hunt_campaign_phase(
                           seqchurn_launches[2], smi),
                       "bench_all_paxos_3rep": bench_twin_phase(smi),
                       "fuzz_soak_paxos_drop": soak_twin_phase(smi)}
    t10 = time.perf_counter() - t10

    # 11. the bench twin and its sweep, the layout A/B, the other
    # sliding-window twins at their rows' counts, every twin card against
    # CPU, the workload demo
    t11 = time.perf_counter()
    bench_line, bench_launches = north_star_bench_phase(free["paxos"], smi)
    sw_ab_launches = layout_ab_phase(bench_line, smi)
    sw_rows = {k: new_path_run(k, smi, SW_ROWS) for k in SW_ROWS}
    torch.cuda.empty_cache()
    sw_small_phase()
    workload_demo_phase()
    t11 = time.perf_counter() - t11

    # 12. the host-sync audit: every kernel's steps under the CUDA sync
    # debug mode, each runtime site held to the lint's PXK104/PXK107
    t12 = time.perf_counter()
    _, audit_launches = sync_audit_phase(smi)
    t12 = time.perf_counter() - t12

    # 13. the host twins: the seeded twins' micro-campaign on the card, the
    # 100k witnesses of phases 5 and 8 on their twins, scenario run -host
    t13 = time.perf_counter()
    driver_launches["hunt_twins_campaign"] = host_twins_phase(smi)
    t13 = time.perf_counter() - t13

    # 14. serving: server -simulation and client as processes, the
    # metrics and spans scrapes, bench-host, the bench_host and soak_host
    # twins, the native checker (host figures; no kernel runs)
    t14 = time.perf_counter()
    driver_launches["serving"], soak = serving_phase(smi)
    t14 = time.perf_counter() - t14

    # 15. the sharded tier: bench-host --shards 2 (two routers, a live
    # migration, the 2PC burst) as a process, a traced cross-shard 2PC,
    # the stale-read checker on the card against the CPU (no kernel runs)
    t15 = time.perf_counter()
    try:
        driver_launches["sharded_tier"] = shard_phase(smi)
    except BaseException:
        end_processes(soak)
        raise
    t15 = time.perf_counter() - t15
    soak_phase(soak, smi)
    log("phase_seconds " + json.dumps({
        "workloads_single_card": t7, "four_ranks_with_workloads": t6,
        "slice8_protocols": t8, "slice9_switchpaxos": t9, "drivers": t10,
        "slice11_bench_and_sw_twins": t11, "sync_audit": t12,
        "host_twins": t13, "serving": t14, "sharded_tier": t15,
        "script_so_far": time.perf_counter() - t_script}))

    # 16. the kernel summary: launches from the epaxos main path (the one
    # that runs all three earlier kernels), by path beside them; the shift
    # from its own path (phase 6's ring), since no run path calls it
    launches = free["epaxos"]["kernels"]
    by_path = {k: {**{p: free[p]["kernels"][k] for p in PATHS},
                   "sharded_north_star": north["kernels"][k],
                   "witness_capture": witness_launches[k],
                   "scenario_path": scenario["kernels"][k],
                   **{f"workload_{p}_{wl}": r["kernels"][k]
                      for (p, wl), r in wl_rows.items()},
                   **{row: r["kernels"][k] for row, r in proto_rows.items()},
                   "nofloor_capture": nofloor_launches[k],
                   "noread_run": noread_launches[k],
                   **{row: r["kernels"][k] for row, r in switch_rows.items()},
                   "nogap_capture": nogap_launches[0][k],
                   "nogap_replay": nogap_launches[1][k],
                   "seqchurn_capture": seqchurn_launches[0][k],
                   "seqchurn_replay": seqchurn_launches[1][k],
                   **{p: n[k] for p, n in driver_launches.items()},
                   "bench_twin_timed_run": bench_launches[k],
                   "layout_ab_paxos_sw": sw_ab_launches[k],
                   **{row: r["kernels"][k] for row, r in sw_rows.items()},
                   "sync_audit": audit_launches[k]}
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
            "launches_a_step": row["launches_a_step"],
            "max_abs_err": max(r["max_abs_err"] for x in xrows.values()
                               for (k, _), r in x.items() if k == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            **{f"{p}_d{d}": {k: xrows[x][(kname, d)][k]
                             for k in ("ms", "wrapper_ms", "plain_ms",
                                       "bound_ms", "share_of_bound")}
               for p, x, d in (("paxos", "paxos", 1), ("paxos", "paxos", 3),
                               ("epaxos", "epaxos", 1),
                               ("epaxos", "epaxos", 3),
                               ("wpaxos_wan3z", "wpaxos_wan3z", 6),
                               ("paxos_r3", "paxos_workload", 1),
                               ("wpaxos_grid", "wpaxos_workload", 1),
                               ("wankeeper", "wankeeper", 1),
                               ("bpaxos", "bpaxos", 1),
                               ("blockchain", "blockchain", 2),
                               ("switchpaxos", "switchpaxos", 1),
                               ("switchpaxos", "switchpaxos", 3),
                               ("switchpaxos_r3_wan3z", "switchpaxos_wan3z",
                                6))}})
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
