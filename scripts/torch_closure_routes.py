#!/usr/bin/env python3
"""Time the closure kernel's routes against each other on one card.

    python3 scripts/torch_closure_routes.py [--reps 10]

``ops.closure.closure_route`` picks, for graphs of N nodes, the warp
kernel or the block kernel and the block kernel's threads.  This script
launches each candidate route on the same seeded random graphs (p =
0.02) and prints one JSON line a shape: the route ``closure_route``
picks, then every candidate's median CUDA-event milliseconds, timed in
turns (each candidate once, then again in reverse order; both times are
printed), and whether its output equals the picked route's and, on the
first graphs, the plain version's.  The candidates: the warp kernel
against the block kernel at 130, 160, 224 and 256 nodes (where the
routing switches), and the block kernel at 64 to 256 threads at the
CLI's epaxos widths (384, 320) and at 256 and 512 nodes.  The first
line is the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from paxi_tpu_torch.ops import closure as C  # noqa: E402

# (graphs, nodes): the warp/block switch, then the thread sweep's widths
SWITCH = [(50_000, 130), (50_000, 160), (30_000, 224), (20_000, 256)]
SWEEP = [(3_072, 384), (10_240, 320), (20_000, 256), (4_000, 512)]
SWEEP_THREADS = (64, 96, 128, 160, 192, 256)
PLAIN_GRAPHS = 64                    # graphs held to the plain version


def launch(adj: torch.Tensor, r: C.Route) -> torch.Tensor:
    """``closure_launch`` with the route ``r`` in place of the one
    ``closure_route`` picks."""
    b, n = adj.shape[0], adj.shape[1]
    out = torch.empty_like(adj)
    scratch, grid = None, 0
    if r.variant == "block_global":
        grid = min(b, torch.cuda.get_device_properties(adj.device)
                   .multi_processor_count)
        scratch = torch.empty(grid * r.scratch_words, dtype=torch.int32,
                              device=adj.device)
    err = C._lib().paxi_transitive_closure(
        adj.data_ptr(), out.data_ptr(), b, n, C.VARIANTS.index(r.variant),
        int(r.vec), r.wp, r.threads, r.shmem,
        None if scratch is None else scratch.data_ptr(), grid,
        torch.cuda.current_stream(adj.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"closure launch failed ({r}): CUDA error {err}")
    return out


def median_ms(fn, reps: int) -> float:
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


def block_route(n: int, threads: int) -> C.Route:
    """The block kernel in shared memory at ``threads`` threads."""
    w = -(-n // 32)
    wp = C.smem_row_words(w)
    return C.Route("block_smem", n % 16 == 0, threads, wp,
                   (32 * w + C.BLOCK_TABLE_ROWS) * wp * 4, 0)


def warp_route(n: int) -> C.Route:
    return C.Route("warp", n % 32 == 16, 128, 0,
                   C._WARP_BAR_BYTES + C._WARP_WARPS * (C._WARP_STAGES + 1)
                   * C._stage_bytes(n), 0)


def compare(label: str, b: int, n: int, cands: dict, reps: int,
            gen: torch.Generator) -> dict:
    a = torch.rand((b, n, n), generator=gen, device="cuda") < 0.02
    picked = C.closure_route(n)
    ref = launch(a, picked)
    plain = C.closure_plain(a[:PLAIN_GRAPHS])
    row = {"label": label, "graphs": b, "nodes": n,
           "picked": picked._asdict(), "picked_equals_plain": bool(
               (ref[:PLAIN_GRAPHS] == plain).all()), "candidates": {}}
    for name, r in cands.items():
        got = launch(a, r)
        row["candidates"][name] = {"route": r._asdict(),
                                   "equal": bool((got == ref).all()),
                                   "ms": []}
    order = list(cands) + list(reversed(cands))
    for name in order:
        row["candidates"][name]["ms"].append(
            median_ms(lambda: launch(a, cands[name]), reps))
    del a, ref
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_closure_routes: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    for b, n in SWITCH:
        row = compare("switch", b, n, {"warp": warp_route(n),
                                       "block": block_route(n,
                                       C.block_threads(n))}, args.reps, gen)
        ok &= row["picked_equals_plain"] and all(
            c["equal"] for c in row["candidates"].values())
        print(json.dumps(row), flush=True)
    for b, n in SWEEP:
        cands = {f"threads_{t}": block_route(n, t) for t in SWEEP_THREADS}
        row = compare("threads", b, n, cands, args.reps, gen)
        ok &= row["picked_equals_plain"] and all(
            c["equal"] for c in row["candidates"].values())
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
