"""North-star benchmark on the torch sim runtime: committed Paxos slots a
second over simulated groups (the port's twin of the root ``bench.py``'s
worker; prints ONE JSON line under the reference's field names).

    python -m paxi_tpu_torch.bench                      # the card
    python -m paxi_tpu_torch.bench --device cpu
    python -m paxi_tpu_torch.bench --kernel paxos_sw    # layout A/B
    python -m paxi_tpu_torch.bench --mesh 2 --device cpu

Target (``BASELINE.json``'s north star): 10M committed slots across 100k
simulated 5-replica groups, with per-step safety-invariant checks.  On the
card the shape is 100,000 groups x 5 replicas x a 64-slot ring for
``ceil(10M / G) + 4`` = 104 steps of the lane-major ``paxos`` kernel; on
the CPU 2,048 groups x 200,000 slots of the per-group ``paxos_pg`` kernel
(100,000 groups x 3.2M slots over a CPU mesh), as the reference picks
them.  ``BENCH_GROUPS``/``BENCH_SLOTS`` (card), ``BENCH_CPU_GROUPS``/
``BENCH_CPU_SLOTS`` (CPU), ``BENCH_REPLICAS`` and ``BENCH_RING`` override
the shape.

Flags set their environment variable unless it is set already (the
variable wins): ``--kernel NAME`` (``BENCH_KERNEL``) runs any registered
sim kernel, or ``<name>_sw``, the frozen sliding-window twin of a
fixed-cell kernel (``profiling.SW_TWINS``); ``--mesh [N]``
(``BENCH_MESH``; bare: every card, or 8 CPU ranks) shards the groups over
N ranks started by ``parallel.launch.spawn``; ``--label``
(``BENCH_LABEL``) names the scaling curve.  ``--device cpu`` runs on the
CPU; the card is the default and there is no fallback.

Three phases, each ended by a device sync: ``compile_s`` is the first
launch, one step at the full shape, which builds the path's CUDA kernels
(once a source; ``ops/_build``); ``warmup_s`` is one whole run with key
1; the timed run uses key 0.  ``backend`` says which exchange ran: ``cuda`` (the
hand-written kernels) or ``plain`` (their plain versions on the CPU, and
the per-group kernels' tensor exchange).

After the line, unless ``BENCH_SCALING=0``, a sweep at 36 steps (256,
4,096 and 32,768 groups on the card; 256, 1,024 and 2,048 on the CPU;
2,048 and 16,384 over a CPU mesh; only sizes below the run's) is printed
on stderr and written as a labelled curve to
``build/bench/BENCH_SCALING.json``, never to the JAX package's root file.
Exits 1 when the run violated any invariant.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

BASELINE_SLOTS_PER_SEC = 10_000_000 / 60.0
SCALING_PATH = Path(__file__).resolve().parents[1] / "build" / "bench" \
    / "BENCH_SCALING.json"
SWEEP_STEPS = 36
CPU_MESH_RANKS = 8     # the reference's virtual CPU mesh for a bare --mesh


def _mesh_ranks(v: str) -> int:
    """``BENCH_MESH``: 0/empty = one device; ``all``/``auto`` = every
    device (-1); N = N ranks."""
    v = (v or "0").strip().lower()
    if v in ("", "0"):
        return 0
    if v in ("all", "auto"):
        return -1
    return int(v)


def card_label(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``cpu`` on the CPU)."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def shape(on_cpu: bool, use_mesh: bool):
    """``(n_groups, target_slots)`` of the run (the reference's shapes and
    overrides)."""
    env = os.environ.get
    if on_cpu and use_mesh:
        return (int(env("BENCH_CPU_GROUPS", 100_000)),
                int(env("BENCH_CPU_SLOTS", 3_200_000)))
    if on_cpu:
        return (int(env("BENCH_CPU_GROUPS", 2048)),
                int(env("BENCH_CPU_SLOTS", 200_000)))
    return (int(env("BENCH_GROUPS", 100_000)),
            int(env("BENCH_SLOTS", 10_000_000)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _hist_state(state, mesh, n_groups: int):
    """The latency planes of the whole batch as group-major numpy (a
    sharded run gathers them from every rank)."""
    planes = {k: state[k] for k in ("m_lat_hist", "m_commit_dt")
              if k in state}
    if mesh is not None:
        from paxi_tpu_torch.parallel import gather_state
        planes = gather_state(planes, mesh, n_groups)
    return {k: v.cpu().numpy() for k, v in planes.items()}


def measure(kernel: str, n_groups: int, n_steps: int, replicas: int,
            ring: int, sweep, mesh=None, device=None, timed=None):
    """Build, warm and time one run, then the sweep: ``(line fields,
    curve points)``.  ``timed`` (a context manager factory) brackets the
    timed run only, so a caller can read what that run launched."""
    import contextlib

    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.metrics import lathist
    from paxi_tpu_torch.profiling import resolve_kernel
    from paxi_tpu_torch.sim import SimConfig, make_run
    from paxi_tpu_torch.sim.types import resolve_device

    dev = mesh.device if mesh is not None else resolve_device(device)
    proto = resolve_kernel(kernel)
    cfg = SimConfig(n_replicas=replicas, n_slots=ring)

    def runner(p):
        if mesh is not None:
            from paxi_tpu_torch.parallel import make_sharded_run
            return make_sharded_run(p, cfg, mesh=mesh)
        return make_run(p, cfg, device=dev)

    # the first launch, one step at the full shape, builds the kernels the
    # path runs (``ops/_build``: once a source, then loaded)
    t0 = time.perf_counter()
    run = runner(proto)
    int(run(tr.PRNGKey(0), n_groups, 1)[2])
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int(run(tr.PRNGKey(1), n_groups, n_steps)[2])
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    with (timed() if timed is not None else contextlib.nullcontext()):
        t0 = time.perf_counter()
        state, metrics, viols = run(tr.PRNGKey(0), n_groups, n_steps)
        viols = int(viols)
        _sync(dev)
        dt = time.perf_counter() - t0

    committed = int(metrics["committed_slots"])
    rate = committed / dt
    line = {
        "metric": "committed_paxos_slots_per_sec",
        "value": round(rate, 1),
        "unit": "slots/s",
        "vs_baseline": round(rate / BASELINE_SLOTS_PER_SEC, 3),
        "committed_slots": committed,
        "wall_s": round(dt, 3),
        "compile_s": round(compile_s, 3),
        "warmup_s": round(warmup_s, 3),
        "invariant_violations": viols,
        "inscan_violations": int(metrics.get("inscan_violations", -1)),
        "groups": n_groups,
        "replicas": replicas,
        "steps": n_steps,
        "ring_slots": ring,
        "kernel": proto.name,
        "mesh": mesh.world if mesh is not None else 0,
        "backend": "cuda" if dev.type == "cuda" and proto.batched
        else "plain",
        "device": card_label(dev),
    }
    hist = lathist.total_hist(_hist_state(state, mesh, n_groups))
    if hist is not None:
        lat_sum = int(metrics.get("commit_lat_sum", 0))
        lat = lathist.summarize(hist, lat_sum)
        line["commit_latency"] = lat
        line["latency_p50_rounds"] = lat["p50_rounds"]
        line["latency_p99_rounds"] = lat["p99_rounds"]
        line["sim_metrics"] = {"histograms": [{
            "name": "paxi_sim_commit_latency_seconds",
            "labels": {"kernel": proto.name, "source": "sim"},
            **lathist.to_host_snapshot(hist, lat_sum)}]}
    del state

    curve = []
    for g in sorted(set(x for x in sweep if x < n_groups)):
        int(run(tr.PRNGKey(0), g, SWEEP_STEPS)[2])       # warm
        _sync(dev)
        t0 = time.perf_counter()
        _, mtr, vv = run(tr.PRNGKey(1), g, SWEEP_STEPS)
        int(vv)
        _sync(dev)
        curve.append({"groups": g, "steps": SWEEP_STEPS,
                      "wall_s": round(time.perf_counter() - t0, 4),
                      "committed": int(mtr["committed_slots"])})
    curve.append({"groups": n_groups, "steps": n_steps,
                  "wall_s": line["wall_s"], "committed": committed})
    return line, curve


def _mesh_rank(mesh, kw):
    return measure(**kw, mesh=mesh)


def write_curve(curve: dict, path=None) -> None:
    """Put ``curve`` into ``path``'s (default ``SCALING_PATH``) ``{"curves":
    [...]}``, replacing a curve of the same label."""
    path = Path(path or SCALING_PATH)
    doc = {"curves": []}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        pass
    doc["curves"] = [c for c in doc.get("curves", [])
                     if c.get("label") != curve["label"]] + [curve]
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def worker(device=None, timed=None) -> int:
    """Measure as the ``BENCH_*`` environment says, print the line, then
    the sweep; 0 when no invariant was violated, else 1."""
    from paxi_tpu_torch.sim.types import resolve_device

    dev = resolve_device(device)
    on_cpu = dev.type == "cpu"
    mesh_n = _mesh_ranks(os.environ.get("BENCH_MESH", "0"))
    avail = CPU_MESH_RANKS if on_cpu else torch.cuda.device_count()
    n_ranks = avail if mesh_n < 0 else (mesh_n if on_cpu
                                        else min(mesh_n, avail))
    use_mesh = mesh_n != 0 and n_ranks > 1
    n_groups, target = shape(on_cpu, use_mesh)
    # steady state commits a slot a group a step after a 4-step warm-up
    n_steps = -(-target // n_groups) + 4
    kernel = os.environ.get("BENCH_KERNEL", "") or (
        "paxos_pg" if on_cpu else "paxos")
    scaling = os.environ.get("BENCH_SCALING", "1") == "1"
    sweep = (None if not scaling
             else (256, 4096, 32768) if not on_cpu
             else (2048, 16384) if use_mesh else (256, 1024, 2048))
    kw = dict(kernel=kernel, n_groups=n_groups, n_steps=n_steps,
              replicas=int(os.environ.get("BENCH_REPLICAS", 5)),
              ring=int(os.environ.get("BENCH_RING", 64)), sweep=sweep or ())
    if use_mesh:
        from paxi_tpu_torch.parallel.launch import spawn
        line, curve = spawn(n_ranks, _mesh_rank, kw, device=device)[0]
    else:
        line, curve = measure(**kw, device=dev, timed=timed)
    print(json.dumps(line))
    sys.stdout.flush()
    if scaling:
        label = os.environ.get("BENCH_LABEL") or (
            line["kernel"] + (f"-mesh{n_ranks}" if use_mesh else "-single"))
        sc = {"label": label, "kernel": line["kernel"],
              "device": line["device"], "mesh": line["mesh"],
              "backend": line["backend"], "points": curve}
        print("bench-scaling: " + json.dumps(sc), file=sys.stderr,
              flush=True)
        write_curve(sc)
    bad = line["invariant_violations"] > 0 or line["inscan_violations"] > 0
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", nargs="?", const="all", default=None,
                    metavar="N", help="shard the groups over N ranks "
                    "(bare: every card, or 8 CPU ranks; BENCH_MESH)")
    ap.add_argument("--label", default=None,
                    help="the scaling curve's label (BENCH_LABEL)")
    ap.add_argument("--kernel", default=None,
                    help="any registered sim kernel, or '<name>_sw' for a "
                         "frozen sliding-window twin (BENCH_KERNEL)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    for flag, var in ((args.mesh, "BENCH_MESH"), (args.label, "BENCH_LABEL"),
                      (args.kernel, "BENCH_KERNEL")):
        if flag is not None:
            os.environ.setdefault(var, flag)
    return worker(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
