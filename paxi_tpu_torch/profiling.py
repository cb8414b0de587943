"""Phase-timed profiling of a bench-shaped run on the torch sim runtime
(the port's twin of the JAX package's ``profiling.py``).

``python -m paxi_tpu_torch profile`` answers "where did the wall time
go?" for one run, in the phases eager PyTorch has: build (the protocol,
the runner and, on the card, loading the CUDA kernels, built from source
on first use), a warm-up run (first-touch allocation), and the best of
``repeats`` timed runs, each bracketed by ``torch.cuda.synchronize``.
From the best run it derives ``steps_per_s`` and ``slots_per_s``.  Eager
PyTorch has no lowering or compilation, so ``lower_s``, ``compile_s`` and
the compiled-HLO op counts are reported as null; the reference's
``--gathers`` comparison against the frozen layout twins is not ported.
``trace_dir`` wraps the timed runs in ``torch.profiler`` and writes a
Chrome trace (``trace.json``, for chrome://tracing or Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["run_profile", "main_json"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def chrome_trace(trace_dir: str):
    """Profile the block (CPU and, where there is one, the card) into
    ``<trace_dir>/trace.json``; a no-op when ``trace_dir`` is empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def _profile_rank(mesh, kw):
    return run_profile(**kw, mesh=mesh)


def run_profile(algorithm: str = "paxos_pg", groups: int = 2048,
                steps: int = 36, replicas: int = 5, slots: int = 64,
                seed: int = 0, shard: int = 0, repeats: int = 3,
                trace_dir: str = "", fuzz=None, device=None,
                mesh=None) -> dict:
    """One bench-shaped run with per-phase wall timings; returns the
    report (the CLI prints it as one JSON line).  ``shard`` > 0 runs it
    sharded over that many local ranks (``parallel.launch.spawn``) and
    returns rank 0's report."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run
    from paxi_tpu_torch.sim.types import resolve_device

    if shard and mesh is None:
        from paxi_tpu_torch.parallel.launch import spawn
        kw = dict(algorithm=algorithm, groups=groups, steps=steps,
                  replicas=replicas, slots=slots, seed=seed, shard=shard,
                  repeats=repeats, trace_dir=trace_dir, fuzz=fuzz)
        return spawn(shard, _profile_rank, kw, device=device)[0]

    t0 = time.perf_counter()
    proto = sim_protocol(algorithm)
    cfg = SimConfig(n_replicas=replicas, n_slots=slots)
    fuzz = fuzz or FuzzConfig()
    if mesh is not None:
        from paxi_tpu_torch.parallel import make_sharded_run
        dev = mesh.device
        run = make_sharded_run(proto, cfg, fuzz=fuzz, mesh=mesh)
    else:
        dev = resolve_device(device)
        run = make_run(proto, cfg, fuzz=fuzz, device=dev)
    # the lane-major exchange launches the CUDA kernels on the card and
    # runs their plain versions on the CPU; per-group kernels exchange
    # through tensor code on either
    on_card = dev.type == "cuda"
    exchange = "cuda" if on_card and proto.batched else "plain"
    if on_card:
        from paxi_tpu_torch.ops import _build
        for name in ("exchange", "closure"):
            _build.load(name)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _sync(dev)
    run(tr.PRNGKey(seed + 1), groups, steps)
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    best = float("inf")
    with chrome_trace(trace_dir if (mesh is None or mesh.rank == 0)
                      else ""):
        for _ in range(max(repeats, 1)):
            t0 = time.perf_counter()
            _, metrics, viols = run(tr.PRNGKey(seed), groups, steps)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)

    committed = int(metrics.get("committed_slots", 0))
    return {
        "algorithm": algorithm,
        "groups": groups,
        "steps": steps,
        "replicas": replicas,
        "ring_slots": slots,
        "mesh": mesh.world if mesh is not None else 0,
        "exchange": exchange,
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else str(dev)),
        "phases": {
            "build_s": round(build_s, 4),
            "lower_s": None,       # eager: nothing is lowered
            "compile_s": None,     # ... or compiled
            "warmup_s": round(warmup_s, 4),
            "run_s": round(best, 4),
        },
        "steps_per_s": round(steps / best, 2),
        "slots_per_s": round(committed / best, 1),
        "committed_slots": committed,
        "invariant_violations": int(viols),
        "hlo_ops": None,
        "profile_dir": trace_dir or None,
    }


def main_json(**kw) -> int:
    rep = run_profile(**kw)
    print(json.dumps(rep))
    return 0 if rep["invariant_violations"] == 0 else 1
