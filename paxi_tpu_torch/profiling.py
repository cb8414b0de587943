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
``--gathers`` comparison against the frozen layout twins (``SW_TWINS``)
is not ported: their layout A/B is ``python -m paxi_tpu_torch.bench
--kernel <name>_sw`` beside ``--kernel <name>``.
``trace_dir`` wraps the timed runs in ``torch.profiler`` and writes a
Chrome trace (``trace.json``, for chrome://tracing or Perfetto); beside it
``spans.json``, the runner's own spans of the timed runs (an episode a
run, a ``round`` span a round and its stages, each with its device
milliseconds on the card) through ``obs.render.chrome_trace``.  A sharded
run writes ``trace.json`` alone: the sharded runner records no spans.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["run_profile", "main_json", "SW_TWINS", "resolve_kernel"]

# the kernels rewritten onto the fixed-cell layout keep their frozen
# sliding-window counterpart as ``sim_sw.py``: the equivalence proof's
# other side, and ``bench --kernel <name>_sw``'s layout A/B.  Not in the
# ``sim_protocol`` registry, as in the reference.
SW_TWINS = {
    "paxos": "paxi_tpu_torch.protocols.paxos.sim_sw",
    "sdpaxos": "paxi_tpu_torch.protocols.sdpaxos.sim_sw",
    "wpaxos": "paxi_tpu_torch.protocols.wpaxos.sim_sw",
    "wankeeper": "paxi_tpu_torch.protocols.wankeeper.sim_sw",
    "bpaxos": "paxi_tpu_torch.protocols.bpaxos.sim_sw",
}


def resolve_kernel(name: str):
    """The sim kernel ``name`` names: ``<kernel>_sw`` is the frozen
    sliding-window twin of a ``SW_TWINS`` kernel, any other name a
    registered one (``protocols.sim_protocol``)."""
    import importlib

    from paxi_tpu_torch.protocols import sim_protocol
    if name.endswith("_sw"):
        try:
            module = SW_TWINS[name[:-3]]
        except KeyError:
            raise KeyError(f"no sliding-window twin {name!r}; known: "
                           f"{sorted(k + '_sw' for k in SW_TWINS)}") from None
        return importlib.import_module(module).PROTOCOL
    return sim_protocol(name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_spans(trace_dir: str, spans) -> None:
    """The collector's spans as ``<trace_dir>/spans.json`` (Trace Event
    Format), their device times resolved (the caller has synced)."""
    from paxi_tpu_torch.obs import chrome_trace as render
    spans.resolve()
    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "spans.json"), "w",
              encoding="utf-8") as f:
        json.dump(render(spans.export()), f)


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
    spans = None
    if mesh is not None:
        from paxi_tpu_torch.parallel import make_sharded_run
        dev = mesh.device
        run = timed = make_sharded_run(proto, cfg, fuzz=fuzz, mesh=mesh)
    else:
        dev = resolve_device(device)
        run = timed = make_run(proto, cfg, fuzz=fuzz, device=dev)
        if trace_dir:
            from paxi_tpu_torch.obs import SpanCollector
            spans = SpanCollector(
                node="profile", cap=max(repeats, 1) * (10 * steps + 4))
            timed = make_run(proto, cfg, fuzz=fuzz, device=dev, spans=spans)
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
            _, metrics, viols = timed(tr.PRNGKey(seed), groups, steps)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
    if spans is not None:
        write_spans(trace_dir, spans)

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
