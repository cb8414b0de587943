"""Run one cell of the benchmark and print its result line.

    python3 -m simbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the port's kernels loaded from ``build/kernels/`` or built
there, a warm-up episode of the cell's own shape from a key no window
episode takes) is timed from the start of this module.  With
``--trace 0`` episodes run back to back for ``--seconds`` and the result
holds the cell's end-to-end metrics; with ``--trace 1`` two whole episodes
run under the profiler and the result holds the per-layer metrics.
Either way the check (``check.py``) then works out episodes of the window
again with the plain reference.  Every line but the last is
information; the last line of standard output is the result, and the
last lines of standard error are the numbers compared, each beside its
limit.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "paxi_tpu")
SMI_FIELDS = "clocks.sm,power.draw,temperature.gpu,power.limit"


@dataclass
class WindowReading:
    """What an end-to-end metric's reader reads."""

    seconds: float                  # the window, host clock, device done
    cmds: int                       # commands committed or executed
    round_ms: List[float]           # every round's device-clock time
    setup_s: float


@dataclass
class Outcome:
    result: Dict
    info: List[Dict] = field(default_factory=list)
    numbers: list = field(default_factory=list)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class SmiSampler:
    """``nvidia-smi`` samples of the card's clock, power and temperature
    beside the window, one a second; nothing when the tool is absent."""

    def __init__(self):
        self.proc = None
        self.lines: List[str] = []

    def start(self) -> None:
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> List[List[str]]:
        if self.proc is not None:
            self.proc.terminate()
            try:
                out, _ = self.proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, _ = self.proc.communicate()
            self.lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
        return [[x.strip() for x in ln.split(",")] for ln in self.lines]


def _quantiles(values) -> List[float]:
    """Min, deciles and max of ``values`` (nearest rank)."""
    if not values:
        return []
    v = sorted(values)
    return [v[min(len(v) - 1, max(0, -(-k * len(v) // 10) - 1))]
            for k in range(11)]


def _read(metrics, reading) -> Dict[str, Dict]:
    from simbench import cells
    out = {}
    for m in metrics:
        value = cells.reader(m.name).read(reading)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out


def traced_episodes(prog, keys, lanes, clock, sync):
    """Two whole episodes under ``torch.profiler``: the first with the
    device's activity alone (the host's cost of recording every operator
    would hold the device back), for the device's busy time, idle share,
    launches and kernels; the second with the host's operators too and
    the layers' ranges, for each layer's device time and what the host
    was doing in each idle gap.  Returns the two episodes' window and the
    merged reading."""
    from torch.profiler import ProfilerActivity, profile

    from simbench import trace as tr
    from simbench.program import Window

    cuda = prog.device.type == "cuda"
    shapes = {"groups": prog.groups, "replicas": prog.cfg.n_replicas,
              "n_slots": prog.cfg.n_slots,
              "spec": prog.proto.mailbox_spec(prog.cfg)}
    passes = []
    for first in (0, 1):
        acts = ([ProfilerActivity.CUDA] if cuda and first == 0 else
                [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                          if cuda else []))
        with contextlib.ExitStack() as stack:
            proto = (stack.enter_context(tr.wrapped(prog)) if first
                     else None)
            prof = stack.enter_context(profile(activities=acts))
            sync()
            start = time.perf_counter()
            w = prog.run(keys, lanes, clock, max_episodes=1, proto=proto,
                         first=first)
            sync()
            w.seconds = time.perf_counter() - start
        passes.append((w, tr.reduce_events(
            prof.profiler.kineto_results.events(), w.rounds, w.seconds,
            shapes)))
        del prof
    (wa, device), (wb, layers) = passes
    device.ranges, device.gaps = layers.ranges, layers.gaps
    device.kinds = {"device_pass": device.kinds, "layer_pass": layers.kinds}
    device.unattributed_ops = layers.unattributed_ops
    win = Window(episodes=wa.episodes + wb.episodes,
                 marks=wa.marks, seconds=wa.seconds)
    return win, device


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float, groups: Optional[int] = None) -> Outcome:
    """Set up, run the window (or the traced episode), check it: the
    result line's fields, the information lines and the numbers
    compared.  ``groups`` overrides the configuration's batch (tests)."""
    import torch

    from simbench import check
    from simbench import trace as tr
    from simbench.program import (WARM_EPISODE, Clock, Program,
                                  sample_groups)

    prog = Program(cell, device, groups)
    dev = prog.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    lanes_np = sample_groups(seed, prog.groups,
                             int(cell.config["check"]["groups"]))
    lanes = torch.as_tensor(lanes_np, dtype=torch.int64, device=dev)
    clock = Clock(dev)
    warm_key = prog.key(seed, WARM_EPISODE)[None].to(dev)
    warm = prog.run(warm_key, lanes, clock, max_episodes=1,
                    rounds=int(cell.config["warmup_rounds"]))
    n_keys = 2 if trace else 8 + 4 * int(seconds)
    keys = prog.keys(seed, n_keys)
    sync()
    clock.gaps_ms(warm.marks)
    setup_s = time.perf_counter() - t0
    info = [{"setup_s": setup_s, "groups": prog.groups,
             "episode_rounds": prog.rounds, "device": str(dev)}]

    smi = SmiSampler()
    reading = None
    if trace:
        win, reading = traced_episodes(prog, keys, lanes, clock, sync)
    else:
        smi.start()
        start = time.perf_counter()
        win = prog.run(keys, lanes, clock, seconds=seconds,
                       max_episodes=n_keys)
        sync()
        win.seconds = time.perf_counter() - start
    samples = smi.stop()
    leaked = forbidden_modules()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    round_ms = clock.gaps_ms(win.marks)
    cmds = sum(int(e.metrics[prog.command]) for e in win.episodes)
    violations = sum(int(e.violations)
                     + int(e.metrics.get("inscan_violations", 0))
                     for e in win.episodes)
    info.append({"window_s": win.seconds, "episodes": len(win.episodes),
                 "rounds": win.rounds, "round_samples": len(round_ms),
                 "round_ms_quantiles": _quantiles(round_ms),
                 "cmds": cmds,
                 "cmds_per_episode": [int(e.metrics[prog.command])
                                      for e in win.episodes],
                 "rounds_per_episode": [e.rounds for e in win.episodes],
                 "memory_peak_bytes": peak})
    if samples:
        info.append({"nvidia_smi": SMI_FIELDS, "samples": samples})

    if trace:
        metrics = _read(cell.per_layer, reading)
        info.append({"trace_device_ops": reading.device_ops,
                     "trace_unattributed_ops": reading.unattributed_ops,
                     "trace_event_kinds": reading.kinds,
                     "trace_ranges_device_us": reading.ranges})
    else:
        w = WindowReading(seconds=win.seconds, cmds=cmds, round_ms=round_ms,
                          setup_s=setup_s)
        metrics = _read(cell.end_to_end, w)

    # a traced run's two episodes are one run's work twice over: the check
    # works out one of them again, drawn from the seed, so that the run
    # with its trace reading stays well inside its time
    numbers, check_info = check.judge(prog, win, seed, lanes_np,
                                      episodes=1 if trace else None)
    info.append(check_info)
    result = {"correct": all(n.ok for n in numbers) and not leaked,
              "attempted": win.rounds * prog.groups,
              "failed": violations,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": peak}}
    if samples:
        result["device"]["power_limit_w"] = float(samples[0][-1])
    if trace:
        result["device"]["busy_s"] = reading.busy_s
        result["device"]["window_s"] = reading.window_s
        result["breakdown"] = tr.breakdown(reading)
    result["check"] = {n.name: {"value": n.value, "limit": n.limit}
                       for n in numbers}
    out = Outcome(result, info, numbers)
    if leaked:
        out.info.append({"forbidden_modules": leaked})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from simbench import cells
    try:
        cell = cells.find_cell(args.workload)
    except (KeyError, OSError) as e:
        print(f"simbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"simbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import paxi_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"simbench: the port is not importable here: {e}",
              file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T0)
    leaked = forbidden_modules()
    if leaked:
        print(f"simbench: modules that no run may load were loaded: "
              f"{leaked}", file=sys.stderr)
        return 5
    for line in out.info:
        print(json.dumps(line), flush=True)
    for n in out.numbers:
        print(f"check {n.name} {n.value} limit {n.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
