"""The traced run: one whole episode under ``torch.profiler``, with the
calls into each layer wrapped in ``record_function`` ranges by this file
(the program has no spans on its simulation path).

- the protocol's ``step`` and ``invariants`` through
  ``dataclasses.replace`` of the frozen protocol record;
- the runner's module-level calls, patched for the traced run only: the
  exchange (``ops.exchange.wheel_deliver``/``wheel_insert``), the fault
  schedule (``lanes.fault_state_refresh``, ``mailbox.draw_edge_faults``),
  the counters (``step_counts``), the latency flush
  (``flush_measurements``), the episode's ``init_carry`` and
  ``finish_run``;
- the port's own kernels by name.

A range's device time is the time of the device operations launched
inside it: each kernel, copy or fill is tied to its launch by the
profiler's correlation id, and the launch to the range open on the host
at that moment.  The reduction keeps sums and counts only.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
from unittest import mock

import torch

RANGES = ("protocol_step", "invariants", "faults", "exchange", "counts",
          "flush", "episode_start", "episode_end")
# the profiler's kinds of work that run on the device, and of the host
# calls that launch them
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


@dataclass
class TraceReading:
    """What a per-layer metric's reader reads: sums over the traced
    episode, and the cell's shapes."""

    rounds: int
    window_s: float
    busy_s: float = 0.0
    device_ops: int = 0
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    ranges: Dict[str, float] = field(default_factory=dict)   # device us
    unattributed_ops: int = 0
    kinds: Dict[str, int] = field(default_factory=dict)     # events
    gaps: List[Tuple[str, float]] = field(default_factory=list)
    shapes: Dict = field(default_factory=dict)

    def kernel_us(self, *names: str) -> Tuple[float, int]:
        """Summed device time (us) and count of the kernels whose name
        holds any of ``names``."""
        us, n = 0.0, 0
        for k, (t, c) in self.kernels.items():
            if any(x in k for x in names):
                us += t
                n += c
        return us, n


def _ranged(name: str, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return inner


@contextlib.contextmanager
def wrapped(prog):
    """Patch the runner's calls into each layer with ranges; yields the
    protocol record with its step and invariants wrapped."""
    from paxi_tpu_torch.sim import runner as rn

    targets = [(rn.ops, "wheel_deliver", "exchange"),
               (rn.ops, "wheel_insert", "exchange"),
               (rn.lanes, "fault_state_refresh", "faults"),
               (rn.mb, "draw_edge_faults", "faults"),
               (rn, "step_counts", "counts"),
               (rn, "flush_measurements", "flush"),
               (rn, "init_carry", "episode_start"),
               (rn, "finish_run", "episode_end")]
    proto = dataclasses.replace(
        prog.proto, step=_ranged("protocol_step", prog.proto.step),
        invariants=_ranged("invariants", prog.proto.invariants))
    with contextlib.ExitStack() as stack:
        for mod, attr, name in targets:
            stack.enter_context(mock.patch.object(
                mod, attr, _ranged(name, getattr(mod, attr))))
        yield proto


def _kind(name: str, on_card: bool) -> str:
    """The profiler's kind of an event, told from its name and whether it
    ran on the card (the card's torch gives ``kineto_results`` events no
    activity type)."""
    if on_card:
        if name in RANGES:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in RANGES:
        return "user_annotation"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def _innermost(spans, starts, t) -> Optional[str]:
    """The latest-starting span of ``spans`` (sorted by start) that holds
    ``t``: the innermost of nested spans."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, end, name = spans[j]
        if s <= t <= end:
            return name
    return None


def reduce_events(events, rounds: int, window_s: float,
                  shapes: Dict) -> TraceReading:
    """Sums over the profiler's flat event list (``kineto_results``)."""
    ranges, ops, launches, device = [], [], {}, []
    kinds = defaultdict(int)
    on_card = {}     # the profiler's device type -> whether it is the card
    for e in events:
        name, dt = e.name(), e.device_type()
        card = on_card.get(dt)
        if card is None:
            card = on_card[dt] = str(dt).endswith("CUDA")
        kind = _kind(name, card)
        kinds[kind] += 1
        if kind == "user_annotation":
            ranges.append((e.start_ns(), e.end_ns(), name))
        elif kind == "cpu_op":
            ops.append((e.start_ns(), e.end_ns(), name))
        elif kind in _LAUNCH_KINDS:
            launches[e.correlation_id()] = e.start_ns()
        elif kind in _DEVICE_KINDS:
            device.append((e.start_ns(), e.end_ns(), name,
                           e.correlation_id(), e.linked_correlation_id()))
    ranges.sort()
    ops.sort()
    r_starts = [s for s, _, _ in ranges]
    o_starts = [s for s, _, _ in ops]
    out = TraceReading(rounds=rounds, window_s=window_s, shapes=shapes,
                       kinds=dict(kinds))
    kernels = defaultdict(lambda: [0.0, 0])
    by_range = defaultdict(float)
    device.sort()
    labels = []
    for start, end, name, corr, linked in device:
        us = (end - start) / 1e3
        k = kernels[name[:200]]
        k[0] += us
        k[1] += 1
        t = launches.get(corr, launches.get(linked))
        if t is None:
            out.unattributed_ops += 1
            labels.append("unattributed")
            continue
        rng = _innermost(ranges, r_starts, t) or "other"
        by_range[rng] += us
        op = _innermost(ops, o_starts, t) or "launch"
        labels.append(f"{rng}/{op}")
    out.device_ops = len(device)
    out.kernels = dict(kernels)
    out.ranges = dict(by_range)
    # busy: the union of the device's intervals; each gap between them is
    # put down to what the host was launching when the gap ended
    busy, gaps = 0, defaultdict(float)
    cur_s = cur_e = None
    for (start, end, *_), label in zip(device, labels):
        if cur_e is None:
            cur_s, cur_e = start, end
        elif start > cur_e:
            busy += cur_e - cur_s
            gaps[label] += (start - cur_e) / 1e9
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        busy += cur_e - cur_s
    out.busy_s = busy / 1e9
    out.gaps = sorted(gaps.items(), key=lambda kv: -kv[1])
    return out


def breakdown(r: TraceReading, top: int = 10) -> Dict[str, list]:
    ops = sorted(((k, v[0] / 1e6) for k, v in r.kernels.items()),
                 key=lambda kv: -kv[1])
    return {"device_ops": [[k, s] for k, s in ops[:top]],
            "idle_gaps": [[k, s] for k, s in r.gaps[:top]]}
