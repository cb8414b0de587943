"""The round loop's own spans in the traced run: what the host does in each
stage of a round.

The program records its spans itself (``paxi_tpu_torch.obs.SpanCollector``
handed to the runner's ``init_carry``, ``make_scan_body`` and
``finish_run``): one ``round`` span a round holding its ``stage`` spans in
order, each boundary stamped on the host clock and by a CUDA event on the
run's stream.  This file runs the traced run's first episode once more
with a collector, under ``torch.profiler`` with the device's activity
alone (the CUDA runtime calls and the device's operations), and reduces
the profile against the spans:

- one clock: each boundary's ``cudaEventRecordWithFlags`` call is in the
  profile, and the boundary's host stamp is read just after it returns;
  the calls are matched in order to the spans' boundaries, and the
  matched calls' end times are the stages' edges on the profile's clock
  (the offset and its spread over a round are reported);
- to each stage, from the events that start inside it: the CUDA API calls
  (``cu*``; count and host time, the recorder's own event calls apart), the device operations launched (count and device time), the
  copies between host and device, and the device's idle gaps that end at
  an operation launched in it;
- dispatch: a span's host time less the time inside the program's
  runtime calls and less its closing boundary's own host time (the
  ``boundary_us`` label: the event's creation and record), what Python
  and ATen dispatch took.

The pass runs from a metric's reader: a reader is handed the traced run's
``TraceReading`` alone, so ``of()`` finds the cell's program in the
harness's ``run_cell`` frame and keeps the result on the reading, for the
other readers.  A program whose runner takes no ``spans`` (or no card)
gives nothing, and the readers say nothing.
"""

from __future__ import annotations

import bisect
import inspect
import json
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

STAGES = ("keys", "deliver", "step", "faults", "counts", "insert",
          "invariants", "flush")
# the recorder's calls at each boundary: the capture check, then the record
RECORDS = ("cudaEventRecordWithFlags", "cudaEventRecord")
CAPTURE_CHECK = "cudaStreamIsCapturing"
COPIES = ("Memcpy HtoD", "Memcpy DtoH")
# CUPTI's mark of a launch that found the device's command queue full
QUEUE_FULL = "Command Buffer Full"
# the port's own kernels, by name, and the stage each must fall in
NAMED = {"deliver_kernel": "deliver", "insert_kernel": "insert",
         "closure_kernel": "step", "closure_block_kernel": "step"}
MATCH_NS = 50_000          # a boundary's stamp follows its record by less


class Event(NamedTuple):
    """One profiler event: a host call or a device operation."""

    name: str
    on_card: bool
    start_ns: int
    end_ns: int
    corr: int


SUMS = ("host_ms", "runtime_ms", "runtime_calls", "recorder_ms", "launches",
        "copies", "device_ms", "idle_ms", "event_ms", "queue_full")


@dataclass
class Figures:
    """Sums over a set of spans."""

    spans: int = 0
    host_ms: float = 0.0
    runtime_ms: float = 0.0      # the program's CUDA API calls
    runtime_calls: int = 0
    recorder_ms: float = 0.0     # the closing boundaries' own host time
    launches: int = 0            # device operations launched
    copies: int = 0              # host <-> device copies launched
    device_ms: float = 0.0       # device time of the operations launched
    idle_ms: float = 0.0         # device idle gaps ended by those
    event_ms: float = 0.0        # device clock between the span's events
    queue_full: int = 0          # launches that found the queue full

    @property
    def dispatch_ms(self) -> float:
        return self.host_ms - self.runtime_ms - self.recorder_ms

    def per(self, n: int) -> Dict[str, float]:
        return {k: getattr(self, k) / n for k in ("dispatch_ms",) + SUMS}


@dataclass
class StageReading:
    """The spans pass, reduced: figures a stage, a round and an episode
    part, the clock's match, the named kernels' stages."""

    rounds: int
    stages: Dict[str, Figures] = field(default_factory=dict)
    round: Figures = field(default_factory=Figures)
    episode: Dict[str, Figures] = field(default_factory=dict)  # init, finish
    device_ops: int = 0
    busy_ns: int = 0
    boundaries: int = 0
    matched: int = 0
    offset_ns: float = 0.0
    spread_us: List[float] = field(default_factory=list)   # a round each
    named: Dict[str, Dict[str, int]] = field(default_factory=dict)
    extra: Dict = field(default_factory=dict)

    def named_share(self) -> Optional[float]:
        """The share of the named kernels that fall in their own stage."""
        total = sum(sum(v.values()) for v in self.named.values())
        if not total:
            return None
        ok = sum(v.get(NAMED[k], 0) for k, v in self.named.items())
        return 100.0 * ok / total

    def line(self) -> Dict:
        n = max(self.rounds, 1)
        spread = sorted(self.spread_us)
        return {
            "stages": {s: f.per(n) for s, f in self.stages.items()},
            "stages_round": self.round.per(n),
            "stages_episode": {s: f.per(1) for s, f in self.episode.items()},
            "stages_pass": {
                "rounds": self.rounds, "device_ops": self.device_ops,
                "boundaries": self.boundaries, "matched": self.matched,
                "offset_ns": self.offset_ns,
                "offset_spread_us_max": spread[-1] if spread else None,
                "offset_spread_us_median": (statistics.median(spread)
                                            if spread else None),
                "offset_spread_us_p90": (spread[int(0.9 * (len(spread) - 1))]
                                         if spread else None),
                "named_kernels": self.named,
                "named_in_stage_pct": self.named_share(), **self.extra}}


def flat(events) -> List[Event]:
    """The profiler's events (``kineto_results.events()``) as tuples."""
    out = []
    on = {}
    for e in events:
        dt = e.device_type()
        card = on.get(dt)
        if card is None:
            card = on[dt] = str(dt).endswith("CUDA")
        out.append(Event(e.name(), card, e.start_ns(), e.end_ns(),
                         e.correlation_id()))
    return out


def _runtime(e: Event) -> bool:
    return not e.on_card and e.name.startswith("cu")


def match(host_ns: Sequence[int], recs: Sequence[int],
          tol_ns: int = MATCH_NS) -> Tuple[List[Optional[int]], float]:
    """Each boundary's record, in order: ``(index into recs or None, the
    median offset recs - host)``, ``recs`` the records' end times.  The offset is first taken among those
    aligning the first boundary with one of the first records: the one
    that matches the most boundaries, and of those the one whose matches
    sit closest to it (a record no boundary made lies off the others);
    then the median of the matched differences."""
    if not host_ns or not recs:
        return [None] * len(host_ns), 0.0

    def pairs(off: float):
        out, j = [], 0
        for h in host_ns:
            want = h + off
            j = bisect.bisect_left(recs, want - tol_ns, lo=j)
            best = None
            k = j
            while k < len(recs) and recs[k] <= want + tol_ns:
                if best is None or abs(recs[k] - want) < abs(recs[best]
                                                             - want):
                    best = k
                k += 1
            out.append(best)
            if best is not None:
                j = best + 1
        return out

    def score(off: float):
        got = pairs(off)
        res = [recs[m] - h - off for h, m in zip(host_ns, got)
               if m is not None]
        return len(res), -sum(abs(x) for x in res)

    cands = [recs[j] - host_ns[0] for j in range(min(len(recs), 64))]
    off = max(cands, key=score)
    got = pairs(off)
    diffs = [recs[m] - h for h, m in zip(host_ns, got) if m is not None]
    off = statistics.median(diffs) if diffs else off
    return pairs(off), float(off)


def _merged(intervals):
    """Overlapping ``(start, end, key)`` intervals merged (a call nested
    in another counts once); each keeps the key of its first member."""
    out = []
    for s, e, k in sorted(intervals):
        if out and s < out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e, k])
    return out


def reduce(events: Sequence[Event], docs: Sequence[Dict]) -> StageReading:
    """Reduce a profile of the spans pass against the spans' documents
    (``SpanCollector.export()`` after ``resolve``; host times in seconds)."""
    rounds = [d for d in docs if d["kind"] == "round"]
    stage_docs = [d for d in docs if d["kind"] == "stage"]
    out = StageReading(rounds=len(rounds))
    def ns(t: float) -> int:
        return int(round(t * 1e9))

    host_ns = sorted({ns(d[k]) for d in rounds + stage_docs
                      for k in ("t0", "t1")})
    runtime = sorted((e for e in events if _runtime(e)),
                     key=lambda e: e.start_ns)
    rec_idx = [i for i, e in enumerate(runtime) if e.name in RECORDS]
    got, off = match(host_ns, [runtime[i].end_ns for i in rec_idx])
    out.boundaries, out.offset_ns = len(host_ns), off
    out.matched = sum(m is not None for m in got)
    edge = {}
    recorder = set()
    for h, m in zip(host_ns, got):
        if m is None:
            edge[h] = h + off
            continue
        i = rec_idx[m]
        edge[h] = runtime[i].end_ns
        recorder.add(i)
        if i and runtime[i - 1].name == CAPTURE_CHECK:
            recorder.add(i - 1)
    kids: Dict[str, List[Dict]] = {}
    for d in stage_docs:
        kids.setdefault(d["parent"], []).append(d)
    for r in rounds:
        ds = [edge[ns(d[k])] - ns(d[k]) for d in [r] + kids.get(r["sid"], [])
              for k in ("t0", "t1")]
        out.spread_us.append((max(ds) - min(ds)) / 1e3)

    def interval(d):
        return edge[ns(d["t0"])], edge[ns(d["t1"])]

    # every stage (the rounds' and the episode's) by its start on the
    # profile's clock; an event belongs to the stage its start falls in
    leaves = sorted((interval(d) + (d,) for d in stage_docs),
                    key=lambda x: x[0])
    starts = [a for a, _, _ in leaves]

    def leaf(t: int) -> Optional[Dict]:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t >= leaves[i][1]:
            return None
        return leaves[i][2]

    figs = {d["sid"]: Figures() for d in stage_docs}

    def fig(d) -> Figures:
        return figs[d["sid"]]

    for d in stage_docs:
        f = fig(d)
        f.spans = 1
        f.host_ms = (d["t1"] - d["t0"]) * 1e3
        f.event_ms = float(d["labels"].get("device_ms", 0.0))
        f.recorder_ms = float(d["labels"].get("boundary_us", 0.0)) / 1e3
    for e in events:
        d = None if e.on_card or e.name != QUEUE_FULL else leaf(e.start_ns)
        if d is not None:
            fig(d).queue_full += 1
    calls = _merged([(e.start_ns, e.end_ns, i) for i, e in enumerate(runtime)
                     if i not in recorder])
    for s, e, _ in calls:
        d = leaf(s)
        if d is not None:
            f = fig(d)
            f.runtime_ms += (e - s) / 1e6
            f.runtime_calls += 1
    launched = {e.corr: e.start_ns for e in runtime}
    device = sorted((e for e in events if e.on_card),
                    key=lambda e: e.start_ns)
    out.device_ops = len(device)
    cur_end = None
    for e in device:
        t = launched.get(e.corr)
        d = None if t is None else leaf(t)
        gap = 0 if cur_end is None else max(e.start_ns - cur_end, 0)
        if cur_end is None or e.start_ns > cur_end:
            out.busy_ns += e.end_ns - e.start_ns
            cur_end = e.end_ns
        elif e.end_ns > cur_end:
            out.busy_ns += e.end_ns - cur_end
            cur_end = e.end_ns
        for k in NAMED:
            if k in e.name:
                stage = "none" if d is None else d["labels"]["stage"]
                n = out.named.setdefault(k, {})
                n[stage] = n.get(stage, 0) + 1
        if d is None:
            continue
        f = fig(d)
        f.launches += 1
        f.device_ms += (e.end_ns - e.start_ns) / 1e6
        f.idle_ms += gap / 1e6
        if e.name.startswith(COPIES):
            f.copies += 1
    in_round = {r["sid"] for r in rounds}
    for d in stage_docs:
        f = figs[d["sid"]]
        name = d["labels"]["stage"]
        into = (out.stages.setdefault(name, Figures())
                if d["parent"] in in_round
                else out.episode.setdefault(name, Figures()))
        for g in (into,) + ((out.round,) if d["parent"] in in_round
                            else ()):
            for k in ("spans",) + SUMS:
                setattr(g, k, getattr(g, k) + getattr(f, k))
    out.round.spans = len(rounds)
    out.stages = {s: out.stages[s] for s in STAGES if s in out.stages}
    return out


def takes_spans(runner) -> bool:
    """Whether the program's runner records spans (an older one does not)."""
    try:
        return "spans" in inspect.signature(runner.make_scan_body).parameters
    except (TypeError, ValueError):
        return False


class _WithSpans:
    """The runner as ``Program.run`` calls it, with a collector handed to
    the calls that take one."""

    def __init__(self, runner, spans):
        self._runner = runner
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def make_scan_body(self, *args, **kwargs):
        return self._runner.make_scan_body(*args, spans=self._spans,
                                           **kwargs)

    def init_carry(self, *args, **kwargs):
        return self._runner.init_carry(*args, spans=self._spans, **kwargs)

    def finish_run(self, *args, **kwargs):
        return self._runner.finish_run(*args, spans=self._spans, **kwargs)


def spans_pass(prog, keys, lanes, clock, sync) -> Optional[StageReading]:
    """The traced run's first episode again, with a collector, under the
    profiler's device activity: its stage reading, or None where the
    program takes no collector or runs on no card."""
    if prog.device.type != "cuda" or not takes_spans(prog.runner):
        return None
    from torch.profiler import ProfilerActivity, profile

    from paxi_tpu_torch.obs import SpanCollector
    spans = SpanCollector(node="sim", cap=(prog.rounds + 1) * 10 + 16)
    runner = prog.runner
    prog.runner = _WithSpans(runner, spans)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync()
            start = time.perf_counter()
            win = prog.run(keys, lanes, clock, max_episodes=1, first=0)
            sync()
            win.seconds = time.perf_counter() - start
    finally:
        prog.runner = runner
    spans.resolve()
    docs = spans.export()
    out = reduce(flat(prof.profiler.kineto_results.events()), docs)
    del prof
    round_ms = clock.gaps_ms(win.marks)
    out.extra = {"window_s": win.seconds, "rounds_run": win.rounds,
                 "round_ms_median": (statistics.median(round_ms)
                                     if round_ms else None),
                 "idle_pct": 100.0 * (1 - out.busy_ns / 1e9 / win.seconds),
                 "launches_per_round": out.device_ops / max(win.rounds, 1)}
    return out


def _harness() -> Optional[Dict]:
    """The locals of the harness's ``run_cell`` up the stack, or None."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "run_cell" and \
                f.f_code.co_filename.endswith("run.py") and \
                "prog" in f.f_locals:
            return f.f_locals
        f = f.f_back
    return None


def of(r) -> Optional[StageReading]:
    """The stage reading that goes with the traced run's reading ``r``:
    made once, by the first reader that asks, and printed as an
    information line beside the device pass's figures."""
    if "stage_reading" in vars(r):
        return r.stage_reading
    r.stage_reading = None
    h = _harness()
    if h is None or not all(k in h for k in ("keys", "lanes", "clock",
                                             "sync")):
        return None
    prog = h["prog"]
    try:
        got = spans_pass(prog, h["keys"], h["lanes"], h["clock"], h["sync"])
    except Exception:               # a traced run reports, it does not die
        print(json.dumps({"stages_error": traceback.format_exc()}),
              flush=True)
        return None
    if got is None:
        return None
    device_pass = {"device_ops": r.device_ops, "window_s": r.window_s,
                   "launches_per_round": r.device_ops / max(r.rounds, 1),
                   "idle_pct": (100.0 * (1 - r.busy_s / r.window_s)
                                if r.window_s > 0 else None)}
    win = h.get("win")
    if win is not None and getattr(win, "marks", None):
        gaps = h["clock"].gaps_ms(win.marks)
        device_pass["round_ms_median"] = (statistics.median(gaps)
                                          if gaps else None)
    got.extra["device_pass"] = device_pass
    r.stage_reading = got
    print(json.dumps(got.line()), flush=True)
    return got
