"""Per-node span collector — a bounded ring of finished spans.

One collector per Node (and one on the shard router); writes are
append-only from the serving path and reads happen on scrape
(``GET /spans``) or direct export in in-proc benches, mirroring how the
metrics Registry is written hot and snapshotted cold.

Two API tiers:

- **value tier** (entry points, coordinator): ``start()`` returns the
  open :class:`Span` so the caller can thread ``span.child()`` into
  downstream properties and ``finish()`` it from a reply callback.

- **statement tier** (protocol code): ``open(key, kind, ctx)`` /
  ``close(key)`` / ``close_group(prefix)`` are keyed, return ``None``,
  and no-op when ``ctx is None`` — protocol handlers need no branches
  on span state, which is exactly what the PXO13x span-isolation lint
  family pins (span state is write-only from protocol code).

- **round tier** (the simulation's round loop, ``sim/runner.py``):
  ``episode(device)`` starts a trace, ``round(t, stage)`` opens a
  ``round`` span with its first ``stage``, ``stage(name)`` closes the
  open stage and opens the next at one boundary, ``end()`` closes what
  is open.  On a CUDA device each boundary also records an event on the
  current stream; ``resolve()``, once the caller has synced, labels
  every finished span with its device-clock milliseconds.  The loop
  calls none of these without a collector.

Clock: the collector resolves a virtual-clock fabric at construction
(explicit argument, else the ambient ``current_fabric()`` the same way
Socket does) and stamps ``float(fabric step)`` — deterministic and
byte-identical across replays of one schedule.  Without a fabric it
stamps ``time.perf_counter()``.  Span ids are a per-collector sequence
(``<node>-<n>``): under the fabric's single-settle scheduling they are
deterministic too, so a whole exported timeline replays identically.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Hashable, List, Optional, Tuple

from paxi_tpu_torch.host.fabric import current_fabric
from paxi_tpu_torch.obs.span import Span, TraceCtx


class _Run:
    """The round tier's state: the episode's trace, the open round and
    stage, and the CUDA event class when boundaries stamp the device."""

    __slots__ = ("ctx", "episode", "event", "round", "stage")

    def __init__(self, ctx: TraceCtx, episode: int, event: Any):
        self.ctx = ctx
        self.episode = episode
        self.event = event
        self.round: Optional[Span] = None
        self.stage: Optional[Span] = None


class SpanCollector:
    __slots__ = ("node", "cap", "fabric", "_done", "_open", "_seq",
                 "_run", "_episodes", "_events")

    def __init__(self, node: str = "", cap: int = 4096,
                 fabric: Any = None):
        self.node = node
        self.cap = cap
        self.fabric = fabric if fabric is not None else current_fabric()
        self._done: deque = deque(maxlen=cap)
        self._open: Dict[Hashable, Span] = {}
        self._seq = 0
        self._run: Optional[_Run] = None
        self._episodes = 0
        # span id -> [start event, end event, end boundary's host seconds]
        # of the round tier's spans
        self._events: Dict[str, List[Any]] = {}

    # ---- clock ---------------------------------------------------------
    def now(self) -> float:
        if self.fabric is not None:
            return self.fabric.clock()
        return time.perf_counter()

    def _new_sid(self) -> str:
        self._seq += 1
        return f"{self.node or 's'}-{self._seq}"

    # ---- value tier ----------------------------------------------------
    def start(self, kind: str, ctx: Optional[TraceCtx],
              **labels: str) -> Optional[Span]:
        """Open a span under ``ctx`` and hand it to the caller; None
        context (unsampled) -> None, and ``finish(None)`` is a no-op,
        so entry code stays branch-free too."""
        if ctx is None:
            return None
        return Span(trace=ctx.trace, sid=self._new_sid(),
                    parent=ctx.span, kind=kind, node=self.node,
                    t0=self.now(), labels=labels)

    def finish(self, span: Optional[Span]) -> None:
        if span is None:
            return
        span.t1 = self.now()
        self._done.append(span)

    # ---- statement tier (protocol code) --------------------------------
    def open(self, key: Hashable, kind: str, ctx: Optional[TraceCtx],
             **labels: str) -> None:
        """Keyed open; overwrites a stale span under the same key (a
        re-proposed slot restarts its quorum clock).  Bounded: beyond
        ``cap`` simultaneously-open spans, new opens are shed."""
        if ctx is None:
            return
        if len(self._open) >= self.cap and key not in self._open:
            return
        self._open[key] = Span(
            trace=ctx.trace, sid=self._new_sid(), parent=ctx.span,
            kind=kind, node=self.node, t0=self.now(), labels=labels)

    def close(self, key: Hashable) -> None:
        span = self._open.pop(key, None)
        if span is not None:
            span.t1 = self.now()
            self._done.append(span)

    def close_group(self, prefix: Tuple) -> None:
        """Close every open span whose tuple key starts with
        ``prefix`` — e.g. all per-request quorum spans of one slot on
        commit."""
        n = len(prefix)
        hits = [k for k in self._open
                if isinstance(k, tuple) and k[:n] == prefix]
        t = self.now()
        for k in hits:
            span = self._open.pop(k)
            span.t1 = t
            self._done.append(span)

    # ---- round tier (the simulation's round loop) ----------------------
    def episode(self, device: Any = None) -> None:
        """Start the trace of one episode: the round tier's spans share
        its id until the next call.  On a CUDA ``device`` every boundary
        also records an event on the current stream."""
        self.end()
        event = None
        if device is not None and str(device).startswith("cuda"):
            import torch
            event = torch.cuda.Event
        n = self._episodes
        self._episodes += 1
        self._run = _Run(TraceCtx(f"{self.node or 's'}-ep{n}"), n, event)

    def _boundary(self) -> Tuple[_Run, float, Any, float]:
        """``(run, t, event, cost)``: on the card the event is recorded
        first and ``t`` read after it, so ``t`` meets the record call's
        end on a profile's clock; ``cost`` is the host seconds the
        boundary took (the event's creation and record)."""
        run = self._run
        if run is None:
            self.episode()
            run = self._run
        if run.event is None:
            return run, self.now(), None, 0.0
        t_in = self.now()
        ev = run.event(enable_timing=True)
        ev.record()
        t = self.now()
        return run, t, ev, t - t_in

    def _begin(self, run: _Run, kind: str, parent: str, at: float, ev: Any,
               labels: Dict[str, str]) -> Span:
        span = Span(trace=run.ctx.trace, sid=self._new_sid(), parent=parent,
                    kind=kind, node=self.node, t0=at, labels=labels)
        if ev is not None:
            self._events[span.sid] = [ev, None, 0.0]
        return span

    def _end(self, span: Optional[Span], at: float, ev: Any,
             cost: float) -> None:
        if span is None:
            return
        span.t1 = at
        self._done.append(span)
        if ev is not None:
            self._events[span.sid][1:] = [ev, cost]

    def round(self, t: int, stage: str) -> None:
        """Open the span of round ``t`` and its first stage."""
        run, now, ev, cost = self._boundary()
        self._end(run.stage, now, ev, cost)
        self._end(run.round, now, ev, cost)
        run.round = self._begin(run, "round", "", now, ev,
                                {"t": str(t), "episode": str(run.episode)})
        run.stage = self._begin(run, "stage", run.round.sid, now, ev,
                                {"stage": stage})

    def stage(self, name: str) -> None:
        """Close the open stage and open ``name`` at the same boundary,
        inside the open round (at the episode's top level outside one)."""
        run, now, ev, cost = self._boundary()
        self._end(run.stage, now, ev, cost)
        parent = "" if run.round is None else run.round.sid
        run.stage = self._begin(run, "stage", parent, now, ev,
                                {"stage": name})

    def end(self) -> None:
        """Close the open stage and round, if any, at one boundary."""
        run = self._run
        if run is None or (run.stage is None and run.round is None):
            return
        run, now, ev, cost = self._boundary()
        self._end(run.stage, now, ev, cost)
        self._end(run.round, now, ev, cost)
        run.stage = run.round = None

    def resolve(self) -> None:
        """Label each finished round-tier span with its device-clock
        milliseconds (``device_ms``) from the events at its boundaries,
        and with the host microseconds its closing boundary took
        (``boundary_us``: the instrumentation's own cost inside it); the
        caller has synced the device first."""
        for span in self._done:
            evs = self._events.get(span.sid)
            if evs is not None and evs[1] is not None:
                span.labels["device_ms"] = str(evs[0].elapsed_time(evs[1]))
                span.labels["boundary_us"] = str(evs[2] * 1e6)
        self._events.clear()

    # ---- export --------------------------------------------------------
    def export(self) -> List[dict]:
        """Finished spans as JSON documents (open spans are excluded:
        a crash mid-phase leaves no half-truth in the timeline)."""
        return [s.to_json() for s in self._done]

    def clear(self) -> None:
        self._done.clear()
        self._open.clear()
        self._events.clear()
        self._run = None

    def __len__(self) -> int:
        return len(self._done)
