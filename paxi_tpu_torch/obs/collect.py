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


class SpanCollector:
    __slots__ = ("node", "cap", "fabric", "_done", "_open", "_seq")

    def __init__(self, node: str = "", cap: int = 4096,
                 fabric: Any = None):
        self.node = node
        self.cap = cap
        self.fabric = fabric if fabric is not None else current_fabric()
        self._done: deque = deque(maxlen=cap)
        self._open: Dict[Hashable, Span] = {}
        self._seq = 0

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

    # ---- export --------------------------------------------------------
    def export(self) -> List[dict]:
        """Finished spans as JSON documents (open spans are excluded:
        a crash mid-phase leaves no half-truth in the timeline)."""
        return [s.to_json() for s in self._done]

    def clear(self) -> None:
        self._done.clear()
        self._open.clear()

    def __len__(self) -> int:
        return len(self._done)
