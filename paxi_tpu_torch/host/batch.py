"""Size- and time-bounded command batching for the host commit path.

HT-Paxos's lever (PAPERS.md): amortize ONE quorum round over a batch of
client commands.  The protocol module owns *what* a flush means (the
paxos host proposes one slot carrying the whole batch); this buffer owns
*when* — flush on whichever bound trips first:

- **size**: the buffer reached ``max_size`` commands (flushed inline,
  no scheduling latency);
- **tick** (``max_wait == 0``, the default): a ``call_soon`` flush
  fires on the next event-loop pass, so every command that arrived in
  the current burst of ready callbacks rides one batch and a lone
  command pays ~zero added latency;
- **timer** (``max_wait > 0``): a ``call_later`` ceiling for explicit
  latency/throughput trades (the classic "64 cmds / 2 ms" knob).

Under the virtual-clock fabric (host/fabric.py) wall timers never fire,
so replicas built on a fabric must use tick mode — the fabric's settle
phase runs ``call_soon`` callbacks, keeping replays deterministic.

Concurrency: the buffer owns a ``threading.Lock`` and is thereby
declared cross-thread shared — every mutation of buffer state happens
inside it, which paxi-lint's lockset analysis (PXC4xx) holds forever.
The flush callback swaps the batch out under the lock and runs the
protocol's flush function outside it (re-entrant adds during a flush
land in the next batch instead of deadlocking).
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Callable, List, Optional

from paxi_tpu_torch.metrics import Registry
from paxi_tpu_torch.obs import ctx_of


class BatchBuffer:
    """Accumulate items; hand them to ``flush_fn`` in arrival order."""

    def __init__(self, flush_fn: Callable[[List[Any]], None],
                 max_size: int = 64, max_wait: float = 0.0,
                 metrics: Optional[Registry] = None, spans=None,
                 **labels: str):
        """``labels`` become extra metric dimensions — the commit path
        uses none (its metric identity predates them), the forwarding
        path tags ``path="forward"`` so the two pipelines stay
        separable in /metrics.  ``spans`` (an obs.SpanCollector) makes
        residency observable: each *traced* item opens a ``batch`` span
        on add and closes it on flush — the batch-wait phase of the
        five-phase latency decomposition."""
        self._lock = threading.Lock()
        self._flush_fn = flush_fn
        self._spans = spans
        self._span_labels = dict(labels)
        self._items: List[Any] = []
        self._handle = None          # scheduled tick/timer flush
        self._loop = None            # cached on first add (one loop)
        self.max_size = max(int(max_size), 1)
        self.max_wait = float(max_wait)
        reg = metrics if metrics is not None else Registry()
        self._fill_hist = reg.histogram("paxi_batch_fill", **labels)
        self._cmds_total = reg.counter("paxi_batch_cmds_total", **labels)
        self._flush_counters = {
            cause: reg.counter("paxi_batch_flushes_total", cause=cause,
                               **labels)
            for cause in ("size", "tick", "timer", "drain")}

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def add(self, item: Any) -> None:
        """Append one item; flush inline on the size bound, else make
        sure a tick/timer flush is scheduled."""
        fire = False
        with self._lock:
            self._items.append(item)
            if len(self._items) >= self.max_size:
                fire = True
            elif self._handle is None:
                loop = self._loop
                if loop is None:
                    try:
                        loop = asyncio.get_running_loop()
                    except RuntimeError:
                        loop = False   # no loop (sync caller)
                    self._loop = loop
                if loop is False:
                    fire = True        # degrade to size-1 batches
                elif self.max_wait > 0:
                    self._handle = loop.call_later(
                        self.max_wait, self._flush, "timer")
                else:
                    self._handle = loop.call_soon(self._flush, "tick")
        if self._spans is not None:
            self._spans.open(("batch", id(item)), "batch",
                             ctx_of(item), **self._span_labels)
        if fire:
            self._flush("size")

    def drain(self) -> None:
        """Flush whatever is buffered right now (leadership loss,
        shutdown): the protocol's flush function decides what a batch
        means in the new state."""
        self._flush("drain")

    def _flush(self, cause: str) -> None:
        with self._lock:
            items, self._items = self._items, []
            handle, self._handle = self._handle, None
        if handle is not None:
            handle.cancel()   # no-op for the handle that fired us
        if not items:
            return
        if self._spans is not None:
            for it in items:
                self._spans.close(("batch", id(it)))
        self._flush_counters[cause].inc()
        self._cmds_total.inc(len(items))
        self._fill_hist.observe(float(len(items)))
        self._flush_fn(items)
