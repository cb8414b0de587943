"""Peer messaging with first-class fault injection.

Reference: paxi socket.go — ``Socket`` holds one lazily-dialed Transport
per peer from ``Config.Addrs``; ``Send(to, m)``, ``Broadcast(m)``,
``Multicast(zone, m)``, ``Recv()``; plus the fault-injection surface
consulted on every send: ``Crash(t)``, ``Drop(id, t)``, ``Slow(id,
delay, t)``, ``Flaky(id, p, t)`` [high].  The sim runtime's fuzz
schedule (sim/mailbox.py) is the vectorized generalization of exactly
this surface.
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import Codec
from paxi_tpu_torch.host.fabric import current_fabric
from paxi_tpu_torch.host.transport import Transport, listen, new_transport
from paxi_tpu_torch.metrics import Registry


@dataclass
class MsgMatcher:
    """A deterministic per-message fault: unlike the probabilistic
    Crash/Drop/Slow/Flaky windows (wall-clock, whole-edge), a matcher
    targets the n-th occurrence of a message TYPE on one edge — the
    primitive the trace subsystem needs to replay a sim-captured fault
    schedule ("drop the 2nd Grant for key 3 sent to 2.1") against the
    asyncio runtime, bit-for-bit repeatably."""

    to: ID
    msg_type: str              # message class name, e.g. "Grant"
    action: str                # "drop" | "delay"
    delay_s: float = 0.0       # for action == "delay"
    count: int = 1             # act on this many matching messages...
    skip: int = 0              # ...after letting this many pass
    key: Optional[int] = None  # further restrict to msg.key == key

    def matches(self, to: ID, msg: Any) -> bool:
        return (to == self.to
                and type(msg).__name__ == self.msg_type
                and (self.key is None
                     or getattr(msg, "key", None) == self.key))


class Socket:
    def __init__(self, id: ID, cfg: Config, codec: Optional[Codec] = None,
                 metrics: Optional[Registry] = None, fabric=None):
        self.id = ID(id)
        self.cfg = cfg
        self.codec = codec or Codec("pickle")
        # injected virtual-clock fabric (host/fabric.py): explicit, or
        # ambient via use_fabric() so Cluster can wire unmodified
        # replica factories into a replay.  When set, every send routes
        # through the fabric's logical clock and the fabric owns the
        # whole fault model — the wall-clock windows and matchers below
        # are bypassed.
        self.fabric = fabric if fabric is not None else current_fabric()
        # shared with the owning Node so sends/drops/faults land in the
        # same exported registry; standalone sockets get their own
        self.metrics = metrics if metrics is not None else Registry(
            node=str(self.id))
        # per-type send counters resolved once (send is a hot path;
        # drop/delay outcomes only occur under injected faults and pay
        # the registry lookup)
        self._out_counters: Dict[str, Any] = {}
        self.inbox: asyncio.Queue = asyncio.Queue()
        self._peers: Dict[ID, Transport] = {}
        self._server = None
        # fault-injection state (wall-clock expiry, like the reference's
        # time.AfterFunc timers)
        self._crashed_until = 0.0
        self._drop_until: Dict[ID, float] = {}
        self._slow: Dict[ID, tuple] = {}   # id -> (delay_s, until)
        self._flaky: Dict[ID, tuple] = {}  # id -> (p, until)
        self._matchers: List[MsgMatcher] = []  # trace-driven faults
        # seeded from the id STRING: hash(str) is PYTHONHASHSEED-
        # randomized per process, which reseeded the flaky-fault RNG
        # differently on every run
        self._rng = random.Random(str(self.id))

    # ---- lifecycle -----------------------------------------------------
    async def start(self) -> None:
        if self.fabric is not None:
            self.fabric.attach(str(self.id), self._deliver)
            return
        self._server = await listen(
            self.cfg.addrs[self.id], self._deliver, self.codec)

    def _deliver(self, msg: Any) -> None:
        if self.fabric is None:
            # live serving only: under a fabric the trace's fault
            # schedule owns crash windows — consulting the wall clock
            # here made fabric replays diverge when a crash window was
            # armed mid-replay
            if time.monotonic() < self._crashed_until:
                self.metrics.counter("paxi_msgs_recv_dropped_total",
                                     reason="crashed").inc()
                return  # crashed: receives suppressed too
        self.inbox.put_nowait(msg)

    async def recv(self) -> Any:
        return await self.inbox.get()

    async def close(self) -> None:
        if self.fabric is not None:
            self.fabric.detach(str(self.id))
        if self._server:
            self._server.close()
        for t in self._peers.values():
            await t.close()
        self._peers.clear()

    # ---- sending -------------------------------------------------------
    def send(self, to: ID, msg: Any) -> None:
        """Reference: socket.go Send — lazily dial, consult fault state,
        silently drop to crashed/dropped peers."""
        to = ID(to)
        mname = type(msg).__name__
        met = self.metrics
        out_total = self._out_counters.get(mname)
        if out_total is None:
            out_total = self._out_counters[mname] = met.counter(
                "paxi_msgs_out_total", type=mname)
        out_total.inc()
        if self.fabric is not None:
            # virtual-clock replay: the fabric sequences delivery and
            # applies the trace's fault schedule itself
            self.fabric.submit(str(self.id), str(to), msg)
            return
        now = time.monotonic()
        if now < self._crashed_until:
            met.counter("paxi_msgs_dropped_total", type=mname,
                        reason="crashed").inc()
            return
        if now < self._drop_until.get(to, 0.0):
            met.counter("paxi_msgs_dropped_total", type=mname,
                        reason="drop_window").inc()
            return
        act = self._consume_match(to, msg)
        if act == "drop":
            met.counter("paxi_msgs_dropped_total", type=mname,
                        reason="matcher").inc()
            return
        extra = act[1] if isinstance(act, tuple) else 0.0
        p, until = self._flaky.get(to, (0.0, 0.0))
        if now < until and self._rng.random() < p:
            met.counter("paxi_msgs_dropped_total", type=mname,
                        reason="flaky").inc()
            return
        t = self._peers.get(to)
        if t is None:
            if to not in self.cfg.addrs:
                met.counter("paxi_msgs_dropped_total", type=mname,
                            reason="unknown_peer").inc()
                return
            t = new_transport(self.cfg.addrs[to], self.codec,
                              self.cfg.buffer_size,
                              on_drop=self._count_queue_drop,
                              on_coalesce=self._count_coalesce)
            self._peers[to] = t
            asyncio.ensure_future(self._dial_then(to, t))
        delay, until = self._slow.get(to, (0.0, 0.0))
        delay = extra + (delay if now < until else 0.0)
        if delay > 0:
            met.counter("paxi_msgs_delayed_total", type=mname).inc()
            asyncio.get_event_loop().call_later(delay, t.send, msg)
        else:
            t.send(msg)

    def _count_queue_drop(self, msg: Any, reason: str) -> None:
        """Transport backpressure callback: an outbound queue shed a
        message.  Counted under the same drop counter as the fault
        surface so one scrape shows every loss cause."""
        self.metrics.counter("paxi_msgs_dropped_total",
                             type=type(msg).__name__, reason=reason).inc()

    def _count_coalesce(self, n: int) -> None:
        """Transport coalescing callback: ``n`` messages left in one
        wire frame (one length header + one write syscall)."""
        self.metrics.counter("paxi_msgs_coalesced_total").inc(n)
        self.metrics.counter("paxi_frames_coalesced_total").inc()

    async def _dial_then(self, to: ID, t: Transport) -> None:
        try:
            await t.dial()
        except (ConnectionError, OSError):
            # peer not up yet: forget the dead transport so the next
            # send() re-dials (messages queued meanwhile are dropped,
            # like sends to a down TCP peer in the reference)
            await t.close()
            if self._peers.get(to) is t:
                del self._peers[to]

    def broadcast(self, msg: Any) -> None:
        """Reference: socket.go Broadcast — send to all known peers."""
        for i in self.cfg.ids:
            if i != self.id:
                self.send(i, msg)

    def multicast(self, zone: int, msg: Any) -> None:
        """Reference: socket.go Multicast — zone-filtered broadcast."""
        for i in self.cfg.ids:
            if i != self.id and i.zone == zone:
                self.send(i, msg)

    # ---- deterministic trace-driven faults ------------------------------
    def _consume_match(self, to: ID, msg: Any):
        """Consult the matcher list on a send; first live matcher wins.
        Returns "drop", ("delay", seconds), or None.  Spent matchers
        (count exhausted) are pruned so the hot send path stays
        O(live directives) however many schedules this socket has
        replayed."""
        act = None
        for m in self._matchers:
            if m.count <= 0 or not m.matches(to, msg):
                continue
            if m.skip > 0:
                m.skip -= 1
                continue
            m.count -= 1
            act = "drop" if m.action == "drop" else ("delay", m.delay_s)
            break
        if act is not None:
            self._matchers = [m for m in self._matchers if m.count > 0]
        return act

    def add_matcher(self, m: MsgMatcher) -> None:
        self.metrics.counter("paxi_faults_injected_total",
                             kind="matcher").inc()
        self._matchers.append(m)

    def drop_next(self, to: ID, msg_type: str, count: int = 1,
                  skip: int = 0, key: Optional[int] = None) -> None:
        """Drop the next ``count`` messages of class ``msg_type`` sent to
        ``to`` (after letting ``skip`` matching ones through)."""
        self.add_matcher(MsgMatcher(ID(to), msg_type, "drop",
                                    count=count, skip=skip, key=key))

    def delay_next(self, to: ID, msg_type: str, delay_s: float,
                   count: int = 1, skip: int = 0,
                   key: Optional[int] = None) -> None:
        """Delay (reorder) the next ``count`` matching messages."""
        self.add_matcher(MsgMatcher(ID(to), msg_type, "delay",
                                    delay_s=delay_s, count=count,
                                    skip=skip, key=key))

    # ---- fault injection (socket.go Crash/Drop/Slow/Flaky) -------------
    def crash(self, t: float) -> None:
        self.metrics.counter("paxi_faults_injected_total",
                             kind="crash").inc()
        self._crashed_until = time.monotonic() + t

    def drop(self, to: ID, t: float) -> None:
        self.metrics.counter("paxi_faults_injected_total",
                             kind="drop").inc()
        self._drop_until[ID(to)] = time.monotonic() + t

    def slow(self, to: ID, delay_ms: float, t: float) -> None:
        self.metrics.counter("paxi_faults_injected_total",
                             kind="slow").inc()
        self._slow[ID(to)] = (delay_ms / 1000.0, time.monotonic() + t)

    def flaky(self, to: ID, p: float, t: float) -> None:
        self.metrics.counter("paxi_faults_injected_total",
                             kind="flaky").inc()
        self._flaky[ID(to)] = (p, time.monotonic() + t)
