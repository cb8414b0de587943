"""Virtual-clock chan fabric: exact-order delivery for trace replay.

The host runtime's native fault surface is wall-clock windows
(socket.py Crash/Drop/Slow/Flaky) plus occurrence-indexed matchers —
good enough to *approximate* a sim schedule, but a recorded reorder
("this Grant arrived two rounds late, AFTER the Revoke") degrades to a
time smear that may or may not reproduce the interleaving.  This
module closes that gap: an in-process transport whose deliveries are
sequenced by a LOGICAL clock driven from a trace's per-step schedule
(trace/host.py ``SeqSchedule``), so the hunt engine (hunt/)
replays sim witnesses as exact delivery orders.

Model — one logical step of the fabric mirrors one lock-step round of
the sim runner (sim/runner._group_step):

1. messages due at this step are delivered into their destination
   sockets' inboxes (unless the destination is crashed this step);
2. per-step drivers fire (``on_step`` — workload generators, protocol
   tickers);
3. the event loop runs until QUIESCENT (every delivered message
   dispatched, every synchronous handler chain drained); sends made by
   handlers are stamped with the current step and scheduled
   ``1 + delay_steps`` steps out, exactly like the sim's delay wheel.

Sends consult the schedule the way the sim's exchange does: a crashed
source or severed edge drops at send time, a crashed destination drops
at delivery time, and occurrence-indexed ``SeqFault`` directives drop
or delay the n-th matching send of a message class on an edge.

Plumbing: ``Socket`` (host/socket.py) accepts an injected fabric —
explicitly or ambiently via ``use_fabric`` so ``Cluster`` can build
unmodified protocol replicas on top of it — and routes every send
through ``submit`` instead of dialing a transport; the fabric replaces
the socket's own wall-clock fault machinery entirely (it owns the
fault model during a replay).

Determinism: delivery order is (deliver_step, submission seq) — a heap
pop order that is a pure function of the submission order, which the
single-threaded event loop makes repeatable.  ``delivery_log`` records
every delivery for the fabric tests and for hunt report forensics.
"""

from __future__ import annotations

import asyncio
import heapq
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Callable, Dict, List, Optional, Tuple

_CURRENT: ContextVar[Optional["VirtualClockFabric"]] = ContextVar(
    "paxi_tpu_torch_fabric", default=None)


def current_fabric() -> Optional["VirtualClockFabric"]:
    """The ambient fabric new Sockets attach to (None outside replay)."""
    return _CURRENT.get()


@contextmanager
def use_fabric(fabric: "VirtualClockFabric"):
    """Make ``fabric`` ambient while constructing a cluster, so replica
    factories that only know ``(id, cfg)`` still wire their sockets
    into it."""
    token = _CURRENT.set(fabric)
    try:
        yield fabric
    finally:
        _CURRENT.reset(token)


class VirtualClockFabric:
    """In-process transport sequenced by a logical clock.

    ``sched`` is a ``trace.host.SeqSchedule`` (or None for a
    fault-free deterministic fabric — still useful: it makes an
    in-process cluster's delivery order repeatable)."""

    def __init__(self, sched=None, settle_rounds: int = 8):
        self.sched = sched
        self.step = 0
        self._heap: List[Tuple[int, int, str, str, Any]] = []
        self._seq = 0
        self._deliver: Dict[str, Callable[[Any], None]] = {}
        self._occ: Dict[Tuple[str, str, str], int] = {}
        self._on_step: List[Callable[[int], None]] = []
        # in-fabric consensus tier (switchnet/): when installed,
        # every submission passes the switch BEFORE any fault check —
        # mirroring the sim, where the kernel's switch planes observe
        # the raw outbox and masking happens downstream at the delay
        # wheel — and the tier's injections (votes, register reads)
        # ride the fabric's own return half-path: one logical step,
        # never subject to the schedule's edge faults
        self.switch = None
        # consecutive no-new-submission loop yields that count as
        # quiescence; >1 tolerates multi-hop wakeup chains (put_nowait
        # -> getter wakes -> handler awaits -> resumes)
        self._settle_rounds = settle_rounds
        self.stats = {"submitted": 0, "delivered": 0, "dropped_fault": 0,
                      "delayed_fault": 0, "dropped_crash": 0,
                      "dropped_cut": 0, "dropped_no_listener": 0}
        self.delivery_log: List[Tuple[int, str, str, str]] = []

    # ---- socket attachment ---------------------------------------------
    def attach(self, id: str, deliver: Callable[[Any], None]) -> None:
        self._deliver[str(id)] = deliver

    def detach(self, id: str) -> None:
        self._deliver.pop(str(id), None)

    def on_step(self, fn: Callable[[int], None]) -> None:
        """Register a per-step driver (fires after deliveries, before
        the settle — the fabric's analog of the sim's workload draw)."""
        self._on_step.append(fn)

    def clock(self) -> float:
        """The observability timestamp domain under replay: span
        collectors (obs/collect.py) stamp t0/t1 with the current
        logical step, so two replays of one schedule emit
        byte-identical span timelines."""
        return float(self.step)

    def install_switch(self, tier) -> None:
        """Interpose a switchnet ``SwitchTier`` on the wire (see
        ``__init__``; switchnet/switch.py)."""
        self.switch = tier

    # ---- the send path --------------------------------------------------
    def submit(self, src: str, dst: str, msg: Any) -> None:
        """Route one send through the virtual clock (Socket.send's
        fabric branch).  Synchronous: handlers run inside the settle
        phase of step t, so their sends are stamped with step t."""
        src, dst = str(src), str(dst)
        self.stats["submitted"] += 1
        t = self.step
        if self.switch is not None:
            # the switch sees the frame mid-flight (before any fault
            # masking — the sim's kernel-side switch observes the raw
            # outbox the same way) and may stamp it in place; its
            # injections deliver one step out on the return half-path
            for idst, imsg in self.switch.on_send(t, src, dst, msg):
                self._seq += 1
                heapq.heappush(self._heap,
                               (t + 1, self._seq, "switch", idst, imsg))
        extra = 0
        if self.sched is not None:
            # the sim masks crashed ENDPOINTS and severed edges at the
            # send step (wheel_insert's live mask), so the fabric does
            # too — a dst that crashes later still receives
            if self.sched.is_crashed(src, t) or self.sched.is_crashed(
                    dst, t):
                self.stats["dropped_crash"] += 1
                return
            if self.sched.is_cut(src, dst, t):
                self.stats["dropped_cut"] += 1
                return
            mt = type(msg).__name__
            key = (src, dst, mt)
            occ = self._occ.get(key, 0)
            self._occ[key] = occ + 1
            # standing per-edge WAN latency (scenario engine): every
            # DELIVERED send on the edge pays it, on top of any
            # per-occurrence fault delay below — mirroring the sim
            # where the zone matrix is the delay DISTRIBUTION, not an
            # event
            edge = self.sched.edge_extra(src, dst)
            f = self.sched.fault_for(src, dst, mt, occ)
            if f is not None and f.action == "drop":
                self.stats["dropped_fault"] += 1
                return
            if edge:
                extra += edge
                self.stats["edge_delayed"] = \
                    self.stats.get("edge_delayed", 0) + 1
            if f is not None:
                self.stats["delayed_fault"] += 1
                extra += f.delay_steps
        self._seq += 1
        heapq.heappush(self._heap, (t + 1 + extra, self._seq, src, dst,
                                    msg))

    # ---- the clock -------------------------------------------------------
    async def _settle(self) -> None:
        """Yield to the event loop until no task makes progress: every
        inbox put has woken its recv loop, every synchronous handler
        chain has drained, and no new sends arrived for
        ``settle_rounds`` consecutive yields."""
        idle = 0
        guard = 0
        while idle < self._settle_rounds:
            before = self._seq
            await asyncio.sleep(0)
            idle = idle + 1 if self._seq == before else 0
            guard += 1
            if guard > 10_000:   # a handler is live-looping; bail out
                raise RuntimeError(
                    "virtual-clock fabric could not settle "
                    f"(step {self.step}: sends never stopped)")

    async def run(self, n_steps: int, drain: bool = True) -> None:
        """Advance the clock through ``n_steps`` logical steps (the
        trace's horizon; step indices line up with the sim's 0-based
        steps, so a fault recorded at sim step t fires at fabric step
        t).  ``drain`` then keeps stepping until no deliveries remain
        in flight, so late-delayed messages land before the oracle
        reads the cluster."""
        end = self.step + n_steps    # drivers fire for steps [.., end)
        while self.step < end or (drain and self._heap):
            t = self.step        # re-read per iteration: the clock
            # register is the shared truth submit() stamps sends with,
            # so this loop never writes a pre-await snapshot back
            # 1. deliver everything due this step (sent at t-1-delay)
            while self._heap and self._heap[0][0] <= t:
                _, _, src, dst, msg = heapq.heappop(self._heap)
                deliver = self._deliver.get(dst)
                if deliver is None:
                    self.stats["dropped_no_listener"] += 1
                    continue
                self.stats["delivered"] += 1
                self.delivery_log.append((t, src, dst,
                                          type(msg).__name__))
                deliver(msg)
            # 2. per-step drivers (workload / protocol tickers)
            if t < end:
                for fn in self._on_step:
                    fn(t)
            # 3. drain the loop: handlers consume, their sends stamp t
            await self._settle()
            self.step += 1
