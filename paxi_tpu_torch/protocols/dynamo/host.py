"""Dynamo-style eventually-consistent store for the host runtime.

Reference: the paxi lineage's dynamo/ package (SURVEY §2.2 "others") —
a quorum R/W store with NO consensus: any replica coordinates an op;
writes stamp a Lamport (counter, node) version, store locally, and
replicate to all peers, acking the client after W acknowledgements;
reads query all peers, wait for R replies, return the max-version value
and *read-repair* stale replicas.  W + R > N gives read-your-writes in
the failure-free case; conflicting concurrent writes resolve
last-writer-wins by version — weaker than ABD (which serializes through
two quorum phases) and exactly the contrast case the benchmark's
linearizability checker is expected to flag under concurrency.

The sim kernel (sim.py) checks the honest guarantees instead:
per-replica version monotonicity and eventual convergence.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

from paxi_tpu_torch.core.command import Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

Ver = Tuple[int, int]          # (lamport counter, node index)
ZERO: Ver = (0, -1)


@register_message
@dataclass
class RWrite:
    """Coordinator -> peers: replicate (key, version, value)."""

    src: str
    tag: int
    key: int
    counter: int
    node: int
    value: bytes


@register_message
@dataclass
class RWriteAck:
    src: str
    tag: int


@register_message
@dataclass
class RRead:
    src: str
    tag: int
    key: int


@register_message
@dataclass
class RReadReply:
    src: str
    tag: int
    key: int
    counter: int
    node: int
    value: bytes


@dataclass
class _Op:
    request: Request
    key: int
    is_read: bool
    quorum: Quorum
    best: Ver = ZERO
    best_value: bytes = b""
    reported: Dict[ID, Ver] = None  # per-responder versions (reads)
    done: bool = False              # replied to client; repair-only phase
    born: float = field(default_factory=time.monotonic)


class DynamoReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.store: Dict[int, Tuple[int, int, bytes]] = {}
        self.clock = 0
        self.ops: Dict[int, _Op] = {}
        self._seq = 0
        # W and R: majority each (W + R > N); the knob dynamo exposes
        self.W = cfg.n // 2 + 1
        self.R = cfg.n // 2 + 1
        # op GC runs on wall-clock age from a periodic timer (like the
        # epaxos recovery watchdog), not piggybacked on request arrivals
        # — otherwise ops wedged below quorum by a partition never get
        # their 'quorum timed out' reply once client traffic stops
        # (ADVICE r2 low)
        self.op_timeout = 1.0
        self.gc_interval = 0.25
        self.register(Request, self.handle_request)
        self.register(RWrite, self.handle_write)
        self.register(RWriteAck, self.handle_write_ack)
        self.register(RRead, self.handle_read)
        self.register(RReadReply, self.handle_read_reply)

    def _local(self, key: int) -> Tuple[int, int, bytes]:
        return self.store.get(key, (0, -1, b""))

    def _apply(self, key: int, counter: int, node: int, value: bytes) -> None:
        """Last-writer-wins merge by (counter, node) version."""
        c, n, _ = self._local(key)
        if (counter, node) > (c, n):
            self.store[key] = (counter, node, value)
            self.clock = max(self.clock, counter)
            self.db.put(key, value)

    async def start(self) -> None:
        await super().start()
        self._tasks.append(asyncio.create_task(self._gc_watchdog()))

    async def _gc_watchdog(self) -> None:
        """Expire aged ops: answered reads are kept only for straggler
        repair; ops wedged below quorum by crashed/partitioned peers get
        the 'quorum timed out' error even if client traffic has stopped."""
        while True:
            await asyncio.sleep(self.gc_interval)
            now = time.monotonic()
            stale = [t for t, op in self.ops.items()
                     if now - op.born > self.op_timeout]
            for t in stale:
                op = self.ops.pop(t)
                if not op.done:
                    op.request.reply(Reply(op.request.command,
                                           err="quorum timed out"))

    # ---- coordinator ---------------------------------------------------
    def handle_request(self, req: Request) -> None:
        self._seq += 1
        tag = self._seq
        key = req.command.key
        if req.command.is_read():
            op = _Op(req, key, True, Quorum(self.cfg.ids), reported={})
            self.ops[tag] = op
            c, n, v = self._local(key)
            op.best, op.best_value = (c, n), v
            op.reported[self.id] = (c, n)
            op.quorum.ack(self.id)
            self.socket.broadcast(RRead(str(self.id), tag, key))
            self._read_done(tag, op)
        else:
            self.clock += 1
            ver = (self.clock, self.cfg.index(self.id))
            self._apply(key, ver[0], ver[1], req.command.value)
            op = _Op(req, key, False, Quorum(self.cfg.ids))
            self.ops[tag] = op
            op.quorum.ack(self.id)
            self.socket.broadcast(RWrite(str(self.id), tag, key,
                                         ver[0], ver[1],
                                         req.command.value))
            self._write_done(tag, op)

    # ---- replication ---------------------------------------------------
    def handle_write(self, m: RWrite) -> None:
        self._apply(m.key, m.counter, m.node, m.value)
        self.socket.send(ID(m.src), RWriteAck(str(self.id), m.tag))

    def handle_write_ack(self, m: RWriteAck) -> None:
        op = self.ops.get(m.tag)
        if op is None or op.is_read:
            return
        op.quorum.ack(ID(m.src))
        self._write_done(m.tag, op)

    def _write_done(self, tag: int, op: _Op) -> None:
        if op.quorum.size() >= self.W:
            del self.ops[tag]
            op.request.reply(Reply(op.request.command, value=b""))

    # ---- reads + read repair -------------------------------------------
    def handle_read(self, m: RRead) -> None:
        c, n, v = self._local(m.key)
        self.socket.send(ID(m.src),
                         RReadReply(str(self.id), m.tag, m.key, c, n, v))

    def handle_read_reply(self, m: RReadReply) -> None:
        op = self.ops.get(m.tag)
        if op is None or not op.is_read:
            return
        src = ID(m.src)
        op.quorum.ack(src)
        op.reported[src] = (m.counter, m.node)
        newer = (m.counter, m.node) > op.best
        if newer:
            op.best, op.best_value = (m.counter, m.node), m.value
            if op.done:
                # newer version surfaced after the client reply: adopt it
                # locally so our own store is not the laggard
                self._apply(op.key, op.best[0], op.best[1], op.best_value)
        if op.done:
            # repair-only phase: the client is answered, but a straggler
            # that reports a stale version still gets the write-back —
            # exactly the laggards read repair exists to heal.  If the
            # straggler RAISED the best, everyone who reported the old
            # best is now stale too: re-repair them all.
            if newer:
                for peer in op.reported:
                    self._repair_peer(op, peer)
            else:
                self._repair_peer(op, src)
            if op.quorum.size() >= len(self.cfg.ids):
                del self.ops[m.tag]
            return
        self._read_done(m.tag, op)

    def _repair_peer(self, op: _Op, peer: ID) -> None:
        if peer != self.id and op.best > ZERO and op.reported[peer] < op.best:
            self.socket.send(peer, RWrite(
                str(self.id), 0, op.key, op.best[0], op.best[1],
                op.best_value))

    def _read_done(self, tag: int, op: _Op) -> None:
        if op.quorum.size() < self.R:
            return
        op.done = True
        if op.quorum.size() >= len(self.cfg.ids):
            del self.ops[tag]
        # read repair, targeted: only responders that reported a version
        # below the winner get the write-back (healthy clusters pay no
        # repair traffic).  The op stays alive (done=True) until all N
        # replies arrive so post-quorum stragglers are repaired too.
        if op.best > ZERO:
            self._apply(op.key, op.best[0], op.best[1], op.best_value)
            for peer in op.reported:
                self._repair_peer(op, peer)
        op.request.reply(Reply(op.request.command, value=op.best_value))


def new_replica(id: ID, cfg: Config) -> DynamoReplica:
    return DynamoReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  The sim models replication as one
# anti-entropy gossip plane; the host's replica-to-replica value
# propagation is RWrite, so a dropped gossip edge projects onto
# dropping the write replication on that edge (read-path traffic has
# no sim plane and stays unmapped on purpose).
TRACE_MSG_MAP = {
    "gossip": "RWrite",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    "ver_c": "store",   # (counter, node) version halves of the store tag
    "ver_n": "store",
    "writes": "",  # workload counter (metrics, not protocol state)
}
