"""ABD atomic-register replica for the host (deployment) runtime.

Reference: paxi abd/ (abd.go, msg.go, replica.go) — a crash-only
**linearizable multi-writer register** built without consensus
[driver: "crash-only linearizable register"]:

- READ  = phase-1 query all replicas, wait for a majority of
  (timestamp, value) replies, pick the max timestamp; phase-2 *write
  back* that (ts, value) to a majority, then return the value.
- WRITE = phase-1 query a majority for the current max timestamp;
  phase-2 store (ts+1 with writer id as tiebreak, new value) at a
  majority, then ack the client.

Each op therefore runs two ``paxi.Quorum`` rounds (abd.go Get/Set).
The same protocol runs as a sim kernel in ``sim.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node

# (ts, writer_index) lexicographic pair — the (n, id) tag of the paper.
Tag = Tuple[int, int]
ZERO_TAG: Tag = (0, -1)


@register_message
@dataclass
class Query:
    """Phase-1 probe for a key's current (ts, writer, value)."""

    src: str
    tag: int          # op-local sequence number routing the reply
    key: int


@register_message
@dataclass
class QueryReply:
    src: str
    tag: int
    key: int
    ts: int
    writer: int
    value: bytes


@register_message
@dataclass
class Store:
    """Phase-2 write of (ts, writer, value) — read write-back or new write."""

    src: str
    tag: int
    key: int
    ts: int
    writer: int
    value: bytes


@register_message
@dataclass
class StoreReply:
    src: str
    tag: int


@dataclass
class _Op:
    """An in-flight client op (two quorum rounds)."""

    request: Request
    key: int
    is_read: bool
    phase: int                    # 1 = query round, 2 = store round
    quorum: Quorum
    max_ts: int = 0
    max_writer: int = -1
    max_value: bytes = b""


class ABDReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        # key -> (ts, writer, value); the register store (abd.go state)
        self.store: Dict[int, Tuple[int, int, bytes]] = {}
        self.ops: Dict[int, _Op] = {}
        self._seq = 0
        self.register(Request, self.handle_request)
        self.register(Query, self.handle_query)
        self.register(QueryReply, self.handle_query_reply)
        self.register(Store, self.handle_store)
        self.register(StoreReply, self.handle_store_reply)

    def _local(self, key: int) -> Tuple[int, int, bytes]:
        return self.store.get(key, (0, -1, b""))

    def _apply(self, key: int, ts: int, writer: int, value: bytes) -> None:
        """Install (ts, writer, value) if it beats the local tag."""
        cts, cw, _ = self._local(key)
        if (ts, writer) > (cts, cw):
            self.store[key] = (ts, writer, value)
            # mirror into the KV store on EVERY replica so /local/{key}
            # and Client.local_get see the register here too (dynamo
            # behaves the same); db.execute (not put) so a packed
            # /transaction batch unpacks and applies atomically
            self.db.execute(Command(key, value))

    # ---- client ops ----------------------------------------------------
    def handle_request(self, req: Request) -> None:
        self._seq += 1
        tag = self._seq
        op = _Op(request=req, key=req.command.key,
                 is_read=req.command.is_read(), phase=1,
                 quorum=Quorum(self.cfg.ids))
        self.ops[tag] = op
        # self-reply counts toward the quorum (broadcast excludes self)
        ts, w, v = self._local(op.key)
        op.quorum.ack(self.id)
        op.max_ts, op.max_writer, op.max_value = ts, w, v
        self.socket.broadcast(Query(str(self.id), tag, op.key))
        self._maybe_phase2(tag, op)

    # ---- phase 1 -------------------------------------------------------
    def handle_query(self, m: Query) -> None:
        ts, w, v = self._local(m.key)
        self.socket.send(ID(m.src),
                         QueryReply(str(self.id), m.tag, m.key, ts, w, v))

    def handle_query_reply(self, m: QueryReply) -> None:
        op = self.ops.get(m.tag)
        if op is None or op.phase != 1:
            return
        op.quorum.ack(ID(m.src))
        if (m.ts, m.writer) > (op.max_ts, op.max_writer):
            op.max_ts, op.max_writer, op.max_value = m.ts, m.writer, m.value
        self._maybe_phase2(m.tag, op)

    def _maybe_phase2(self, tag: int, op: _Op) -> None:
        if not op.quorum.majority():
            return
        op.phase = 2
        op.quorum = Quorum(self.cfg.ids)
        if op.is_read:
            # write-back of the max tag guarantees atomicity for readers
            ts, w, v = op.max_ts, op.max_writer, op.max_value
        else:
            ts = op.max_ts + 1
            w = self.cfg.index(self.id)
            v = op.request.command.value
        op.max_ts, op.max_writer, op.max_value = ts, w, v
        self._apply(op.key, ts, w, v)
        op.quorum.ack(self.id)
        self.socket.broadcast(Store(str(self.id), tag, op.key, ts, w, v))
        self._maybe_done(tag, op)

    # ---- phase 2 -------------------------------------------------------
    def handle_store(self, m: Store) -> None:
        self._apply(m.key, m.ts, m.writer, m.value)
        self.socket.send(ID(m.src), StoreReply(str(self.id), m.tag))

    def handle_store_reply(self, m: StoreReply) -> None:
        op = self.ops.get(m.tag)
        if op is None or op.phase != 2:
            return
        op.quorum.ack(ID(m.src))
        self._maybe_done(m.tag, op)

    def _maybe_done(self, tag: int, op: _Op) -> None:
        if not op.quorum.majority():
            return
        del self.ops[tag]
        cmd = op.request.command
        if op.is_read:
            op.request.reply(Reply(cmd, value=op.max_value))
        else:
            op.request.reply(Reply(cmd, value=b""))


def new_replica(id: ID, cfg: Config) -> ABDReplica:
    return ABDReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  Wire-level identity: the sim kernel's
# four mailbox planes are exactly the host runtime's four message
# classes, so sim witnesses project onto occurrence-indexed
# Socket.drop_next directives.
TRACE_MSG_MAP = {
    "query": "Query", "query_r": "QueryReply",
    "store": "Store", "store_r": "StoreReply",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    "store_ts":    "store",      # (ts, writer) tag half of the register
    "store_val":   "store",
    "op_read":     "is_read",    # in-flight op planes <-> _Op fields
    "op_key":      "request",
    "op_tag":      "tag",
    "op_ts":       "ts",
    "op_val":      "max_value",
    "acks":        "quorum",     # bit-packed ack mask <-> Quorum
    "best_ts":     "max_ts",
    "best_val":    "max_value",
    "op_snap":     "",  # linearizability-oracle snapshot at op start
    "op_age":      "",  # step-count phase timeout; host op GC is wall-clock
    "reads_done":  "",  # workload counters (metrics, not protocol state)
    "writes_done": "",
    "done_max_ts": "",  # atomicity-oracle bookkeeping
    "atomic_viol": "",  # invariant accumulator
}
