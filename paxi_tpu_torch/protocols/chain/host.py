"""Chain replication replica for the host (deployment) runtime.

Reference: paxi chain/ — a static chain ordered head -> ... -> tail over
the sorted node IDs [driver]: writes enter at the head, are applied and
propagated down the chain, and are acknowledged once the tail applies
them; reads are served at the tail (which is why the scheme is
linearizable: the tail's state is the committed prefix).  Requests
arriving at the wrong end are forwarded (node.go Forward).

Batched commit path (HT-Paxos, PAPERS.md — the same lever as the paxos
host's, reusing ``BatchBuffer``): the head accumulates
write requests and ONE chain descent carries the whole batch — a
``Propagate`` holds a command *list* under one sequence number, every
link applies it atomically in order, and the tail's single ``Ack``
fans replies out to every client in the batch.  Batch atomicity rides
on message atomicity: a link either receives the entire batch or
nothing, so no fault schedule can apply half a batch.

The same protocol runs as a sim kernel in ``sim.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.host.batch import BatchBuffer
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


@register_message
@dataclass
class Propagate:
    """A write batch travelling down the chain (chain/ Propagate msg,
    generalized to a command list under one sequence number)."""

    seq: int
    # [[key, value, client_id, command_id], ...] — wire-friendly lists
    cmds: list = field(default_factory=list)


@register_message
@dataclass
class Ack:
    """Tail -> head: the write at ``seq`` reached the end of the chain."""

    seq: int


class ChainReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        order = sorted(cfg.ids)
        self.chain = order
        self.pos = order.index(self.id)
        self.head = order[0]
        self.tail = order[-1]
        self.succ: Optional[ID] = (
            order[self.pos + 1] if self.pos + 1 < len(order) else None)
        self.seq = 0            # head: last assigned; others: last applied
        # head: seq -> the batch's client requests
        self.pending: Dict[int, List[Request]] = {}
        self.buffer: Dict[int, Propagate] = {}  # out-of-order propagates
        # the batched commit path: head-side write accumulation; wall
        # timers never fire under the virtual-clock fabric, so a
        # fabric-driven replica is forced onto tick flushes.  The head
        # is static (order[0], no elections), so only it carries the
        # buffer — non-head replicas would just export dead
        # paxi_batch_* series
        if self.id == self.head:
            self.batch = BatchBuffer(
                self._flush_batch, max_size=cfg.batch_size,
                max_wait=0.0 if self.socket.fabric is not None
                else cfg.batch_wait,
                metrics=self.metrics)
        self.register(Request, self.handle_request)
        self.register(Propagate, self.handle_propagate)
        self.register(Ack, self.handle_ack)

    def is_head(self) -> bool:
        return self.id == self.head

    def is_tail(self) -> bool:
        return self.id == self.tail

    # ---- client requests ----------------------------------------------
    def handle_request(self, req: Request) -> None:
        if req.command.is_read():
            # reads at the tail (committed prefix)
            if self.is_tail():
                value = self.db.execute(req.command)
                req.reply(Reply(req.command, value=value))
            else:
                self.forward(self.tail, req)
            return
        # writes batch at the head: one descent per burst
        if not self.is_head():
            self.forward(self.head, req)
            return
        self.batch.add(req)

    def _flush_batch(self, reqs: List[Request]) -> None:
        """BatchBuffer flush: ONE sequence number (hence one descent
        and one tail Ack) carries every write of the burst."""
        self.seq += 1
        self.pending[self.seq] = list(reqs)
        for r in reqs:
            self.db.execute(r.command)
        if self.succ is None:       # single-node chain: head == tail
            self._ack(self.seq)
        else:
            self.socket.send(self.succ, Propagate(
                self.seq,
                [[r.command.key, r.command.value, r.command.client_id,
                  r.command.command_id] for r in reqs]))

    # ---- down the chain ------------------------------------------------
    def handle_propagate(self, m: Propagate) -> None:
        if m.seq <= self.seq:
            return              # duplicate of an already-applied batch
        self.buffer[m.seq] = m
        # apply strictly in sequence order (TCP is FIFO per edge, but a
        # restarted link may reorder across reconnects — buffer defends)
        while self.seq + 1 in self.buffer:
            m = self.buffer.pop(self.seq + 1)
            self.seq += 1
            for k, v, cid, cmid in m.cmds:
                self.db.execute(Command(int(k), v, cid, int(cmid)))
            if self.is_tail():
                self.socket.send(self.head, Ack(m.seq))
            else:
                self.socket.send(self.succ, m)

    # ---- back to the head ----------------------------------------------
    def handle_ack(self, m: Ack) -> None:
        self._ack(m.seq)

    def _ack(self, seq: int) -> None:
        for req in self.pending.pop(seq, []):
            req.reply(Reply(req.command, value=b""))


def new_replica(id: ID, cfg: Config) -> ChainReplica:
    return ChainReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  The sim's ``rep`` plane is its go-back-N
# retransmit channel for the SAME wire message a ``prop`` carries, so
# both project onto Propagate; dropping either in the sim is dropping a
# Propagate on the host.
TRACE_MSG_MAP = {
    "prop": "Propagate", "rep": "Propagate", "ack": "Ack",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    "log_key":    "chain",   # slot-ring planes <-> the chain list
    "log_val":    "chain",
    "applied":    "pos",     # in-order applied prefix <-> chain position
    "committed":  "head",    # known tail-applied <-> head bookkeeping
    "known_succ": "succ",    # successor progress <-> successor link
    "seen_succ":  "succ",
    "kv":         "db",
    "stall":      "",  # retransmit ticks: host retries are wall-clock
    "reads_done": "",  # workload counter (metrics, not protocol state)
    # on-device observability
    # — measurement planes, excluded from the trace witness hash; the
    # host twins are the registry's live latency histograms and the
    # post-hoc linearizability checker
    "m_prop_t":      "",
    "m_lat_hist":    "",
    "m_lat_sum":     "",
    "m_inscan_viol": "",
}
