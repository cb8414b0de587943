"""KPaxos replica for the host (deployment) runtime.

Reference: paxi kpaxos/ — statically key-partitioned Paxos: partition =
``key % N`` and each partition is owned by a fixed leader (sorted config
order) running an independent per-partition Paxos log; requests landing
on a non-owner are forwarded (node.go Forward).  The static-ownership
contrast case to wpaxos's dynamic object stealing.

With ownership fixed there are no elections and no ballot races: the
owner runs phase-2 only (accept/commit), which is exactly the
steady-state Multi-Paxos path.  The same protocol runs as a sim kernel
in ``sim.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.core.quorum import Quorum
from paxi_tpu_torch.host.codec import register_message
from paxi_tpu_torch.host.node import Node


@register_message
@dataclass
class KP2a:
    part: int
    slot: int
    key: int
    value: bytes
    client_id: str = ""
    command_id: int = 0


@register_message
@dataclass
class KP2b:
    part: int
    slot: int
    id: str


@register_message
@dataclass
class KP3:
    part: int
    slot: int
    key: int
    value: bytes
    client_id: str = ""
    command_id: int = 0


@dataclass
class Entry:
    command: Command
    commit: bool = False
    request: Optional[Request] = None
    quorum: Optional[Quorum] = None


class Partition:
    """One static-leader Paxos log (kpaxos's per-partition paxos.Paxos)."""

    def __init__(self):
        self.log: Dict[int, Entry] = {}
        self.slot = -1
        self.execute = 0


class KPaxosReplica(Node):
    def __init__(self, id: ID, cfg: Config):
        super().__init__(id, cfg)
        self.order = sorted(cfg.ids)
        self.parts: Dict[int, Partition] = {
            p: Partition() for p in range(len(self.order))}
        self.register(Request, self.handle_request)
        self.register(KP2a, self.handle_p2a)
        self.register(KP2b, self.handle_p2b)
        self.register(KP3, self.handle_p3)

    def partition_of(self, key: int) -> int:
        return key % len(self.order)

    def owner(self, part: int) -> ID:
        return self.order[part]

    # ---- client requests ----------------------------------------------
    def handle_request(self, req: Request) -> None:
        part = self.partition_of(req.command.key)
        owner = self.owner(part)
        if owner != self.id:
            self.forward(owner, req)
            return
        pt = self.parts[part]
        pt.slot += 1
        slot = pt.slot
        q = Quorum(self.cfg.ids)
        q.ack(self.id)
        c = req.command
        pt.log[slot] = Entry(c, request=req, quorum=q)
        self.socket.broadcast(KP2a(part, slot, c.key, c.value,
                                   c.client_id, c.command_id))
        if q.majority():  # single-replica cluster
            self._commit(part, slot)

    # ---- phase 2 -------------------------------------------------------
    def handle_p2a(self, m: KP2a) -> None:
        pt = self.parts[m.part]
        e = pt.log.get(m.slot)
        if e is None or not e.commit:
            req = e.request if e else None
            pt.log[m.slot] = Entry(Command(m.key, m.value, m.client_id,
                                           m.command_id), request=req)
        pt.slot = max(pt.slot, m.slot)
        self.socket.send(self.owner(m.part),
                         KP2b(m.part, m.slot, str(self.id)))

    def handle_p2b(self, m: KP2b) -> None:
        e = self.parts[m.part].log.get(m.slot)
        if e is not None and not e.commit and e.quorum is not None:
            e.quorum.ack(ID(m.id))
            if e.quorum.majority():
                self._commit(m.part, m.slot)

    def _commit(self, part: int, slot: int) -> None:
        e = self.parts[part].log[slot]
        e.commit = True
        c = e.command
        self.socket.broadcast(KP3(part, slot, c.key, c.value,
                                  c.client_id, c.command_id))
        self._exec(part)

    def handle_p3(self, m: KP3) -> None:
        pt = self.parts[m.part]
        e = pt.log.get(m.slot)
        req = e.request if e else None
        pt.log[m.slot] = Entry(Command(m.key, m.value, m.client_id,
                                       m.command_id), commit=True,
                               request=req)
        pt.slot = max(pt.slot, m.slot)
        self._exec(m.part)

    def _exec(self, part: int) -> None:
        pt = self.parts[part]
        while True:
            e = pt.log.get(pt.execute)
            if e is None or not e.commit:
                break
            value = self.db.execute(e.command)
            if e.request is not None:
                e.request.reply(Reply(e.command, value=value))
                e.request = None
            pt.execute += 1


def new_replica(id: ID, cfg: Config) -> KPaxosReplica:
    return KPaxosReplica(ID(id), cfg)


# sim mailbox name -> host message class, for the cross-runtime trace
# projection (trace/host.py).  Wire-level identity (cf. paxos/host.py):
# the partitioned phase-2 planes are the host's three message classes.
TRACE_MSG_MAP = {
    "p2a": "KP2a", "p2b": "KP2b", "p3": "KP3",
}

# sim state field -> host attribute, for the static parity check
# (analysis/parity.py PXS7xx).  Empty string = kernel-internal.
SIM_STATE_MAP = {
    "log_cmd":    "log",     # per-partition ring <-> _Part.log entries
    "log_commit": "log",
    "acks":       "quorum",  # leader ack bitmask <-> Entry.quorum
    "next_slot":  "slot",
    "kv":         "db",
    "base":       "",  # ring-window base: host logs are unbounded dicts
    "stuck":      "",  # frontier-stall retry counter (kernel-only)
}
