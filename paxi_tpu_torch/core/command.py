"""Commands and client wire types.

Reference: paxi db.go (Key/Value/Command), msg.go (Request/Reply/Read/
Transaction, gob-registered in init()).  The host runtime serializes these
with ``paxi_tpu_torch.host.codec``; the sim runtime packs Command into int32
lanes (see protocols' ``sim.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

Key = int
Value = bytes


@dataclass
class Command:
    """Reference: db.go Command{Key, Value, ClientID, CommandID}."""

    key: Key
    value: Value = b""
    client_id: str = ""
    command_id: int = 0

    def is_read(self) -> bool:
        """Reference: db.go Command.IsRead() — empty value means read."""
        return len(self.value) == 0

    def is_write(self) -> bool:
        return not self.is_read()


@dataclass
class Request:
    """A client request as seen by a replica.

    Reference: msg.go Request{Command, Properties, Timestamp, NodeID, c}.
    The reply channel ``c`` is node-local in the reference; here it is an
    optional callable / asyncio.Future set by the host runtime and never
    serialized.
    """

    command: Command
    properties: dict = field(default_factory=dict)
    timestamp: float = 0.0
    node_id: str = ""
    reply_to: Optional[Any] = None  # asyncio.Future | callable, node-local

    def reply(self, reply: "Reply") -> None:
        if self.reply_to is None:
            return
        if callable(self.reply_to):
            self.reply_to(reply)
        else:  # asyncio.Future
            if not self.reply_to.done():
                self.reply_to.set_result(reply)

    def wire(self) -> dict:
        """Serializable form (reply channel stripped, like gob encoding)."""
        return {
            "command": {
                "key": self.command.key,
                "value": self.command.value,
                "client_id": self.command.client_id,
                "command_id": self.command.command_id,
            },
            "properties": self.properties,
            "timestamp": self.timestamp,
            "node_id": self.node_id,
        }

    @staticmethod
    def from_wire(d: dict) -> "Request":
        c = d["command"]
        return Request(
            command=Command(c["key"], c["value"], c["client_id"], c["command_id"]),
            properties=d.get("properties", {}),
            timestamp=d.get("timestamp", 0.0),
            node_id=d.get("node_id", ""),
        )


@dataclass
class Reply:
    """Reference: msg.go Reply{Command, Value, Err}."""

    command: Command
    value: Value = b""
    err: Optional[str] = None


TXN_MAGIC = b"\x00txn:"
# cross-shard 2PC records (shard/txn.py): prepare / decide /
# commit / abort ride the normal replication path as opaque command
# values, so the PARTICIPANT LOG of a distributed transaction *is*
# whatever consensus protocol the group runs — one ordered command per
# 2PC state transition, interpreted by Database._execute_tpc.
TPC_MAGIC = b"\x002pc:"
# live data migration records (shard/migrate.py): begin /
# read / install / start / cutover / done / drop ride each group's
# ordered log exactly like 2PC records, so every epoch transition of a
# range handoff is one totally-ordered log entry interpreted by
# Database._execute_mig — crash recovery is replaying the log.
MIG_MAGIC = b"\x00mig:"
# the reply marker a replica returns for a key it has RELEASED to a
# new owner group (post-cutover): never stored, only returned, so a
# stale router learns the range moved and reroutes instead of serving
# stale state or losing a write
MOVED_MAGIC = b"\x00moved:"
# every value prefix the KV surface must refuse from external clients
# (a client value carrying any magic would be reinterpreted by the
# state machine at execute time on every replica)
RESERVED_PREFIXES = (TXN_MAGIC, TPC_MAGIC, MIG_MAGIC)

MIG_KINDS = ("begin", "read", "install", "start", "cutover", "done",
             "drop")


def pack_mig(kind: str, mid: str, lo: int = 0, hi: int = 0,
             span: int = 0, items=None, cursor: int = -1,
             limit: int = 0) -> Value:
    """Encode one migration record as an opaque command value
    (shard/migrate.py epoch taxonomy; interpreted by
    ``Database._execute_mig``).  ``items`` is the install chunk:
    [(key, value), ...]."""
    import json
    doc: dict = {"kind": kind, "mid": mid}
    if hi:
        doc.update(lo=int(lo), hi=int(hi), span=int(span))
    if items is not None:
        doc["items"] = [[int(k), v.decode("latin1")] for k, v in items]
    if cursor >= 0:
        doc["cursor"] = int(cursor)
    if limit:
        doc["limit"] = int(limit)
    return MIG_MAGIC + json.dumps(doc).encode()


def unpack_mig(value: Value):
    """The migration record back out of a packed value, or None for
    plain/malformed values (poison-command safety, same contract as
    unpack_tpc)."""
    import json
    if not value.startswith(MIG_MAGIC):
        return None
    try:
        doc = json.loads(value[len(MIG_MAGIC):].decode())
        if doc["kind"] not in MIG_KINDS \
                or not isinstance(doc["mid"], str):
            return None
        if "items" in doc:
            doc["items"] = [(int(k), v.encode("latin1"))
                            for k, v in doc["items"]]
        return doc
    except (ValueError, TypeError, KeyError, AttributeError,
            UnicodeDecodeError):
        return None


def pack_tpc(kind: str, txid: str, ops=None, outcome: str = "") -> Value:
    """Encode one 2PC record as an opaque command value.

    ``kind``: ``prepare`` (stage ``ops`` = [(key, value), ...]; empty
    value = read), ``decide`` (durably fix ``outcome`` in {"c", "a"} —
    FIRST write wins, the reply reports the winner), ``commit`` /
    ``abort`` (apply / drop the stage).  The record replicates and
    totally orders like any write of the group it is sent to."""
    import json
    doc = {"kind": kind, "txid": txid}
    if ops is not None:
        doc["ops"] = [[int(k), v.decode("latin1")] for k, v in ops]
    if outcome:
        doc["outcome"] = outcome
    return TPC_MAGIC + json.dumps(doc).encode()


def unpack_tpc(value: Value):
    """The 2PC record back out of a packed value, or None for plain
    values.  Malformed payloads are None (poison-command safety, same
    contract as unpack_transaction)."""
    import json
    if not value.startswith(TPC_MAGIC):
        return None
    try:
        doc = json.loads(value[len(TPC_MAGIC):].decode())
        kind, txid = doc["kind"], doc["txid"]
        if kind not in ("prepare", "decide", "commit", "abort") \
                or not isinstance(txid, str):
            return None
        if "ops" in doc:
            doc["ops"] = [(int(k), v.encode("latin1"))
                          for k, v in doc["ops"]]
        return doc
    except (ValueError, TypeError, KeyError, AttributeError,
            UnicodeDecodeError):
        return None


def pack_transaction(commands) -> Value:
    """Encode a command batch as ONE opaque write value, so a
    Transaction rides the normal per-protocol replication path as a
    single totally-ordered command and applies atomically in
    Database.execute (db.py)."""
    import json
    return TXN_MAGIC + json.dumps(
        [[c.key, c.value.decode("latin1")] for c in commands]).encode()


def unpack_transaction(value: Value):
    """The batch back out of a packed value, or None for plain values.

    A malformed payload (e.g. a client-supplied value that merely
    starts with TXN_MAGIC and slipped past the HTTP guard) is treated
    as a plain write rather than raised: an uncaught decode error here
    would be a poison command crashing every replica at execute time.
    """
    import json
    if not value.startswith(TXN_MAGIC):
        return None
    try:
        batch = json.loads(value[len(TXN_MAGIC):].decode())
        return [Command(int(k), v.encode("latin1")) for k, v in batch]
    except (ValueError, TypeError, KeyError, AttributeError,
            UnicodeDecodeError):
        return None


def pack_values(values) -> Value:
    import json
    return json.dumps([v.decode("latin1") for v in values]).encode()


def unpack_values(payload: Value):
    import json
    return [v.encode("latin1") for v in json.loads(payload.decode())]


@dataclass
class Read:
    """Reference: msg.go Read{CommandID, Key} — a raw (non-linearized)
    read probe answered straight from a replica's local store."""

    command_id: int
    key: Key


@dataclass
class ReadReply:
    """Reference: msg.go ReadReply{CommandID, Value}."""

    command_id: int
    value: Value = b""


@dataclass
class Transaction:
    """Reference: msg.go Transaction{Commands, ClientID, CommandID,
    Timestamp} — a batch of commands applied atomically by the replica
    that executes it (paxi's transactions are a node/db-layer surface;
    protocols order the batch as one unit)."""

    commands: list = field(default_factory=list)   # List[Command]
    client_id: str = ""
    command_id: int = 0
    timestamp: float = 0.0


@dataclass
class TransactionReply:
    """Reference: msg.go TransactionReply{OK, CommandID, LeaderID,
    Timestamp}."""

    ok: bool
    command_id: int = 0
    leader_id: str = ""
    timestamp: float = 0.0
    values: list = field(default_factory=list)     # List[Value]
