"""Wire codec for the host runtime.

Reference: paxi codec.go — a ``Codec`` wrapping ``encoding/gob`` where
every message type is registered in each package's ``init()``
(``gob.Register``).  Here: message classes register with
``register_message``; frames are ``[4-byte big-endian length][1-byte
codec id][type-tag][payload]``.  Two payload codecs:

- ``json``   — dataclass fields as JSON (bytes base64-encoded); language-
  agnostic, the default for interop.  Tuples are normalized to lists on
  the wire (message dataclasses should declare list fields).
- ``pickle`` — fastest Python-to-Python path (the gob analog: schema
  implicit, types must be registered to be constructible).  Decoding uses
  a restricted unpickler that only resolves registered message classes
  and their field types — a frame from the network can never trigger
  arbitrary-object construction.

Coalescing: a third frame kind, ``BATCH``, packs several already-encoded
frames into ONE wire frame (``encode_batch``), so a transport draining a
backed-up outbound queue pays one length header + one write syscall for
the whole burst instead of one per message.  ``decode_all`` is the
receive-side inverse: it yields every message in a body whichever kind
it is, so listeners handle plain and coalesced frames uniformly.

Trace-context pass-through contract (obs/): a sampled request's
context rides ``properties["trace"]`` on ``WireRequest`` — there is no
new wire frame for tracing.  Both codecs and BATCH coalescing must
round-trip a message's ``properties`` dict EXACTLY (str keys, str
values); ``roundtrip`` below is the helper the obs tests pin this with,
so a codec change that drops or reorders properties fails loudly
instead of silently orphaning span trees.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import json
import pickle
import struct
from typing import Any, Dict, Tuple, Type

_REGISTRY: Dict[str, Type] = {}
_TAGS: Dict[Type, str] = {}

_LEN = struct.Struct(">I")


def register_message(cls: Type, tag: str = "") -> Type:
    """gob.Register analog; usable as a decorator."""
    t = tag or cls.__name__
    _REGISTRY[t] = cls
    _TAGS[cls] = t
    return cls


def registered(tag: str) -> Type:
    return _REGISTRY[tag]


def _to_jsonable(v: Any) -> Any:
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if type(v) in _TAGS:  # nested registered message
            return {"__msg__": _TAGS[type(v)],
                    "f": {f.name: _to_jsonable(getattr(v, f.name))
                          for f in dataclasses.fields(v)}}
        return {f.name: _to_jsonable(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


def _from_jsonable(v: Any) -> Any:
    if isinstance(v, dict):
        if "__b64__" in v:
            return base64.b64decode(v["__b64__"])
        if "__msg__" in v:
            cls = _REGISTRY[v["__msg__"]]
            return cls(**{k: _from_jsonable(x) for k, x in v["f"].items()})
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


class _RestrictedUnpickler(pickle.Unpickler):
    """Only resolves registered message classes (and their modules'
    dataclass machinery) — network frames cannot name arbitrary types."""

    _SAFE = {("builtins", n) for n in
             ("dict", "list", "tuple", "set", "frozenset", "bytes",
              "bytearray", "complex")}

    def find_class(self, module: str, name: str):
        for cls in _REGISTRY.values():
            if cls.__module__ == module and cls.__qualname__ == name:
                return cls
        if (module, name) in self._SAFE:
            return getattr(__import__(module), name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a registered message type")


class Codec:
    """Encode/decode registered messages to/from framed bytes."""

    JSON, PICKLE, BATCH = 0, 1, 2

    def __init__(self, kind: str = "json"):
        self.kind = {"json": self.JSON, "pickle": self.PICKLE}[kind]

    def encode(self, msg: Any) -> bytes:
        cls = type(msg)
        if cls not in _TAGS:
            raise TypeError(f"message type {cls.__name__} not registered "
                            f"(call register_message, like gob.Register)")
        tag = _TAGS[cls].encode()
        if self.kind == self.PICKLE:
            payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        else:
            # top level is always the {"__msg__", "f"} wrapper
            payload = json.dumps(_to_jsonable(msg),
                                 separators=(",", ":")).encode()
        body = bytes([self.kind, len(tag)]) + tag + payload
        return _LEN.pack(len(body)) + body

    def encode_batch(self, msgs) -> bytes:
        """One frame holding many messages: ``[len][BATCH][sub-frame]*``
        where each sub-frame is a full ``encode()`` output (its own
        4-byte length included), so decode walks them with the same
        framing rules the stream layer uses."""
        body = bytes([self.BATCH]) + b"".join(
            self.encode(m) for m in msgs)
        return _LEN.pack(len(body)) + body

    def decode_all(self, body: bytes) -> list:
        """Every message in ``body`` — a 1-list for plain frames, the
        unpacked sub-frames for a BATCH frame (nested batches are not
        produced by encode_batch and not accepted here)."""
        if body[0] != self.BATCH:
            return [self.decode_body(body)]
        out, rest = [], body[1:]
        while rest:
            if len(rest) < 4:
                raise ValueError("truncated batch frame")
            n = _LEN.unpack(rest[:4])[0]
            sub = rest[4:4 + n]
            if len(sub) < n or sub[0] == self.BATCH:
                raise ValueError("malformed batch sub-frame")
            out.append(self.decode_body(sub))
            rest = rest[4 + n:]
        return out

    def decode_body(self, body: bytes) -> Any:
        kind, tlen = body[0], body[1]
        tag = body[2:2 + tlen].decode()
        payload = body[2 + tlen:]
        if kind == self.PICKLE:
            msg = _RestrictedUnpickler(io.BytesIO(payload)).load()
            if type(msg) is not _REGISTRY.get(tag):
                raise TypeError(f"decoded type != registered tag {tag!r}")
            return msg
        msg = _from_jsonable(json.loads(payload))
        if type(msg) is not _REGISTRY.get(tag):
            raise TypeError(f"decoded type != registered tag {tag!r}")
        return msg

    @staticmethod
    def frame_size(header: bytes) -> int:
        return _LEN.unpack(header)[0]


def encode_stream(codec: Codec, msg: Any) -> bytes:
    return codec.encode(msg)


def roundtrip(codec: Codec, *msgs: Any) -> list:
    """Encode ``msgs`` (BATCH-coalesced when several) and decode them
    back through the full framing path — the contract-pinning helper
    for pass-through fields like the obs trace context."""
    if len(msgs) == 1:
        frame = codec.encode(msgs[0])
    else:
        frame = codec.encode_batch(msgs)
    return codec.decode_all(frame[4:])


def decode_from(codec: Codec, buf: bytes) -> Tuple[Any, bytes]:
    """Decode one frame from buf; returns (msg | None, rest)."""
    if len(buf) < 4:
        return None, buf
    n = _LEN.unpack(buf[:4])[0]
    if len(buf) < 4 + n:
        return None, buf
    return codec.decode_body(buf[4:4 + n]), buf[4 + n:]


# Shared client wire types are registered here, the analog of msg.go's
# init() gob.Register calls (core/ cannot depend on host/).
def _register_core_types() -> None:
    from paxi_tpu_torch.core.command import (Command, Read, ReadReply, Reply,
                                       Transaction, TransactionReply)
    for cls in (Command, Reply, Read, ReadReply, Transaction,
                TransactionReply):
        register_message(cls)


_register_core_types()
