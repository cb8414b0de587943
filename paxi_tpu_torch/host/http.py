"""The client-facing REST API, on asyncio streams (stdlib only): the
port's copy of the JAX package's ``host/http.py``, same wire.

Reference: paxi node.go/http.go — ``GET /{key}`` reads, ``PUT|POST
/{key}`` writes (body = value); headers carry ClientID/CommandID; the
handler synthesizes a ``paxi.Request`` with a reply channel and waits;
admin endpoints expose the fault-injection surface (``/crash``,
``/drop``, …) and ``/history`` [high].

Pipelined serving: the old handler read one request per connection,
awaited the full consensus round, wrote the response, and only then
read the next — so one connection could never have more than one
command in flight, and the batched commit path starved.  Now the
reader loop keeps parsing requests and enqueues each response slot
(bytes, or a future the commit path resolves) onto a bounded
per-connection pipeline; a writeback coroutine writes responses in
request order, coalescing bursts into one ``write``+``drain`` (where a
send syscall is dear, ~50 µs under some virtualised kernels, coalescing
is worth several times on its own).  HTTP semantics are unchanged: ordered
responses, keep-alive, same status/headers.

Headers:
- request:  ``Client-Id``, ``Command-Id``, and arbitrary ``Property-*``
- response: ``Err`` (error string, body empty) on failure

Observability (metrics/):
- ``GET /metrics``              Prometheus text (counters + histograms)
- ``GET /metrics?format=json``  JSON snapshot of the same registry

Admin (AdminClient surface):
- ``POST /admin/crash?t=SECONDS``
- ``POST /admin/drop?id=ZONE.NODE&t=SECONDS``
- ``POST /admin/slow?id=..&delay=MS&t=SECONDS``
- ``POST /admin/flaky?id=..&p=0.5&t=SECONDS``
- ``GET  /admin/history?key=K`` (multi-version store dump)
"""

from __future__ import annotations

import asyncio
import collections
import json
import time
from typing import TYPE_CHECKING, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from paxi_tpu_torch.core.command import (MIG_KINDS, RESERVED_PREFIXES,
                                         Command, Request, pack_mig,
                                         pack_tpc)

if TYPE_CHECKING:
    from paxi_tpu_torch.host.node import Node

from paxi_tpu_torch.host.transport import parse_addr
from paxi_tpu_torch.obs import TRACE_PROP, TraceCtx, new_trace_id, \
    process_sampler


def _response(status: int, body: bytes = b"",
              headers: Optional[Dict[str, str]] = None) -> bytes:
    if status == 200 and not headers:
        # the KV hot path: one bytes-format, no list/join/encode
        return _OK_TMPL % len(body) + body
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              405: "Method Not Allowed",
              500: "Internal Server Error"}.get(status, "OK")
    head = [f"HTTP/1.1 {status} {reason}",
            f"Content-Length: {len(body)}",
            "Connection: keep-alive"]
    head += [f"{k}: {v}" for k, v in (headers or {}).items()]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


_OK_TMPL = (b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n"
            b"Connection: keep-alive\r\n\r\n")
_OK_EMPTY = _OK_TMPL % 0


async def read_request(reader: asyncio.StreamReader
                       ) -> Tuple[str, str, Dict[str, str], bytes]:
    """Parse one request: a single ``readuntil`` for the whole head
    (one await instead of one per header line), then the body."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        raise ConnectionError("closed") from e
    except asyncio.LimitOverrunError as e:
        raise ValueError("oversized request head") from e
    lines = head[:-4].decode().split("\r\n")   # one decode for the head
    method, path, _ = lines[0].split(" ", 2)
    headers: Dict[str, str] = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0"))
    body = await reader.readexactly(n) if n else b""
    return method, path, headers, body


class HTTPServer:
    # in-flight responses per connection before the reader stops
    # parsing (pipeline backpressure), and responses folded into one
    # write syscall at most
    PIPELINE_DEPTH = 1024
    COALESCE_MAX = 128
    REQUEST_TIMEOUT = 10.0

    def __init__(self, node: "Node"):
        self.node = node
        self._node_id = str(node.id)
        # head-based sampling happens HERE when this server is the
        # entry tier (obs/sample.py): one decide() per command, and a
        # command arriving with an upstream trace context (router-
        # sampled, Property-Trace) is never re-sampled
        self._sampler = process_sampler()
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # (deadline, response-slot) in deadline order, reaped by ONE
        # sweeper task (a per-request call_later can cost ~5 µs, a deque
        # append ~0.2 µs)
        self._timeouts: collections.deque = collections.deque()
        self._sweeper: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        _, host, port = parse_addr(self.node.cfg.http_addrs[self.node.id])
        self._server = await asyncio.start_server(self._serve, host, port)
        self._sweeper = asyncio.create_task(self._sweep_timeouts())

    async def stop(self) -> None:
        if self._sweeper:
            self._sweeper.cancel()
        if self._server:
            self._server.close()

    async def _sweep_timeouts(self) -> None:
        """Time out stuck fast-path requests in bulk: pop expired slots
        (and already-answered ones reaching the front) once a second."""
        dq = self._timeouts
        while True:
            await asyncio.sleep(1.0)
            now = self._loop.time()
            while dq and (dq[0][1].done() or dq[0][0] <= now):
                _, slot = dq.popleft()
                if not slot.done():
                    slot.set_result(_response(
                        500, b"", {"Err": "request timed out"}))

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        """Reader half of a connection: bulk-parse every complete
        request out of each received chunk (one ``read()`` can carry a
        whole pipelined burst) and enqueue response slots in order;
        _writeback ships them."""
        pending: asyncio.Queue = asyncio.Queue(maxsize=self.PIPELINE_DEPTH)
        wtask = asyncio.create_task(self._writeback(pending, writer))
        buf = bytearray()
        read = reader.read
        put = pending.put
        try:
            while True:
                chunk = await read(65536)
                if not chunk:
                    break
                buf += chunk
                blen = len(buf)
                pos = 0
                while True:
                    i = buf.find(b"\r\n\r\n", pos)
                    if i < 0:
                        break
                    n = self._content_length(buf, pos, i)
                    end = i + 4 + n
                    if end > blen:
                        break   # body not fully buffered yet
                    head = bytes(buf[pos:i])
                    body = bytes(buf[i + 4:end]) if n else b""
                    pos = end
                    slot = self._parse_fast(head, body)
                    if slot is None:
                        # slow path (admin/metrics/transaction/odd
                        # headers): resolved inline — ordered
                        # semantics, off the hot path
                        slot = await self._handle_slow(head, body)
                    await put(slot)
                if pos:
                    del buf[:pos]
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            await pending.put(None)
            await wtask
            writer.close()

    @staticmethod
    def _content_length(buf: bytearray, pos: int, i: int) -> int:
        """Body length from the head bytes in buf[pos:i] (the exact
        spelling our clients use, with a tolerant fallback)."""
        j = buf.find(b"Content-Length:", pos, i)
        if j >= 0:
            k = buf.find(b"\r\n", j, i)
            return int(buf[j + 15:k if k > 0 else i])
        j = bytes(buf[pos:i]).lower().find(b"content-length:")
        if j < 0:
            return 0
        rest = bytes(buf[pos + j + 15:i])
        k = rest.find(b"\r\n")
        return int(rest[:k if k > 0 else len(rest)])

    def _parse_fast(self, head: bytes, body: bytes):
        """The byte-exact hot shape — ``{GET|PUT|POST} /<int>
        HTTP/1.1`` with exactly Content-Length/Client-Id/Command-Id —
        parses with no decode, no dict, no strip.  None => slow path."""
        lines = head.split(b"\r\n")
        if len(lines) != 4:
            return None
        rl = lines[0]
        if rl[-9:] != b" HTTP/1.1" or \
                lines[1][:15] != b"Content-Length:" or \
                lines[2][:10] != b"Client-Id:" or \
                lines[3][:11] != b"Command-Id:":
            return None
        sp = rl.find(b" ")
        method = rl[:sp]
        if method not in (b"GET", b"PUT", b"POST") or \
                rl[sp + 1:sp + 2] != b"/":
            return None
        try:
            cmd_id = int(lines[3][11:])
        except ValueError:
            return None
        if rl[sp + 1:-9] == b"/transaction" and method == b"POST":
            return self._enqueue_txn(body,
                                     lines[2][10:].strip().decode(),
                                     cmd_id)
        try:
            key = int(rl[sp + 2:-9])
        except ValueError:
            return None   # /local/3, /metrics, ...
        value = body if method != b"GET" else b""
        if value.startswith(RESERVED_PREFIXES):
            return _response(400, b"", {"Err": "reserved value prefix"})
        return self._enqueue_kv(key, value,
                                lines[2][10:].strip().decode(), cmd_id)

    async def _handle_slow(self, head: bytes, body: bytes):
        """Generic parse + full router for everything the hot shape
        doesn't cover."""
        lines_s = head.decode().split("\r\n")
        method_s, path, _ = lines_s[0].split(" ", 2)
        headers: Dict[str, str] = {}
        for ln in lines_s[1:]:
            k, _, v = ln.partition(":")
            headers[k.strip().lower()] = v.strip()
        slot = self._route_fast(method_s, path, headers, body)
        if slot is None:
            slot = await self._route(method_s, path, headers, body)
        return slot

    async def _writeback(self, pending: asyncio.Queue,
                         writer: asyncio.StreamWriter) -> None:
        """Writer half: await each response slot in request order and
        write it, coalescing ready bursts into single syscalls."""
        out: list = []
        broken = False
        while True:
            slot = await pending.get()
            if slot is None:
                break
            if not isinstance(slot, bytes):
                if out and not slot.done():
                    # flush buffered responses before blocking on an
                    # unresolved commit, so they aren't held hostage
                    broken = await self._ship(writer, out) or broken
                slot = await slot
            out.append(slot)
            if len(out) >= self.COALESCE_MAX or pending.empty():
                broken = await self._ship(writer, out) or broken
        if out and not broken:
            await self._ship(writer, out)

    @staticmethod
    async def _ship(writer: asyncio.StreamWriter, out: list) -> bool:
        """Write+drain the buffered responses; True if the peer is gone
        (the writeback keeps consuming slots so the reader never blocks
        on a full pipeline)."""
        data = b"".join(out)
        out.clear()
        try:
            writer.write(data)
            await writer.drain()
            return False
        except (ConnectionError, OSError):
            return True

    def _route_fast(self, method: str, path: str,
                    headers: Dict[str, str], body: bytes):
        """The KV hot path (``GET|PUT|POST /{key}``), future-based: the
        response slot resolves when the commit pipeline executes the
        command — the reader loop never awaits it, so any number of
        commands from one connection ride the same batch.  Returns
        ``None`` for everything else (slow path)."""
        if "?" in path or method not in ("GET", "PUT", "POST"):
            return None
        part = path.strip("/")
        if part == "transaction" and method == "POST":
            props = {k[9:]: headers[k] for k in headers
                     if k[:9] == "property-"}
            return self._enqueue_txn(
                body, headers.get("client-id", ""),
                int(headers.get("command-id", "0")), props)
        if not part or "/" in part:
            return None
        try:
            key = int(part)
        except ValueError:
            return None
        value = body if method in ("PUT", "POST") else b""
        if value.startswith(RESERVED_PREFIXES):
            return _response(400, b"", {"Err": "reserved value prefix"})
        props = {}
        for k in headers:
            if k[:9] == "property-":
                props[k[9:]] = headers[k]
        return self._enqueue_kv(key, value,
                                headers.get("client-id", ""),
                                int(headers.get("command-id", "0")),
                                props)

    def _enqueue_kv(self, key: int, value: bytes, client_id: str,
                    command_id: int, props: Optional[dict] = None):
        """Dispatch one KV command into the commit pipeline; the
        returned future resolves to response bytes on execute."""
        loop = self._loop
        slot: asyncio.Future = loop.create_future()

        def reply_cb(rep, _slot=slot):
            if _slot.done():
                return
            if rep.err:
                _slot.set_result(_response(500, b"",
                                           {"Err": str(rep.err)}))
            elif rep.value:
                _slot.set_result(_OK_TMPL % len(rep.value) + rep.value)
            else:
                _slot.set_result(_OK_EMPTY)   # write ack: prebuilt

        sp = self._entry_span(props, "key", str(key))
        if sp is not None:
            props = dict(props or {})
            props[TRACE_PROP] = sp.child().encode()
            spans = self.node.spans
            slot.add_done_callback(
                lambda _s, _sp=sp: spans.finish(_sp))
        self._timeouts.append((loop.time() + self.REQUEST_TIMEOUT, slot))
        self.node.handle_client_request(Request(
            command=Command(key, value, client_id, command_id),
            properties=props or {}, timestamp=self.node.spans.now(),
            node_id=self._node_id, reply_to=reply_cb))
        return slot

    def _entry_span(self, props: Optional[dict], lk: str, lv: str):
        """Root or serve span for one inbound command: an upstream
        context (router-sampled) opens a ``serve`` child; otherwise the
        sampler decides once and a hit opens a ``request`` root.  None
        == unsampled (the common case: one dict lookup + one compare)."""
        tc = TraceCtx.decode(props.get(TRACE_PROP)) if props else None
        if tc is not None:
            return self.node.spans.start("serve", tc, **{lk: lv})
        if self._sampler.decide():
            return self.node.spans.start(
                "request", TraceCtx(new_trace_id()), **{lk: lv})
        return None

    def _enqueue_txn(self, body: bytes, client_id: str,
                     command_id: int, props: Optional[dict] = None):
        """Non-blocking Transaction dispatch (msg.go Transaction; see
        _transaction's docstring for semantics/caveats): the batch
        packs into ONE command/slot and the response slot resolves on
        execute — the connection's pipeline keeps flowing meanwhile,
        which is what makes client-side command batching (HT-Paxos's
        client half) compose with the leader's batch buffer."""
        from paxi_tpu_torch.core.command import (pack_transaction,
                                                 unpack_values)
        try:
            ops = json.loads(body.decode() or "[]")
            cmds = [Command(int(o["key"]),
                            o.get("value", "").encode("latin1"))
                    for o in ops]
            if not cmds:
                raise ValueError("empty transaction")
        except (ValueError, KeyError, TypeError) as e:
            return _response(400, b"", {"Err": repr(e)})
        if any(c.value.startswith(RESERVED_PREFIXES) for c in cmds):
            # a reserved-prefix op value would be re-dispatched by
            # execute_transaction as a 2PC/migration record on every
            # replica — same refusal as the KV surface
            return _response(400, b"", {"Err": "reserved value prefix"})
        loop = self._loop
        slot: asyncio.Future = loop.create_future()

        def reply_cb(rep, _slot=slot):
            if _slot.done():
                return
            if rep.err:
                _slot.set_result(_response(500, b"",
                                           {"Err": str(rep.err)}))
                return
            values = unpack_values(rep.value) if rep.value else []
            out = json.dumps(
                {"ok": True,
                 "values": [v.decode("latin1") for v in values]}).encode()
            _slot.set_result(_OK_TMPL % len(out) + out)

        sp = self._entry_span(props, "txn", str(len(cmds)))
        if sp is not None:
            props = dict(props or {})
            props[TRACE_PROP] = sp.child().encode()
            spans = self.node.spans
            slot.add_done_callback(
                lambda _s, _sp=sp: spans.finish(_sp))
        self._timeouts.append((loop.time() + self.REQUEST_TIMEOUT, slot))
        self.node.handle_client_request(Request(
            command=Command(cmds[0].key, pack_transaction(cmds),
                            client_id, command_id),
            properties=props or {}, timestamp=self.node.spans.now(),
            node_id=self._node_id, reply_to=reply_cb))
        return slot

    async def _route(self, method: str, path: str,
                     headers: Dict[str, str], body: bytes) -> bytes:
        url = urlparse(path)
        parts = [p for p in url.path.split("/") if p]
        if parts and parts[0] == "admin":
            return self._admin(method, parts[1:], parse_qs(url.query))
        if parts and parts[0] == "metrics":
            # observability scrape surface (metrics/):
            #   GET /metrics              Prometheus text exposition
            #   GET /metrics?format=json  JSON snapshot (same registry)
            if method != "GET":
                return _response(405, b"", {"Err": "GET only"})
            q = parse_qs(url.query)
            if q.get("format", [""])[0] == "json" or parts[1:] == ["json"]:
                body = json.dumps(self.node.metrics.snapshot()).encode()
                return _response(200, body,
                                 {"Content-Type": "application/json"})
            return _response(
                200, self.node.metrics.prometheus().encode(),
                {"Content-Type":
                 "text/plain; version=0.0.4; charset=utf-8"})
        if parts and parts[0] == "spans":
            # causal-span scrape surface (obs/): the finished-
            # span ring as JSON; ?clear=1 drains it (benches scrape
            # once per run).  The sibling of GET /metrics.
            if method != "GET":
                return _response(405, b"", {"Err": "GET only"})
            q = parse_qs(url.query)
            doc = {"node": self._node_id,
                   "spans": self.node.spans.export()}
            if q.get("clear", [""])[0] in ("1", "true"):
                self.node.spans.clear()
            return _response(200, json.dumps(doc).encode(),
                             {"Content-Type": "application/json"})
        if parts and parts[0] == "local" and len(parts) == 2:
            # msg.go Read: a raw non-linearized probe of the local store
            if method != "GET":
                return _response(405, b"", {"Err": "GET only"})
            try:
                return _response(200, self.node.db.get(int(parts[1])) or b"")
            except ValueError:
                return _response(400, b"", {"Err": "key must be an int"})
        if parts and parts[0] == "transaction":
            if method != "POST":
                return _response(405, b"", {"Err": "POST only"})
            return await self._transaction(headers, body)
        if parts and parts[0] == "tpc":
            # cross-shard 2PC record injection (shard router only; see
            # shard/txn.py).  The record is packed SERVER-side
            # from JSON, so the TPC_MAGIC encoding never crosses the
            # client surface — external KV values carrying it stay
            # rejected above.
            if method != "POST":
                return _response(405, b"", {"Err": "POST only"})
            return await self._tpc(body)
        if parts and parts[0] == "mig":
            # live-migration record injection (shard/migrate.py
            # coordinator only); packed server-side like /tpc so the
            # MIG_MAGIC encoding never crosses the client surface
            if method != "POST":
                return _response(405, b"", {"Err": "POST only"})
            return await self._mig(body)
        if len(parts) != 1:
            return _response(404)
        try:
            key = int(parts[0])
        except ValueError:
            return _response(400, b"", {"Err": "key must be an int"})

        value = body if method in ("PUT", "POST") else b""
        if value.startswith(RESERVED_PREFIXES):
            # the packed-transaction / 2PC-record encodings are
            # internal; a client value carrying either magic prefix
            # would be reinterpreted by the state machine at execute
            # time on every replica
            return _response(400, b"", {"Err": "reserved value prefix"})
        cmd = Command(key, value,
                      client_id=headers.get("client-id", ""),
                      command_id=int(headers.get("command-id", "0")))
        props = {k[len("property-"):]: v for k, v in headers.items()
                 if k.startswith("property-")}
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.node.handle_client_request(Request(
            command=cmd, properties=props, timestamp=self.node.spans.now(),
            node_id=str(self.node.id), reply_to=fut))
        try:
            rep = await asyncio.wait_for(fut, timeout=10.0)
        except asyncio.TimeoutError:
            return _response(500, b"", {"Err": "request timed out"})
        if rep.err:
            return _response(500, b"", {"Err": str(rep.err)})
        return _response(200, rep.value or b"")

    async def _transaction(self, headers: Dict[str, str],
                           body: bytes) -> bytes:
        """msg.go Transaction: a command batch packed into ONE command
        (command.py pack_transaction) and pushed through the protocol's
        normal Request path, so it replicates and totally orders like
        any write and applies atomically in Database.execute.  Batch
        ops with empty values are reads (db.go empty-value semantics).

        Ordering caveat: the packed command is sequenced under
        cmds[0].key's log/object/conflict set, so on multi-log
        protocols (kpaxos/wpaxos/epaxos) a cross-key batch orders
        atomically only against commands touching that first key; use
        single-log protocols (paxos/chain) for cross-key serializable
        batches."""
        from paxi_tpu_torch.core.command import (pack_transaction,
                                                 unpack_values)
        try:
            ops = json.loads(body.decode() or "[]")
            cmds = [Command(int(o["key"]),
                            o.get("value", "").encode("latin1"))
                    for o in ops]
            if not cmds:
                raise ValueError("empty transaction")
        except (ValueError, KeyError, TypeError) as e:
            return _response(400, b"", {"Err": repr(e)})
        if any(c.value.startswith(RESERVED_PREFIXES) for c in cmds):
            # see _enqueue_txn: batch ops are client values too
            return _response(400, b"", {"Err": "reserved value prefix"})
        cmd = Command(cmds[0].key, pack_transaction(cmds),
                      client_id=headers.get("client-id", ""),
                      command_id=int(headers.get("command-id", "0")))
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.node.handle_client_request(Request(
            command=cmd, timestamp=self.node.spans.now(),
            node_id=str(self.node.id), reply_to=fut))
        try:
            rep = await asyncio.wait_for(fut, timeout=10.0)
        except asyncio.TimeoutError:
            return _response(500, b"", {"Err": "transaction timed out"})
        if rep.err:
            return _response(500, b"", {"Err": str(rep.err)})
        # register-style protocols (abd) ack writes with an empty value
        values = unpack_values(rep.value) if rep.value else []
        out = {"ok": True, "values": [v.decode("latin1") for v in values]}
        return _response(200, json.dumps(out).encode())

    async def _tpc(self, body: bytes) -> bytes:
        """One 2PC record through the group's ordinary Request path:
        ``{"kind", "txid", "key", "ops"?, "outcome"?}`` packs into a
        TPC-record command on ``key`` (the group-local ordering
        anchor), replicates like any write, and the state machine's
        reply (vote / winning outcome / done) returns as the body."""
        try:
            doc = json.loads(body.decode() or "{}")
            if doc.get("kind") not in ("prepare", "decide", "commit",
                                       "abort") \
                    or not isinstance(doc.get("txid"), str):
                # a record unpack_tpc would reject at execute time
                # falls through to a plain write of a reserved-prefix
                # value — reject every such shape here instead
                raise ValueError(
                    f"bad 2pc record: kind={doc.get('kind')!r} "
                    f"txid={doc.get('txid')!r}")
            value = pack_tpc(
                doc["kind"], doc["txid"],
                ops=[(int(k), v.encode("latin1"))
                     for k, v in doc["ops"]] if "ops" in doc else None,
                outcome=doc.get("outcome", ""))
            key = int(doc.get("key", 0))
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            return _response(400, b"", {"Err": repr(e)})
        # participant-side span: the coordinator's record context rides
        # doc["trace"], so the group's replication of this record (and
        # its own batch/quorum/exec children) stitches into the one
        # cross-shard transaction tree
        sp = self.node.spans.start(
            "tpc", TraceCtx.decode(doc.get("trace")),
            record=doc["kind"], txid=doc["txid"])
        props = ({TRACE_PROP: sp.child().encode()} if sp is not None
                 else {})
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.node.handle_client_request(Request(
            command=Command(key, value), properties=props,
            timestamp=self.node.spans.now(),
            node_id=self._node_id, reply_to=fut))
        try:
            rep = await asyncio.wait_for(fut, timeout=10.0)
        except asyncio.TimeoutError:
            return _response(500, b"", {"Err": "2pc record timed out"})
        finally:
            self.node.spans.finish(sp)
        if rep.err:
            return _response(500, b"", {"Err": str(rep.err)})
        return _response(200, rep.value or b"")

    async def _mig(self, body: bytes) -> bytes:
        """One migration record through the group's ordinary Request
        path: ``{"kind", "mid", "key", "lo"?, "hi"?, "span"?,
        "items"?, "cursor"?, "limit"?}`` packs into a MIG-record
        command on ``key`` (the group-local ordering anchor),
        replicates like any write, and the epoch state machine's
        reply (open/done, an items chunk, fenced, ok/busy) returns as
        the body — so every epoch transition of a range handoff is
        one totally-ordered log entry (shard/migrate.py)."""
        try:
            doc = json.loads(body.decode() or "{}")
            if doc.get("kind") not in MIG_KINDS \
                    or not isinstance(doc.get("mid"), str):
                raise ValueError(
                    f"bad migration record: kind={doc.get('kind')!r} "
                    f"mid={doc.get('mid')!r}")
            value = pack_mig(
                doc["kind"], doc["mid"],
                lo=int(doc.get("lo", 0)), hi=int(doc.get("hi", 0)),
                span=int(doc.get("span", 0)),
                items=[(int(k), v.encode("latin1"))
                       for k, v in doc["items"]]
                if "items" in doc else None,
                cursor=int(doc.get("cursor", -1)),
                limit=int(doc.get("limit", 0)))
            key = int(doc.get("key", 0))
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            return _response(400, b"", {"Err": repr(e)})
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.node.handle_client_request(Request(
            command=Command(key, value),
            timestamp=self.node.spans.now(),
            node_id=self._node_id, reply_to=fut))
        try:
            rep = await asyncio.wait_for(fut, timeout=10.0)
        except asyncio.TimeoutError:
            return _response(500, b"", {"Err": "migration record "
                                               "timed out"})
        if rep.err:
            return _response(500, b"", {"Err": str(rep.err)})
        return _response(200, rep.value or b"")

    def _admin(self, method: str, parts, q) -> bytes:
        """Fault injection + introspection (AdminClient endpoints)."""
        sock = self.node.socket
        try:
            what = parts[0] if parts else ""
            if what == "crash":
                sock.crash(float(q["t"][0]))
            elif what == "drop":
                sock.drop(q["id"][0], float(q["t"][0]))
            elif what == "slow":
                sock.slow(q["id"][0], float(q["delay"][0]), float(q["t"][0]))
            elif what == "flaky":
                sock.flaky(q["id"][0], float(q["p"][0]), float(q["t"][0]))
            elif what == "history":
                key = int(q["key"][0])
                hist = [v.decode("latin1")
                        for v in self.node.db.history(key)]
                return _response(200, json.dumps(hist).encode())
            else:
                return _response(404)
            return _response(200)
        except (KeyError, ValueError, IndexError) as e:
            return _response(400, b"", {"Err": repr(e)})
