"""Client library: REST KV client + admin (fault-injection) client.

Reference: paxi client.go — ``Client.Get(Key)`` / ``Put(Key, Value)``
over HTTP to ``HTTPAddrs[id]``, with retry against other replicas when
the contacted one fails, and ``AdminClient`` wrapping the fault-
injection endpoints [high].  Stdlib-only asyncio implementation with one
keep-alive connection per contacted node.
"""

from __future__ import annotations

import asyncio
import collections
import json
from typing import Dict, Optional, Tuple

from paxi_tpu_torch.core.command import Key, Value
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.http import read_request  # noqa: F401 (API symmetry)
from paxi_tpu_torch.host.transport import parse_addr
from paxi_tpu_torch.metrics import Registry


class _Conn:
    """One keep-alive connection, pipelining-capable.

    ``submit`` queues a request and returns a future; ``flush`` ships
    every queued request in one write; a reader task matches responses
    to futures in order (the server guarantees ordered responses).
    ``request`` is the sequential submit+flush+await convenience the
    closed-loop client uses — same wire behavior as before, but any
    number of submits may now be in flight at once, which is what lets
    the open-loop generator fill the server's commit batches."""

    def __init__(self, url: str):
        self.url = url
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self._waiters: collections.deque = collections.deque()
        self._outbuf: list = []
        self._rt: Optional[asyncio.Task] = None
        self._loop = None   # cached: get_running_loop can cost ~8 µs

    async def ensure(self) -> None:
        if self.writer is not None and not self.writer.is_closing():
            return
        self._loop = asyncio.get_running_loop()
        _, host, port = parse_addr(self.url)
        reader, writer = await asyncio.open_connection(host, port)
        if self.writer is not None and not self.writer.is_closing():
            # lost a concurrent ensure(): while this dial was in
            # flight another task installed a healthy connection —
            # adopting ours would orphan that pipeline's waiters and
            # leak its socket, so keep the winner (PXA901's
            # check-then-act race, re-validated after the await)
            writer.close()
            return
        if self._rt is not None:
            self._rt.cancel()
        # a reconnect abandons the old pipeline: every displaced
        # waiter must FAIL (not hang) — callbacks fire so callers'
        # in-flight accounting stays balanced
        self._fail_waiters(IOError("connection replaced"))
        self._waiters = collections.deque()
        self._outbuf = []
        self.reader, self.writer = reader, writer
        self._rt = asyncio.create_task(
            self._read_loop(reader, self._waiters))

    def _fail_waiters(self, err: Exception) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if callable(w):
                w(0, {}, b"", err)
            elif not w.done():
                w.set_exception(err)

    def submit(self, method: str, path: str, headers: Dict[str, str],
               body: bytes) -> "asyncio.Future[Tuple[int, Dict, bytes]]":
        """Queue one pipelined request (call ensure() first); the
        returned future resolves with (status, headers, payload)."""
        fut = self._loop.create_future()
        self.submit_cb(method, path, headers, body, None, fut)
        return fut

    def submit_cb(self, method: str, path: str, headers: Dict[str, str],
                  body: bytes, cb, fut=None) -> None:
        """Future-free pipelined submit: ``cb(status, resp_headers,
        payload, exc)`` runs straight from the reader task — the
        open-loop generator's path (a future costs ~4 scheduler hops
        per op; a callback costs none)."""
        head = [f"{method} {path} HTTP/1.1",
                f"Content-Length: {len(body)}"]
        head += [f"{k}: {v}" for k, v in headers.items()]
        self.submit_raw(
            ("\r\n".join(head) + "\r\n\r\n").encode() + body,
            cb if cb is not None else fut)

    def submit_raw(self, frame: bytes, waiter) -> None:
        """Cheapest submit: the caller built the request bytes (e.g.
        from a ``b"..." %`` template); one append per op."""
        self._outbuf.append(frame)
        self._waiters.append(waiter)

    @property
    def pending_out(self) -> int:
        return len(self._outbuf)

    async def flush(self) -> None:
        """One write+drain for every request queued since the last
        flush (syscall coalescing, the client half)."""
        if self._outbuf and self.writer is not None:
            data = b"".join(self._outbuf)
            self._outbuf = []
            self.writer.write(data)
            await self.writer.drain()

    @property
    def inflight(self) -> int:
        return len(self._waiters)

    async def _read_loop(self, reader: asyncio.StreamReader,
                         waiters: collections.deque) -> None:
        try:
            while True:
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError as e:
                    raise ConnectionError("closed") from e
                # status from the fixed "HTTP/1.1 NNN ..." offset; a
                # full header parse only off the byte-exact hot shape
                status = int(head[9:12])
                resp_headers: Dict[str, str] = {}
                n = 0
                for ln in head[:-4].split(b"\r\n")[1:]:
                    if ln[:15] == b"Content-Length:":
                        n = int(ln[15:])
                    else:
                        k, _, v = ln.decode().partition(":")
                        resp_headers[k.strip().lower()] = v.strip()
                payload = await reader.readexactly(n) if n else b""
                if waiters:
                    w = waiters.popleft()
                    if callable(w):
                        w(status, resp_headers, payload, None)
                    elif not w.done():
                        w.set_result((status, resp_headers, payload))
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # connection gone: fail every in-flight request so callers
            # can retry against another replica
            err = IOError(f"connection lost: {e!r}")
            while waiters:
                w = waiters.popleft()
                if callable(w):
                    w(0, {}, b"", err)
                elif not w.done():
                    w.set_exception(err)

    async def request(self, method: str, path: str,
                      headers: Dict[str, str], body: bytes
                      ) -> Tuple[int, Dict[str, str], bytes]:
        await self.ensure()
        fut = self.submit(method, path, headers, body)
        await self.flush()
        return await fut

    def close(self) -> None:
        if self._rt is not None:
            self._rt.cancel()
            self._rt = None
        self._fail_waiters(IOError("connection closed"))
        if self.writer:
            self.writer.close()
            self.writer = None


class Client:
    """Async KV client.  ``id`` picks the initially-contacted replica
    (clients usually talk to their own zone's node, client.go)."""

    def __init__(self, cfg: Config, id: Optional[ID] = None,
                 client_id: str = "c1",
                 metrics: Optional[Registry] = None):
        self.cfg = cfg
        self.id = ID(id) if id else cfg.ids[0]
        self.client_id = client_id
        self.command_id = 0
        self._conns: Dict[ID, _Conn] = {}
        # optional: a caller-owned registry (the benchmark passes its
        # own so per-op counters and retries aggregate per run)
        self.metrics = metrics

    def _conn(self, id: ID) -> _Conn:
        if id not in self._conns:
            self._conns[id] = _Conn(self.cfg.http_addrs[id])
        return self._conns[id]

    async def _rest(self, id: ID, method: str, key: Key, value: Value
                    ) -> Value:
        self.command_id += 1
        status, headers, payload = await self._conn(id).request(
            method, f"/{key}",
            {"Client-Id": self.client_id,
             "Command-Id": str(self.command_id)},
            value)
        if status != 200:
            raise IOError(headers.get("err", f"http {status}"))
        return payload

    async def _with_retry(self, method: str, key: Key, value: Value) -> Value:
        """Try own node first, then every other replica (client.go retry)."""
        last: Exception = IOError("no nodes configured")
        first = True
        for id in [self.id] + [i for i in self.cfg.ids if i != self.id]:
            if id not in self.cfg.http_addrs:
                continue
            if not first and self.metrics is not None:
                self.metrics.counter("paxi_client_retries_total",
                                     client=self.client_id).inc()
            first = False
            try:
                out = await self._rest(id, method, key, value)
                if self.metrics is not None:
                    self.metrics.counter("paxi_client_ops_total",
                                         client=self.client_id,
                                         method=method).inc()
                return out
            except (IOError, OSError, asyncio.IncompleteReadError) as e:
                self._conns.pop(id, None)
                last = e
        if self.metrics is not None:
            self.metrics.counter("paxi_client_errors_total",
                                 client=self.client_id).inc()
        raise last

    async def get(self, key: Key) -> Value:
        return await self._with_retry("GET", key, b"")

    async def put(self, key: Key, value: Value) -> None:
        await self._with_retry("PUT", key, value)

    async def local_get(self, key: Key, id: Optional[ID] = None) -> Value:
        """msg.go Read: raw non-linearized read of one replica's store."""
        status, headers, payload = await self._conn(ID(id) if id else
                                                    self.id).request(
            "GET", f"/local/{key}", {}, b"")
        if status != 200:
            raise IOError(headers.get("err", f"http {status}"))
        return payload

    async def spans(self, id: Optional[ID] = None,
                    clear: bool = False) -> list:
        """Scrape one node's span export (``GET /spans``) — the raw
        per-node list; callers stitch fleet-wide views with
        ``obs.merge`` / ``obs.trees``."""
        path = "/spans?clear=1" if clear else "/spans"
        status, headers, payload = await self._conn(ID(id) if id else
                                                    self.id).request(
            "GET", path, {}, b"")
        if status != 200:
            raise IOError(headers.get("err", f"http {status}"))
        return json.loads(payload.decode())["spans"]

    async def spans_all(self, clear: bool = False) -> list:
        """Every configured node's spans, merged into one canonically
        ordered list (obs.stitch.merge)."""
        from paxi_tpu_torch.obs import merge
        lists = []
        for i in self.cfg.ids:
            if i not in self.cfg.http_addrs:
                continue
            try:
                lists.append(await self.spans(i, clear=clear))
            except (IOError, OSError):
                pass
        return merge(lists)

    async def transaction(self, ops, id: Optional[ID] = None) -> list:
        """msg.go Transaction: [(key, value), ...] packed into one
        protocol-ordered command and applied atomically by the state
        machine on every replica; returns each op's previous value.
        Ops with an empty value are reads (db.go empty-value semantics)."""
        self.command_id += 1
        body = json.dumps([
            {"key": k, "value": v.decode("latin1")} for k, v in ops
        ]).encode()
        status, headers, payload = await self._conn(ID(id) if id else
                                                    self.id).request(
            "POST", "/transaction",
            {"Client-Id": self.client_id,
             "Command-Id": str(self.command_id)}, body)
        if status != 200:
            raise IOError(headers.get("err", f"http {status}"))
        return [v.encode("latin1")
                for v in json.loads(payload.decode())["values"]]

    def close(self) -> None:
        for c in self._conns.values():
            c.close()
        self._conns.clear()


class AdminClient:
    """Reference: client.go AdminClient — drive /admin fault injection."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self._conns: Dict[ID, _Conn] = {}

    def _conn(self, id: ID) -> _Conn:
        if id not in self._conns:
            self._conns[id] = _Conn(self.cfg.http_addrs[ID(id)])
        return self._conns[id]

    async def _admin(self, id: ID, path: str) -> None:
        status, headers, _ = await self._conn(ID(id)).request(
            "POST", path, {}, b"")
        if status != 200:
            raise IOError(headers.get("err", f"http {status}"))

    async def crash(self, id: ID, t: float) -> None:
        await self._admin(id, f"/admin/crash?t={t}")

    async def drop(self, frm: ID, to: ID, t: float) -> None:
        await self._admin(frm, f"/admin/drop?id={to}&t={t}")

    async def slow(self, frm: ID, to: ID, delay_ms: float, t: float) -> None:
        await self._admin(frm, f"/admin/slow?id={to}&delay={delay_ms}&t={t}")

    async def flaky(self, frm: ID, to: ID, p: float, t: float) -> None:
        await self._admin(frm, f"/admin/flaky?id={to}&p={p}&t={t}")

    def close(self) -> None:
        for c in self._conns.values():
            c.close()
