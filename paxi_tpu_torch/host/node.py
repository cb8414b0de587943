"""The host-runtime node: message loop, handler dispatch, HTTP API.

Reference: paxi node.go — ``Node`` embeds Socket + Database + an HTTP
server; ``Register(msgType, handler)`` stores handlers keyed by message
type; ``Run()`` starts the HTTP server and the recv loop, which pulls
from ``Socket.Recv()`` and dispatches on the concrete message type
[driver: Register/Run plugin boundary].  ``Forward(id, req)`` relays a
client request to another node (e.g. the ballot leader) and routes the
reply back to the origin's HTTP client.

The goroutine-per-node model becomes one asyncio task per node, so any
number of nodes share one process/event loop — which is exactly the
reference's ``-simulation`` mode when the config uses chan:// addresses.
"""

from __future__ import annotations

import asyncio
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from paxi_tpu_torch.utils import log

from paxi_tpu_torch.core.command import Command, Reply, Request
from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.db import Database
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.batch import BatchBuffer
from paxi_tpu_torch.host.codec import Codec, register_message
from paxi_tpu_torch.host.http import HTTPServer
from paxi_tpu_torch.host.socket import Socket
from paxi_tpu_torch.metrics import Registry
from paxi_tpu_torch.obs import SpanCollector


@register_message
@dataclass
class WireRequest:
    """A client Request forwarded node-to-node (reply channel stripped,
    like the reference's gob-encoded Request; msg.go)."""

    key: int
    value: bytes
    client_id: str
    command_id: int
    properties: dict = field(default_factory=dict)
    timestamp: float = 0.0
    node_id: str = ""     # origin node holding the client connection
    seq: int = 0          # origin-local id routing the reply back


@register_message
@dataclass
class WireReply:
    """Reply to a forwarded request, routed back to the origin node."""

    key: int
    value: bytes
    client_id: str
    command_id: int
    err: str = ""
    node_id: str = ""
    seq: int = 0


@register_message
@dataclass
class WireRequestBatch:
    """A burst of forwarded requests coalesced into ONE frame
    (HT-Paxos's lever applied to the follower->leader path): the
    per-destination forward buffer drains every ``WireRequest`` that
    arrived in the current event-loop burst into a single send, so a
    follower under client load costs the leader one frame per tick
    instead of one per command.  A lone forward still travels as a
    bare ``WireRequest`` (no frame overhead, and recorded-trace drop
    directives keep their per-message aim)."""

    items: list = field(default_factory=list)   # List[WireRequest]


class Node:
    def __init__(self, id: ID, cfg: Config, codec: Optional[Codec] = None,
                 fabric=None):
        self.id = ID(id)
        self.cfg = cfg
        # one registry per node, shared with the socket, exported by the
        # node's HTTP server as GET /metrics (metrics/)
        self.metrics = Registry(node=str(self.id))
        # per-message-type handles resolved once: the recv loop is THE
        # hot path and must not pay a labeled registry lookup per message
        self._msg_metrics: Dict[str, tuple] = {}
        # ``fabric``: an injected virtual-clock transport (host/fabric.py)
        # — None outside trace replay; Socket also picks up the ambient
        # use_fabric() context so replica factories need no new argument
        self.socket = Socket(self.id, cfg, codec, metrics=self.metrics,
                             fabric=fabric)
        # per-node span ring (obs/): clocked by the socket's
        # resolved fabric under replay, perf_counter live; exported as
        # GET /spans next to the registry's GET /metrics
        self.spans = SpanCollector(node=str(self.id),
                                   fabric=self.socket.fabric)
        self.db = Database(cfg.multi_version)
        self.handles: Dict[type, Callable[[Any], None]] = {}
        self.http: Optional[HTTPServer] = None
        # resolved once: handle_client_request is on the per-op hot path
        self._client_reqs_total = self.metrics.counter(
            "paxi_client_requests_total")
        self._fwd_seq = 0
        self._fwd_pending: Dict[int, Request] = {}
        # per-destination forward coalescing (host/batch.py): tick-mode
        # only — a forward must never wait on a wall timer
        self._fwd_buf: Dict[ID, BatchBuffer] = {}
        self._tasks: list = []
        self.register(WireRequest, self._handle_wire_request)
        self.register(WireRequestBatch, self._handle_wire_request_batch)
        self.register(WireReply, self._handle_wire_reply)

    # ---- plugin boundary (node.go Register) ----------------------------
    def register(self, msg_class: type, handler: Callable[[Any], None]) -> None:
        self.handles[msg_class] = handler

    # ---- lifecycle (node.go Run) ---------------------------------------
    async def start(self) -> None:
        await self.socket.start()
        if self.id in self.cfg.http_addrs:
            self.http = HTTPServer(self)
            await self.http.start()
        self._tasks.append(asyncio.create_task(self._recv_loop()))

    async def _recv_loop(self) -> None:
        """THE hot loop (node.go recv): pull, dispatch by message type.
        A handler exception must not kill the loop — log and keep going.

        After the first (awaited) message the loop drains everything
        already queued without yielding back to the event loop — under
        a batched commit pipeline whole P2b/P3 bursts land per wakeup,
        so this saves a task switch per message exactly where it counts."""
        inbox = self.socket.inbox
        while True:
            msg = await self.socket.recv()
            while True:
                await self._dispatch(msg)
                try:
                    msg = inbox.get_nowait()
                except asyncio.QueueEmpty:
                    break

    async def _dispatch(self, msg: Any) -> None:
        mname = type(msg).__name__
        mm = self._msg_metrics.get(mname)
        if mm is None:
            mm = self._msg_metrics[mname] = (
                self.metrics.counter("paxi_msgs_in_total", type=mname),
                self.metrics.histogram("paxi_handler_seconds",
                                       type=mname))
        in_total, dispatch_hist = mm
        in_total.inc()
        h = self.handles.get(type(msg))
        if h is None:
            self.metrics.counter("paxi_msgs_unhandled_total",
                                 type=mname).inc()
            return
        t0 = time.perf_counter()
        try:
            r = h(msg)
            if asyncio.iscoroutine(r):
                await r
        except asyncio.CancelledError:
            raise
        except Exception:
            self.metrics.counter("paxi_handler_errors_total",
                                 type=mname).inc()
            log.errorf("%s: handler for %s raised:\n%s", self.id,
                       type(msg).__name__, traceback.format_exc())
        dispatch_hist.observe(time.perf_counter() - t0)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self.http:
            await self.http.stop()
        await self.socket.close()

    def run_forever(self) -> None:
        """Blocking entry (the reference's replica.Run())."""
        async def _main():
            await self.start()
            await asyncio.Event().wait()
        asyncio.run(_main())

    # ---- client-request plumbing ---------------------------------------
    def handle_client_request(self, req: Request) -> None:
        """Entry from the HTTP server: dispatch into the protocol's
        registered Request handler (node.go http handler -> MessageChan)."""
        self._client_reqs_total.inc()
        h = self.handles.get(Request)
        if h is None:
            req.reply(Reply(req.command, err="no Request handler registered"))
            return
        h(req)

    def forward(self, to: ID, req: Request) -> None:
        """Reference: node.go Forward — relay to ``to`` (e.g. the leader),
        remember the pending reply slot.  Forwards coalesce through a
        per-destination BatchBuffer: every request of one event-loop
        burst rides a single ``WireRequestBatch`` frame."""
        self.metrics.counter("paxi_forwards_total").inc()
        self._fwd_seq += 1
        seq = self._fwd_seq
        self._fwd_pending[seq] = req
        c = req.command
        wr = WireRequest(
            key=c.key, value=c.value, client_id=c.client_id,
            command_id=c.command_id, properties=dict(req.properties),
            timestamp=req.timestamp or self.spans.now(),
            node_id=str(self.id), seq=seq)
        buf = self._fwd_buf.get(to)
        if buf is None:
            buf = self._fwd_buf[to] = BatchBuffer(
                lambda items, _to=to: self._flush_forwards(_to, items),
                max_size=self.cfg.batch_size, max_wait=0.0,
                metrics=self.metrics, spans=self.spans, path="forward")
        buf.add(wr)

    def _flush_forwards(self, to: ID, items: list) -> None:
        if len(items) == 1:
            self.socket.send(to, items[0])
        else:
            self.socket.send(to, WireRequestBatch(items))

    def _handle_wire_request_batch(self, m: WireRequestBatch) -> None:
        for item in m.items:
            self._handle_wire_request(item)

    def _handle_wire_request(self, m: WireRequest) -> None:
        """A forwarded request arrives: synthesize a Request whose reply
        is routed back to the origin node over the wire."""
        cmd = Command(m.key, m.value, m.client_id, m.command_id)

        def reply_back(rep: Reply, _m=m):
            self.socket.send(ID(_m.node_id), WireReply(
                key=cmd.key, value=rep.value,
                client_id=cmd.client_id, command_id=cmd.command_id,
                err=rep.err or "", node_id=str(self.id), seq=_m.seq))

        self.handle_client_request(Request(
            command=cmd, properties=dict(m.properties),
            timestamp=m.timestamp, node_id=m.node_id, reply_to=reply_back))

    def _handle_wire_reply(self, m: WireReply) -> None:
        req = self._fwd_pending.pop(m.seq, None)
        if req is not None:
            req.reply(Reply(req.command, value=m.value, err=m.err or None))

    # ---- misc ----------------------------------------------------------
    def retry(self, req: Request) -> None:
        """Reference: node.go Retry — re-inject a request into dispatch."""
        self.metrics.counter("paxi_retries_total").inc()
        self.handle_client_request(req)
