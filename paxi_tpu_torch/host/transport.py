"""Deployment transports for the host runtime.

Reference: paxi transport.go — a ``Transport`` interface selected by URL
scheme with three implementations: ``tcp`` (persistent connection, gob
encoder/decoder, a send goroutine draining a buffered channel), ``udp``
(packet per message) and ``chan`` (in-process Go channels, the simulation
backend) [driver: tcp/chan].

Here the event model is asyncio instead of goroutines: each transport
exposes ``send(msg)`` (enqueue, never blocks the protocol logic) and
feeds received messages into the owner's inbox queue.  Delivery matches
the reference: FIFO per pair on tcp/chan, best-effort on udp, silent
drop on broken/unreachable peers.

Throughput path: the tcp writer task drains its whole outbound queue
per wakeup and ships it as ONE coalesced frame (codec.encode_batch) —
one length header + one send syscall per burst instead of per message.
Backpressure is observable instead of silent: transports report
queue-full drops and coalesced sends through ``on_drop``/``on_coalesce``
callbacks, which Socket wires into its metrics registry
(``paxi_msgs_dropped_total{reason="queue_full"}`` /
``paxi_msgs_coalesced_total``) so ``GET /metrics`` shows them without
new plumbing.
"""

from __future__ import annotations

import asyncio
import socket as pysocket
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import urlparse

from paxi_tpu_torch.host.codec import Codec

Deliver = Callable[[Any], None]

# in-process "chan" fabric: addr -> inbox put-callback (one per listener)
_CHAN_LISTENERS: Dict[str, Deliver] = {}


def reset_chan_fabric() -> None:
    """Clear the in-process fabric (test isolation)."""
    _CHAN_LISTENERS.clear()


def parse_addr(url: str) -> Tuple[str, str, int]:
    u = urlparse(url)
    return u.scheme, u.hostname or "127.0.0.1", u.port or 0


async def wait_listening(url: str, timeout_s: float = 30.0) -> bool:
    """Poll until something accepts TCP connections at ``url`` (a
    subprocess cluster's HTTP server coming up) or the timeout
    passes — the ONE readiness probe behind ``bench-host
    --cluster-proc`` and the sharded cluster's subprocess mode."""
    _, host, port = parse_addr(url)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        try:
            pysocket.create_connection((host, port), 0.5).close()
            return True
        except OSError:
            await asyncio.sleep(0.1)
    return False


class Transport:
    """One peer link.  Subclasses: ChanTransport, TCPTransport, UDPTransport."""

    scheme = "?"

    def __init__(self, url: str):
        self.url = url

    async def dial(self) -> None:           # connect to the peer
        raise NotImplementedError

    def send(self, msg: Any) -> None:       # fire-and-forget, non-blocking
        raise NotImplementedError

    async def close(self) -> None:
        pass


class ChanTransport(Transport):
    """In-process fabric (reference scheme ``chan`` — simulation mode).

    Send is a direct callback into the destination node's inbox; no codec
    round-trip, matching the reference where chan skips gob entirely."""

    scheme = "chan"

    def __init__(self, url: str):
        super().__init__(url)
        self._deliver: Optional[Deliver] = None

    async def dial(self) -> None:
        self._deliver = _CHAN_LISTENERS.get(self.url)
        if self._deliver is None:
            raise ConnectionError(f"no chan listener at {self.url}")

    def send(self, msg: Any) -> None:
        if self._deliver is None:
            deliver = _CHAN_LISTENERS.get(self.url)
            if deliver is None:
                return  # peer not up: silent drop, like a dead TCP peer
            self._deliver = deliver
        self._deliver(msg)


class TCPTransport(Transport):
    """Persistent framed-codec connection with an outbound queue drained
    by a writer task (the reference's send goroutine + buffered chan).

    The drain loop empties the queue per wakeup and coalesces the burst
    into one BATCH frame — the syscall-amortization that lets a Python
    event loop keep up with a batched commit pipeline."""

    scheme = "tcp"

    # messages folded into one coalesced frame at most (bounds both the
    # frame size and receive-side burst work)
    COALESCE_MAX = 256

    def __init__(self, url: str, codec: Codec, buffer_size: int = 1024,
                 on_drop=None, on_coalesce=None):
        super().__init__(url)
        self.codec = codec
        self._q: asyncio.Queue = asyncio.Queue(maxsize=buffer_size)
        self._writer_task: Optional[asyncio.Task] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._on_drop = on_drop          # called (msg, "queue_full")
        self._on_coalesce = on_coalesce  # called (n_msgs_in_frame)

    async def dial(self) -> None:
        _, host, port = parse_addr(self.url)
        _, self._writer = await asyncio.open_connection(host, port)
        self._writer_task = asyncio.create_task(self._drain())

    async def _drain(self) -> None:
        try:
            while True:
                batch = [await self._q.get()]
                while len(batch) < self.COALESCE_MAX:
                    try:
                        batch.append(self._q.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                if len(batch) == 1:
                    self._writer.write(self.codec.encode(batch[0]))
                else:
                    self._writer.write(self.codec.encode_batch(batch))
                    if self._on_coalesce is not None:
                        self._on_coalesce(len(batch))
                await self._writer.drain()
        except (ConnectionError, asyncio.CancelledError, OSError):
            pass  # peer gone: remaining queued messages are dropped

    def send(self, msg: Any) -> None:
        try:
            self._q.put_nowait(msg)
        except asyncio.QueueFull:
            # backpressure policy: drop, like a full buffered chan —
            # but observably (socket counts reason="queue_full")
            if self._on_drop is not None:
                self._on_drop(msg, "queue_full")

    async def close(self) -> None:
        if self._writer_task:
            self._writer_task.cancel()
        if self._writer:
            self._writer.close()


class UDPTransport(Transport):
    """One datagram per message (reference scheme ``udp``)."""

    scheme = "udp"

    def __init__(self, url: str, codec: Codec):
        super().__init__(url)
        self.codec = codec
        self._sock: Optional[pysocket.socket] = None
        self._dest: Tuple[str, int] = ("", 0)

    async def dial(self) -> None:
        _, host, port = parse_addr(self.url)
        self._dest = (host, port)
        self._sock = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM)
        self._sock.setblocking(False)

    def send(self, msg: Any) -> None:
        if self._sock is None:
            return
        try:
            self._sock.sendto(self.codec.encode(msg), self._dest)
        except OSError:
            pass

    async def close(self) -> None:
        if self._sock:
            self._sock.close()


def new_transport(url: str, codec: Codec, buffer_size: int = 1024,
                  on_drop=None, on_coalesce=None) -> Transport:
    """Reference: transport.go NewTransport — switch on URL scheme."""
    scheme = urlparse(url).scheme
    if scheme == "chan":
        return ChanTransport(url)
    if scheme == "tcp":
        return TCPTransport(url, codec, buffer_size,
                            on_drop=on_drop, on_coalesce=on_coalesce)
    if scheme == "udp":
        return UDPTransport(url, codec)
    raise ValueError(f"unknown transport scheme {scheme!r} in {url}")


async def listen(url: str, deliver: Deliver, codec: Codec):
    """Start a listener for ``url`` feeding decoded messages to
    ``deliver``.  Returns an object with ``.close()``.

    Reference: transport.go Listen per scheme."""
    scheme, host, port = parse_addr(url)
    if scheme == "chan":
        _CHAN_LISTENERS[url] = deliver

        class _ChanServer:
            def close(self_inner):
                _CHAN_LISTENERS.pop(url, None)
        return _ChanServer()

    if scheme == "tcp":
        async def on_conn(reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
            try:
                while True:
                    header = await reader.readexactly(4)
                    body = await reader.readexactly(Codec.frame_size(header))
                    # a coalesced frame fans out here; plain frames are
                    # a 1-list, so both kinds share one code path
                    for msg in codec.decode_all(body):
                        deliver(msg)
            except (asyncio.IncompleteReadError, ConnectionError, OSError):
                writer.close()
        return await asyncio.start_server(on_conn, host, port)

    if scheme == "udp":
        loop = asyncio.get_running_loop()

        class _UDP(asyncio.DatagramProtocol):
            def datagram_received(self_inner, data: bytes, addr):
                try:
                    body = data[4:4 + Codec.frame_size(data[:4])]
                    for msg in codec.decode_all(body):
                        deliver(msg)
                except Exception:
                    pass  # malformed datagram: drop

        transport, _ = await loop.create_datagram_endpoint(
            _UDP, local_addr=(host, port))
        return transport

    raise ValueError(f"unknown listen scheme {scheme!r}")
