"""Helpers of the serving tests (``tests/test_torch_serving*.py``).

The JAX package's serving tests bind fixed ports (the default 1735/2735
blocks, 18830-18890) in other test workers, so every port here is free
when taken: ``free_ports`` binds sockets to port 0 (the OS picks), and
``free_base`` finds a base whose peer block ``base..base+n-1`` and HTTP
block ``base+1000..`` are both free, inside a window of the worker's own
below the ephemeral range, for the commands and twins that take a
``local_config`` base port.  Every network wait has its own timeout.
"""

import asyncio
import contextlib
import importlib
import io
import json
import os
import socket

PKGS = ("paxi_tpu", "paxi_tpu_torch")
WAIT_S = 20.0


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def free_ports(k):
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(k)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _bindable(port):
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


_NEXT = [0]


def free_base(n):
    """A base port with ``n`` free peer ports and ``n`` free HTTP ports
    1000 above (``local_config``'s layout), away from the fixed blocks
    the JAX package's tests use.  Each test worker takes bases from a
    window of its own (``20000 + 1500 k`` to 400 above, k the xdist
    worker's number mod 8), so no two workers' blocks overlap, HTTP
    blocks included; within the window the bases move on from call to
    call."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    lo = 20000 + 1500 * (int(worker[2:] or 0) % 8)
    span = 400 - n
    for _ in range(span):
        base = lo + _NEXT[0] % span
        _NEXT[0] += 7
        if all(_bindable(base + d + k) for d in (0, 1000)
               for k in range(n)):
            return base
    raise RuntimeError("no free port block")


def serving_config(pkg, n=3, zones=1, tag="serve"):
    """An n-replica chan-fabric config whose HTTP addresses are free
    ports of the OS."""
    sim = mod(pkg, "host.simulation")
    cfg = sim.chan_config(n, zones=zones, tag=f"{tag}-{pkg}")
    ports = free_ports(n)
    cfg.http_addrs = {i: f"http://127.0.0.1:{p}"
                      for i, p in zip(cfg.ids, ports)}
    return cfg


def run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def raw_exchange(url, frame, n_responses=1, timeout=WAIT_S):
    """Send raw request bytes to an HTTP address and read back
    ``n_responses`` responses, each as (status line, headers, body)."""
    host, port = url.split("://")[1].rsplit(":", 1)
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, int(port)), timeout)
    try:
        writer.write(frame)
        await writer.drain()
        out = []
        for _ in range(n_responses):
            head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                          timeout)
            lines = head[:-4].decode().split("\r\n")
            headers = {}
            for ln in lines[1:]:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
            n = int(headers.get("content-length", "0"))
            body = await asyncio.wait_for(reader.readexactly(n),
                                          timeout) if n else b""
            out.append((lines[0], headers, body))
        return out
    finally:
        writer.close()


def run_cli(pkg, argv):
    """(exit code, stdout) of ``python -m PKG ARGV`` run in this process."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod(pkg, "cli").main(argv)
    return rc, out.getvalue()


def last_json(text):
    return json.loads([x for x in text.splitlines() if x.startswith("{")][-1])
