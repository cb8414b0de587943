"""The shard router tier: one serving surface over G consensus groups.

Clients speak the ordinary KV REST dialect to the router; the router
resolves each key through the versioned ``ShardMap`` and forwards the
request over pipelined connections (host/client._Conn) to the owning
group's entry node — so the whole existing serving stack (pipelined
HTTP, batch-per-slot commit pipeline, per-command reply fan-out) sits
unchanged BEHIND the partition, and aggregate throughput scales with
independent group instances instead of one leader pipeline.

Routing-table swap discipline (the PXC-checked shape): ``_map`` and
the per-group pending queues are guarded by one ``threading.Lock``;
``install_map`` swaps the immutable ShardMap reference under it and
every request path reads one snapshot.  Forwarding is two-phase like
the batch buffer: requests enqueue (under the lock) onto the owning
group's pending list stamped with the map version they resolved
under; a scheduled flush swaps the lists out under the lock and ships
them outside it.  The flush RE-RESOLVES any op whose stamp predates
the current map version — an op whose key moved groups mid-pipeline
is rerouted to its new owner (counted as
``paxi_router_stale_reroutes_total``) instead of executing against a
group that no longer owns the key: the stale-epoch reject + retry
path, internal to the router so clients never see a misrouted reply.

Live migration (shard/migrate.py) adds two flush-time behaviors: a
write whose key sits in a migration window of the current map ships
to BOTH owner groups and acks only when both legs ack (the
double-write fence, ``paxi_router_dualwrites_total``); a backend
reply carrying the MOVED marker (the key's range was released at
cutover) re-enqueues the op under the freshest map — refreshed via
the injectable ``_map_refresh`` hook on secondary routers — instead
of surfacing stale state, so N stateless routers can share one
versioned map with only the primary seeing ``install_map`` directly.

Surfaces:
- ``GET|PUT|POST /{key}``          routed KV (Client-Id/Command-Id pass
                                   through, so at-most-once filtering
                                   and linearizability hold end-to-end)
- ``POST /transaction``            single-group txns forward as packed
                                   transactions; cross-group txns run
                                   2PC (shard/txn.py)
- ``GET /shardmap``                the live map (version, ranges)
- ``POST /shardmap/move?lo&hi&group``  key-stealing control plane:
                                   swap in ``map.move_range(...)``
- ``GET /metrics``                 router registry + every group's
                                   node registries, each group's
                                   series labeled ``group=<g>``,
                                   merged through the ONE registry
                                   code path (metrics/registry.py)
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from paxi_tpu_torch.core.command import MOVED_MAGIC, RESERVED_PREFIXES
from paxi_tpu_torch.host.client import _Conn
from paxi_tpu_torch.host.http import _OK_TMPL, _response, read_request
from paxi_tpu_torch.metrics import Registry, merge_snapshots
from paxi_tpu_torch.metrics.registry import render_prometheus
from paxi_tpu_torch.obs import (SpanCollector, TraceCtx, new_trace_id,
                          process_sampler)
from paxi_tpu_torch.obs import merge as merge_spans
from paxi_tpu_torch.obs import label_group as label_group_spans
from paxi_tpu_torch.shard.shardmap import ShardMap
from paxi_tpu_torch.shard.txn import ShardCoordinator, TxnOutcome, partition_ops


class _RoutedOp:
    """One forwarded KV request: the backend frame, the response slot,
    the map epoch it was routed under, and the pending-queue ``route``
    span when the request is traced.  ``write`` marks ops that must be
    duplicated inside a double-write window; ``dual`` marks a leg of
    such a duplicated write (its slot resolves to a raw
    ``(status, payload)`` pair joined by ``_dual_join``); ``tries``
    counts MOVED-marker bounces (shard/migrate.py cutover)."""

    __slots__ = ("key", "frame", "slot", "epoch", "span", "write",
                 "tries", "dual")

    def __init__(self, key: int, frame: bytes, slot, epoch: int,
                 span=None, write: bool = False):
        self.key = key
        self.frame = frame
        self.slot = slot
        self.epoch = epoch
        self.span = span
        self.write = write
        self.tries = 0
        self.dual = False


class ShardRouter:
    """Routing core: map snapshot/swaps, per-group pipes, 2PC."""

    def __init__(self, shard_map: ShardMap, group_urls: List[str],
                 lease_s: float = 0.2,
                 metrics: Optional[Registry] = None,
                 group_scrape=None, group_scrape_spans=None):
        if shard_map.n_groups > len(group_urls):
            raise ValueError(
                f"map names group {shard_map.n_groups - 1} but only "
                f"{len(group_urls)} group urls given")
        self._lock = threading.Lock()
        self._map = shard_map
        self._pending: List[List[_RoutedOp]] = [[] for _ in group_urls]
        self._flush_scheduled = False
        self._conns = [_Conn(u) for u in group_urls]
        self._tpc_conns = [_Conn(u) for u in group_urls]
        self.metrics = metrics if metrics is not None \
            else Registry(tier="router")
        # async callable returning per-group registry snapshots for
        # /metrics aggregation (injected by ShardedCluster: in-proc
        # reads replica registries, subprocess mode scrapes HTTP);
        # _group_scrape_spans is the same shape for GET /spans
        self._group_scrape = group_scrape
        self._group_scrape_spans = group_scrape_spans
        # the router is the entry tier of sharded serving: head-based
        # sampling happens here (obs/sample.py), once per command, and
        # the decision propagates to the backend group as a
        # Property-Trace header — backend nodes never re-sample
        self.sampler = process_sampler()
        self.spans = SpanCollector(node="router")
        self._fwd_total = self.metrics.counter(
            "paxi_router_forwards_total")
        self._stale_total = self.metrics.counter(
            "paxi_router_stale_reroutes_total")
        self._map_swaps = self.metrics.counter(
            "paxi_router_map_swaps_total")
        self._dual_total = self.metrics.counter(
            "paxi_router_dualwrites_total")
        # optional async hook a multi-router deployment injects
        # (cluster.py): fetch + install the primary's current map when
        # a backend bounces a request with the MOVED marker — how a
        # stale secondary router converges on a cutover it missed
        self._map_refresh = None
        # 64-bucket key histogram over the map span: the rebalancer's
        # split-point evidence (which part of a hot range is hot),
        # maintained under the routing lock so it reads one map
        # snapshot per increment
        self._bucket_hits = [0] * 64
        # per-group routed-command load: the skew evidence for
        # workload-driven runs (a hot key range shows up as one group's
        # counter racing ahead of the rest) — same registry path as
        # every other series, so /metrics and shard/bench.py read it
        # without a side channel
        self._group_fwd = [
            self.metrics.counter("paxi_router_group_commands_total",
                                 group=str(g))
            for g in range(len(group_urls))]
        # router-tier levels, per group: how deep the pending queue is
        # right now and how many shipped commands await group replies —
        # the "router-capped past G=2" claim as scrapeable numbers
        self._g_depth = [
            self.metrics.gauge("paxi_router_pending_depth",
                               group=str(g))
            for g in range(len(group_urls))]
        self._g_inflight = [
            self.metrics.gauge("paxi_router_inflight", group=str(g))
            for g in range(len(group_urls))]
        self.coord = ShardCoordinator(self._tpc_submit, lease_s=lease_s,
                                      metrics=self.metrics,
                                      spans=self.spans)

    # ---- map snapshot / swap (the lockset-checked pair) ----------------
    @property
    def shard_map(self) -> ShardMap:
        with self._lock:
            return self._map

    def install_map(self, new_map: ShardMap) -> None:
        """Swap the routing table (version must advance).  Pending ops
        re-resolve at the next flush — nothing here touches in-flight
        state beyond the one reference swap."""
        new_map.validate()
        if new_map.n_groups > len(self._conns):
            raise ValueError(
                f"map names group {new_map.n_groups - 1} but the "
                f"router has {len(self._conns)} groups")
        with self._lock:
            if new_map.version <= self._map.version:
                raise ValueError(
                    f"stale map: version {new_map.version} <= "
                    f"installed {self._map.version}")
            self._map = new_map
        self._map_swaps.inc()

    # ---- KV forwarding --------------------------------------------------
    def sample_entry(self, kind: str, **labels):
        """The once-per-command sampling decision: a hit opens (and
        returns) the trace's root span; None == unsampled."""
        if not self.sampler.decide():
            return None
        return self.spans.start(kind, TraceCtx(new_trace_id()),
                                **labels)

    def route_kv(self, key: int, frame: bytes, loop,
                 span=None, write: bool = False) -> asyncio.Future:
        """Enqueue one KV request for its owning group; the returned
        future resolves to response BYTES for the router's client.
        ``span`` is the traced request's root (sample_entry): its
        pending-queue wait becomes a ``route`` child span and the root
        finishes when the response slot resolves.  ``write`` ops are
        duplicated to the destination group at flush time when their
        key sits in a double-write window (shard/migrate.py)."""
        slot: asyncio.Future = loop.create_future()
        self._fwd_total.inc()
        op = _RoutedOp(key, frame, slot, 0, write=write)
        with self._lock:
            m = self._map
            g = m.group_of(key)
            op.epoch = m.version
            self._pending[g].append(op)
            depth = len(self._pending[g])
            self._bucket_hits[(int(key) % m.span) * 64 // m.span] += 1
        self._g_depth[g].set(depth)
        self._group_fwd[g].inc()
        if span is not None:
            op.span = self.spans.start("route", span.child(),
                                       group=str(g))
            spans = self.spans
            slot.add_done_callback(
                lambda _s, _sp=span: spans.finish(_sp))
        return slot

    async def flush(self) -> None:
        """Ship every pending op: swap the queues out under the lock,
        re-resolve stale-epoch ops against the CURRENT map (rerouting
        moved keys to their new owner), then write each group's burst
        over its pipelined connection."""
        with self._lock:
            m = self._map
            batches = self._pending
            self._pending = [[] for _ in self._conns]
        for gd in self._g_depth:
            gd.set(0)
        moved: List[_RoutedOp] = []
        for g, ops in enumerate(batches):
            if not ops:
                continue
            keep: List[_RoutedOp] = []
            for op in ops:
                if op.epoch != m.version and m.group_of(op.key) != g:
                    op.epoch = m.version
                    moved.append(op)
                else:
                    keep.append(op)
            batches[g] = keep
        for op in moved:
            self._stale_total.inc()
            g_new = m.group_of(op.key)
            self._group_fwd[g_new].inc()   # load lands on the new owner
            batches[g_new].append(op)
        # double-write fence: a write whose key sits in one of the
        # CURRENT map's migration windows ships to BOTH groups — the
        # client slot resolves only once both legs acked (_dual_join),
        # so an acked write can never exist on just one side of the
        # handoff
        for g, ops in enumerate(batches):
            for op in ops:
                if not op.write or op.dual:
                    continue
                mig = m.migration_of(op.key)
                if mig is None or mig[2] != g:
                    continue
                client = op.slot
                fa = client.get_loop().create_future()
                fb = client.get_loop().create_future()
                op.slot, op.dual = fa, True
                shadow = _RoutedOp(op.key, op.frame, fb, m.version,
                                   write=True)
                shadow.dual = True
                self._dual_total.inc()
                self._group_fwd[mig[3]].inc()
                batches[mig[3]].append(shadow)
                self._dual_join(client, fa, fb)
        await asyncio.gather(*[
            self._ship(g, ops) for g, ops in enumerate(batches) if ops])

    async def _ship(self, g: int, ops: List[_RoutedOp]) -> None:
        conn = self._conns[g]
        try:
            await conn.ensure()
        except OSError as e:
            for op in ops:
                self.spans.finish(op.span)
                self._fail_op(op, e)
            return
        self._g_inflight[g].inc(len(ops))
        for op in ops:
            self.spans.finish(op.span)   # queue wait ends at the wire
            conn.submit_raw(op.frame, self._make_done(op, g))
        try:
            await conn.flush()
        except (ConnectionError, OSError):
            pass   # the dead reader task fails the waiters; next
            # flush re-dials via ensure()

    @staticmethod
    def _fail_slot(slot: asyncio.Future, exc: Exception) -> None:
        if not slot.done():
            slot.set_result(_response(
                500, b"", {"Err": f"group unreachable: {exc!r}"}))

    def _fail_op(self, op: _RoutedOp, exc: Exception) -> None:
        if op.slot.done():
            return
        if op.dual:
            op.slot.set_result((599, repr(exc).encode()))
        else:
            self._fail_slot(op.slot, exc)

    @staticmethod
    def _dual_join(client: asyncio.Future, fa: asyncio.Future,
                   fb: asyncio.Future) -> None:
        """Resolve the client slot once BOTH double-write legs are in:
        either leg failing fails the request (the client must never
        believe an un-duplicated write acked); the source group's
        payload (the authoritative previous value) answers, unless the
        source already released the range (MOVED marker — cutover
        raced the ship), in which case the destination ack stands."""
        def done(_f):
            if not (fa.done() and fb.done()) or client.done():
                return
            (sa, pa), (sb, pb) = fa.result(), fb.result()
            if sa != 200 or sb != 200:
                err = pa if sa != 200 else pb
                client.set_result(_response(
                    500, b"",
                    {"Err": "double-write leg failed: "
                     + err.decode("latin1")}))
                return
            payload = pb if pa.startswith(MOVED_MAGIC) else pa
            client.set_result(_OK_TMPL % len(payload) + payload)
        fa.add_done_callback(done)
        fb.add_done_callback(done)

    def _make_done(self, op: _RoutedOp, g: int):
        inflight = self._g_inflight[g]

        def done(status, headers, payload, exc, _op=op):
            inflight.dec()
            slot = _op.slot
            if slot.done():
                return
            if _op.dual:
                # one leg of a double-write: hand the raw outcome to
                # _dual_join, which picks the client reply
                if exc is not None:
                    slot.set_result((599, repr(exc).encode()))
                elif status == 200:
                    slot.set_result((200, payload))
                else:
                    slot.set_result(
                        (status, headers.get("err", "").encode()))
                return
            if exc is not None:
                ShardRouter._fail_slot(slot, exc)
            elif status == 200 and payload.startswith(MOVED_MAGIC):
                # the group released this key's range to a new owner
                # (post-cutover): reroute under the current map
                # instead of surfacing the marker
                self._bounce(_op)
            elif status == 200:
                slot.set_result(_OK_TMPL % len(payload) + payload)
            else:
                slot.set_result(_response(
                    status, b"", {"Err": headers.get("err", "")}))
        return done

    # ---- MOVED bounce (stale router vs. cutover) ------------------------
    def _bounce(self, op: _RoutedOp) -> None:
        op.tries += 1
        if op.tries > 3:
            op.slot.set_result(_response(
                500, b"", {"Err": "range moved; reroute retries "
                                  "exhausted"}))
            return
        self._stale_total.inc()
        op.slot.get_loop().create_task(self._rebounce(op))

    async def _rebounce(self, op: _RoutedOp) -> None:
        """Re-enqueue a MOVED-bounced op under the freshest map: pull
        the primary's map first when the refresh hook is wired (a
        stale secondary router learning of a cutover it missed), then
        re-resolve and ship."""
        if self._map_refresh is not None:
            try:
                await self._map_refresh()
            except (IOError, OSError, ValueError):
                pass   # refresh failing just burns one retry
        with self._lock:
            m = self._map
            g = m.group_of(op.key)
            op.epoch = m.version
            self._pending[g].append(op)
        self._group_fwd[g].inc()
        await self.flush()

    async def barrier(self, group: int) -> None:
        """Write-order fence for ``group``: every KV op this router
        already accepted for the group is on its wire (and therefore
        ahead in its log) before this returns — flush the pending
        queue, then ride a no-op read through the SAME pipelined
        connection, whose FIFO ordering makes the read's reply prove
        the earlier writes were submitted.  The migration coordinator
        calls this before committing a fence record so the fence
        orders after every pre-fence routed write."""
        await self.flush()
        conn = self._conns[group]
        await conn.ensure()
        slot = asyncio.get_running_loop().create_future()

        def done(status, headers, payload, exc):
            if not slot.done():
                slot.set_result(b"")
        conn.submit_raw(
            b"GET /0 HTTP/1.1\r\nContent-Length: 0\r\n"
            b"Client-Id: \r\nCommand-Id: 0\r\n\r\n", done)
        await conn.flush()
        await slot

    def bucket_hits(self, reset: bool = False) -> List[int]:
        """The 64-bucket key histogram snapshot (rebalancer input)."""
        with self._lock:
            out = list(self._bucket_hits)
            if reset:
                self._bucket_hits = [0] * 64
        return out

    # ---- 2PC transport --------------------------------------------------
    async def _tpc_submit(self, group: int, key: int, rec: dict):
        """ShardCoordinator transport: one 2PC record as POST /tpc to
        the group (dedicated conns — records must not queue behind a
        KV burst in the shared pipeline); the server packs the
        TPC_MAGIC form, so the record is encoded once per hop."""
        doc: Dict = {"kind": rec["kind"], "txid": rec["txid"],
                     "key": int(key)}
        if "ops" in rec:
            doc["ops"] = [[k, v.decode("latin1")] for k, v in rec["ops"]]
        if rec.get("outcome"):
            doc["outcome"] = rec["outcome"]
        if rec.get("trace"):
            # the coordinator's record-span context: the participant
            # group's tpc/batch/quorum/exec spans stitch under it
            doc["trace"] = rec["trace"]
        body = json.dumps(doc).encode()
        conn = self._tpc_conns[group]
        try:
            status, _, payload = await conn.request(
                "POST", "/tpc", {}, body)
            return status == 200, payload
        except (IOError, OSError) as e:
            return False, repr(e).encode()

    async def run_transaction(self, ops, client_id: str,
                              command_id: int, trace=None) -> bytes:
        """POST /transaction: partition by the current map; one group
        -> forward the packed transaction unchanged (single-log
        atomicity); several -> 2PC.  ``trace`` is the sampled
        transaction's root context — single-group it rides the
        Property-Trace header, cross-group the coordinator parents its
        per-record spans under it."""
        m = self.shard_map
        parts = partition_ops(m, ops)
        if len(parts) == 1:
            ((g, gops),) = parts.items()
            body = json.dumps([
                {"key": k, "value": v.decode("latin1")}
                for k, v in gops]).encode()
            hdrs = {"Client-Id": client_id,
                    "Command-Id": str(command_id)}
            if trace is not None:
                hdrs["Property-Trace"] = trace.encode()
            conn = self._tpc_conns[g]
            try:
                status, headers, payload = await conn.request(
                    "POST", "/transaction", hdrs, body)
            except (IOError, OSError) as e:
                return _response(500, b"", {"Err": repr(e)})
            if status != 200:
                return _response(status, b"",
                                 {"Err": headers.get("err", "")})
            return _OK_TMPL % len(payload) + payload
        try:
            out: TxnOutcome = await self.coord.run_txn(parts,
                                                       trace=trace)
        except (IOError, OSError) as e:
            # decide unreachable: the outcome is UNKNOWN (participants
            # may hold stages until a recover() pass) — answer 500
            # rather than letting the exception tear the client
            # connection down with its pipeline
            return _response(500, b"",
                             {"Err": f"2pc outcome unknown: {e}"})
        if not out.committed:
            return _response(500, b"", {"Err": out.err or "aborted"})
        # re-assemble prepare-point previous values into op order
        cursor = {g: iter(vals) for g, vals in out.values.items()}
        values = [next(cursor[m.group_of(k)]) for k, _ in ops]
        payload = json.dumps(
            {"ok": True, "txid": out.txid,
             "values": [v.decode("latin1") for v in values]}).encode()
        return _OK_TMPL % len(payload) + payload

    # ---- metrics aggregation -------------------------------------------
    async def metrics_snapshot(self) -> Dict:
        snaps = [self.metrics.snapshot()]
        if self._group_scrape is not None:
            per_group = await self._group_scrape()
            for g, gsnaps in enumerate(per_group):
                for s in gsnaps:
                    snaps.append(label_group(s, g))
        return merge_snapshots(snaps)

    async def spans_snapshot(self) -> List[Dict]:
        """Router spans + every group's node spans, each group's spans
        stamped ``group=<g>`` — the span analog of metrics_snapshot,
        and where a cross-shard 2PC becomes ONE stitched tree: the
        coordinator's record spans (here) and the participant spans
        (scraped) share the transaction's trace id."""
        lists = [self.spans.export()]
        if self._group_scrape_spans is not None:
            per_group = await self._group_scrape_spans()
            for g, gspans in enumerate(per_group):
                lists.append(label_group_spans(gspans, g))
        return merge_spans(lists)

    def close(self) -> None:
        for c in self._conns + self._tpc_conns:
            c.close()


def label_group(snap: Dict, group: int) -> Dict:
    """Stamp ``group=<g>`` into every series of a registry snapshot —
    the ONE aggregation convention for per-group observability."""
    g = str(group)
    return {
        "counters": [dict(c, labels={**c.get("labels", {}), "group": g})
                     for c in snap.get("counters", [])],
        "gauges": [dict(gg, labels={**gg.get("labels", {}),
                                    "group": g})
                   for gg in snap.get("gauges", [])],
        "histograms": [dict(h, labels={**h.get("labels", {}),
                                       "group": g})
                       for h in snap.get("histograms", [])],
    }


class RouterServer:
    """The router's client-facing HTTP endpoint: a pipelined reader/
    writeback pair (host/http.py's split, sized down) whose KV hot
    path enqueues onto the routing core and flushes once per parsed
    burst."""

    PIPELINE_DEPTH = 1024
    REQUEST_TIMEOUT = 10.0

    def __init__(self, router: ShardRouter, addr: str):
        import uuid
        self.router = router
        self.addr = addr
        self._server = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._txn_seq = 0
        # fallback client identity for transactions sent WITHOUT a
        # Client-Id header: unique per router instance, so a router
        # restart (which resets _txn_seq) can never collide with a
        # long-lived group's at-most-once table entries for the old
        # instance's identity
        self._txn_cid = f"router-{uuid.uuid4().hex[:10]}"

    async def start(self) -> None:
        from paxi_tpu_torch.host.transport import parse_addr
        self._loop = asyncio.get_running_loop()
        _, host, port = parse_addr(self.addr)
        self._server = await asyncio.start_server(self._serve, host,
                                                  port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
        self.router.close()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        pending: asyncio.Queue = asyncio.Queue(
            maxsize=self.PIPELINE_DEPTH)
        wtask = asyncio.create_task(self._writeback(pending, writer))
        try:
            while True:
                method, path, headers, body = await read_request(reader)
                slot = await self._route(method, path, headers, body)
                await pending.put(slot)
                if getattr(reader, "_buffer", b""):
                    continue   # more pipelined requests already
                    # buffered: parse them into the same flush
                await self.router.flush()
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            try:
                await self.router.flush()
            except (ConnectionError, OSError):
                pass
            await pending.put(None)
            await wtask
            writer.close()

    async def _writeback(self, pending: asyncio.Queue,
                         writer: asyncio.StreamWriter) -> None:
        out: List[bytes] = []
        broken = False
        while True:
            slot = await pending.get()
            if slot is None:
                break
            if not isinstance(slot, bytes):
                try:
                    slot = await asyncio.wait_for(
                        slot, timeout=self.REQUEST_TIMEOUT)
                except asyncio.TimeoutError:
                    slot = _response(500, b"",
                                     {"Err": "request timed out"})
            out.append(slot)
            if pending.empty() and out and not broken:
                data = b"".join(out)
                out.clear()
                try:
                    writer.write(data)
                    await writer.drain()
                except (ConnectionError, OSError):
                    broken = True

    async def _route(self, method: str, path: str,
                     headers: Dict[str, str], body: bytes):
        url = urlparse(path)
        parts = [p for p in url.path.split("/") if p]
        # the KV hot shape first
        if len(parts) == 1 and method in ("GET", "PUT", "POST"):
            try:
                key = int(parts[0])
            except ValueError:
                return await self._route_slow(method, url, parts,
                                              headers, body)
            value = body if method in ("PUT", "POST") else b""
            if value.startswith(RESERVED_PREFIXES):
                return _response(400, b"",
                                 {"Err": "reserved value prefix"})
            head = [f"{method} /{key} HTTP/1.1",
                    f"Content-Length: {len(value)}",
                    f"Client-Id: {headers.get('client-id', '')}",
                    f"Command-Id: {headers.get('command-id', '0')}"]
            sp = self.router.sample_entry("request", key=str(key))
            if sp is not None:
                # the one place sampling costs anything: the extra
                # header pushes the backend frame off its 4-line fast
                # parse onto the (still cheap) slow path — for sampled
                # requests only
                head.append(f"Property-Trace: {sp.child().encode()}")
            frame = ("\r\n".join(head) + "\r\n\r\n").encode() + value
            return self.router.route_kv(key, frame, self._loop,
                                        span=sp,
                                        write=len(value) > 0)
        return await self._route_slow(method, url, parts, headers, body)

    async def _route_slow(self, method: str, url, parts,
                          headers: Dict[str, str], body: bytes):
        r = self.router
        # per-session ordering: KV ops this connection pipelined ahead
        # of a slow request (e.g. a transaction touching the same key)
        # must reach their groups BEFORE the slow path runs — a
        # transaction completing first would be overwritten by the
        # earlier op's late flush
        await r.flush()
        if parts and parts[0] == "transaction":
            if method != "POST":
                return _response(405, b"", {"Err": "POST only"})
            self._txn_seq += 1
            try:
                ops = [(int(o["key"]),
                        o.get("value", "").encode("latin1"))
                       for o in json.loads(body.decode() or "[]")]
                if not ops:
                    raise ValueError("empty transaction")
                cmd_id = int(headers.get("command-id",
                                         str(self._txn_seq)))
            except (ValueError, KeyError, TypeError,
                    AttributeError) as e:
                return _response(400, b"", {"Err": repr(e)})
            if any(v.startswith(RESERVED_PREFIXES) for _, v in ops):
                # a reserved-prefix op value would execute as a 2PC/
                # migration record at every participant — refuse at
                # the router exactly like the KV surface above
                return _response(400, b"",
                                 {"Err": "reserved value prefix"})
            sp = r.sample_entry("txn", ops=str(len(ops)))
            try:
                return await r.run_transaction(
                    ops, headers.get("client-id", self._txn_cid),
                    cmd_id,
                    trace=None if sp is None else sp.child())
            finally:
                r.spans.finish(sp)
        if parts and parts[0] == "shardmap":
            if len(parts) == 1 and method == "GET":
                return _response(
                    200, json.dumps(r.shard_map.to_json()).encode(),
                    {"Content-Type": "application/json"})
            if len(parts) == 2 and parts[1] == "move" \
                    and method == "POST":
                q = parse_qs(url.query)
                try:
                    new = r.shard_map.move_range(
                        int(q["lo"][0]), int(q["hi"][0]),
                        int(q["group"][0]))
                    r.install_map(new)
                except (KeyError, ValueError, IndexError) as e:
                    return _response(400, b"", {"Err": repr(e)})
                return _response(
                    200, json.dumps(new.to_json()).encode(),
                    {"Content-Type": "application/json"})
            return _response(404)
        if parts and parts[0] == "metrics":
            if method != "GET":
                return _response(405, b"", {"Err": "GET only"})
            snap = await r.metrics_snapshot()
            if parse_qs(url.query).get("format", [""])[0] == "json":
                return _response(200, json.dumps(snap).encode(),
                                 {"Content-Type": "application/json"})
            return _response(
                200, render_prometheus(snap).encode(),
                {"Content-Type":
                 "text/plain; version=0.0.4; charset=utf-8"})
        if parts and parts[0] == "spans":
            # one stitched scrape: router roots + coordinator records
            # + every group's node spans, group-labeled (obs/stitch.py)
            if method != "GET":
                return _response(405, b"", {"Err": "GET only"})
            spans = await r.spans_snapshot()
            if parse_qs(url.query).get("clear", [""])[0] in ("1",
                                                             "true"):
                r.spans.clear()
            return _response(
                200, json.dumps({"node": "router",
                                 "spans": spans}).encode(),
                {"Content-Type": "application/json"})
        return _response(404)
