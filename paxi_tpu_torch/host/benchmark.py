"""Load generators: closed-loop benchmark + open-loop saturation probe.

Reference: paxi benchmark.go — ``Benchmark`` drives ``Bconfig.concurrency``
closed-loop client streams for ``T`` seconds (or ``N`` ops), choosing
keys per ``distribution`` (uniform / conflict / normal / zipfian),
mixing ``W`` writes, optional ``throttle`` ops/s; collects
per-op latency; prints throughput + mean/median/p95/p99; optionally
feeds ``History`` and runs the linearizability check at the end [high].

``OpenLoopBenchmark`` is the half the reference lacks: a closed loop
measures latency at self-limited load (each stream waits for its reply,
so an overloaded server just slows the clients down and the reported
throughput flatters it), while an open loop offers Poisson arrivals at
a TARGET rate whatever the server does, over pipelined connections —
queueing delay shows up in the latency numbers instead of vanishing
into generator back-off (coordinated omission: latency is measured
from the scheduled arrival, not from the eventual submit).  A rate
ramp yields the saturation curve (offered vs achieved vs tail
latency) committed as BENCH_HOST_SATURATION.json.
"""

from __future__ import annotations

import asyncio
import bisect
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from paxi_tpu_torch.core.config import Bconfig, Config
from paxi_tpu_torch.host.client import Client, _Conn
from paxi_tpu_torch.host.history import History
from paxi_tpu_torch.metrics import Histogram, Registry
from paxi_tpu_torch.utils import log


def _wlc():
    """The workload lowering (``workload/compile.py``: ``host_sampler``,
    ``host_rates``, ``surge_steps``), imported when a run is given a
    workload spec: the module imports torch, which serving without a
    spec does not need."""
    from paxi_tpu_torch.workload import compile as wlc
    return wlc


class KeyGen:
    """Key chooser per Bconfig.distribution (benchmark.go generators)."""

    def __init__(self, b: Bconfig, seed: int = 0, stream: int = 0):
        self.b = b
        self.rng = random.Random(seed * 1000 + stream)
        self.stream = stream
        self._mu = b.mu
        self._t0 = time.time()
        if b.distribution == "zipfian":
            # P(k) ∝ 1 / (k + v)^s over k in [0, K)
            weights = [1.0 / math.pow(k + b.zipfian_v, b.zipfian_s)
                       for k in range(b.K)]
            total = sum(weights)
            acc, cdf = 0.0, []
            for w in weights:
                acc += w / total
                cdf.append(acc)
            self._cdf = cdf

    def next(self) -> int:
        b = self.b
        if b.distribution == "uniform":
            return b.min + self.rng.randrange(max(b.K, 1))
        if b.distribution == "conflict":
            if self.rng.random() * 100 < b.conflicts:
                return b.min + self.rng.randrange(max(b.K, 1))
            # non-conflicting: a per-stream private shard above the range
            return b.min + b.K + self.stream * b.K + \
                self.rng.randrange(max(b.K, 1))
        if b.distribution == "normal":
            mu = self._mu
            if b.move:  # drift the mean over time (benchmark.go Move/Speed)
                mu += (time.time() - self._t0) * 1000.0 / max(b.speed, 1)
            k = abs(int(self.rng.gauss(mu, b.sigma))) % max(b.K, 1)
            return b.min + k
        if b.distribution == "zipfian":
            return b.min + bisect.bisect_left(self._cdf, self.rng.random())
        raise ValueError(f"unknown distribution {b.distribution!r}")


@dataclass
class Stats:
    """Latency/throughput summary (benchmark.go stat output).

    Per-op latency lives in a fixed-bucket mergeable histogram
    (metrics/) instead of an unbounded list — O(1) memory per
    stream however long the run, and percentiles derive from buckets
    (exact to one bucket's width, with exact min/max/mean)."""

    ops: int
    errors: int
    duration: float
    hist: Histogram = field(repr=False, default_factory=Histogram)
    anomalies: Optional[int] = None
    # ops completed inside the warmup window (Bconfig.warmup): counted
    # separately so throughput/latency are steady-state — the host
    # analog of bench.py's compile_s/warmup_s split
    warmup_s: float = 0.0
    warmup_ops: int = 0

    @staticmethod
    def _pct(sorted_lat: List[float], p: float) -> float:
        """Exact nearest-rank percentile of a sorted sample: the
        smallest element with cumulative frequency >= p% — index
        ceil(p/100*n)-1."""
        if not sorted_lat:
            return 0.0
        i = max(math.ceil(p / 100.0 * len(sorted_lat)) - 1, 0)
        return sorted_lat[min(i, len(sorted_lat) - 1)]

    def summary(self) -> Dict[str, float]:
        h = self.hist
        steady = max(self.duration - self.warmup_s, 1e-9)
        return {
            "ops": self.ops,
            "errors": self.errors,
            "duration_s": round(self.duration, 3),
            # steady-state: warmup-window completions excluded from both
            # numerator and denominator
            "throughput_ops_s": round(self.ops / steady, 1)
            if self.duration > 0 else 0.0,
            **({"warmup_s": self.warmup_s, "warmup_ops": self.warmup_ops,
                "total_ops": self.ops + self.warmup_ops}
               if self.warmup_s > 0 else {}),
            "latency_mean_ms": round(h.mean() * 1e3, 3),
            "latency_p50_ms": round(h.percentile(50) * 1e3, 3),
            "latency_p95_ms": round(h.percentile(95) * 1e3, 3),
            "latency_p99_ms": round(h.percentile(99) * 1e3, 3),
            "latency_min_ms": round(h.min * 1e3, 3),
            "latency_max_ms": round(h.max * 1e3, 3),
            **({"anomalies": self.anomalies}
               if self.anomalies is not None else {}),
        }


class Benchmark:
    """Closed-loop load against a cluster via the REST client."""

    def __init__(self, cfg: Config, b: Optional[Bconfig] = None,
                 seed: int = 0, workload=None):
        self.cfg = cfg
        self.b = b or cfg.benchmark
        self.seed = seed
        self.history = History()
        # per-run registry: per-stream latency series + client op/retry
        # counters; bench_host.py embeds its snapshot in the artifact
        self.metrics = Registry(source="bench")
        # declarative workload spec (workload/): replaces the
        # KeyGen/W draws with the spec's counter-based host sampler, so
        # the SAME spec drives this generator and the sim kernels
        self.workload = (workload.validate(self.b.K)
                         if workload is not None else None)

    async def run(self) -> Stats:
        b = self.b
        stats = Stats(ops=0, errors=0, duration=0.0,
                      warmup_s=max(b.warmup, 0.0))
        stop_at = time.time() + b.T if b.T > 0 else None
        left = b.N if b.T <= 0 else None
        t0 = time.time()
        warm_until = t0 + stats.warmup_s

        async def stream(si: int):
            nonlocal left
            gen = KeyGen(b, self.seed, si)
            rng = random.Random(self.seed * 77 + si)
            # workload spec mode: the spec's deterministic per-stream
            # sampler supplies (key, write, class); per-class latency
            # series land beside the per-stream one in the registry
            wlc = _wlc() if self.workload is not None else None
            sampler = (wlc.host_sampler(self.workload, b.K, stream=si)
                       if self.workload is not None else None)
            class_hists = {
                c: self.metrics.histogram("paxi_op_seconds",
                                          stream=str(si), key_class=c)
                for c in wlc.CLASSES} if sampler is not None else None
            client = Client(self.cfg,
                            id=self.cfg.ids[si % len(self.cfg.ids)],
                            client_id=f"bench-{si}",
                            metrics=self.metrics)
            # one latency series per stream; merged into stats.hist at
            # stream end (exact: shared bucket layout)
            hist = self.metrics.histogram("paxi_op_seconds",
                                          stream=str(si))
            n_local = 0
            try:
                while True:
                    if stop_at is not None and time.time() >= stop_at:
                        break
                    # no await between check and decrement => atomic in
                    # single-threaded asyncio
                    if left is not None:
                        if left <= 0:
                            break
                        left -= 1
                    if sampler is None:
                        key = gen.next()
                        write = rng.random() < b.W
                        kcls = None
                    else:
                        k0, write, kcls = sampler(n_local)
                        key = b.min + k0
                    n_local += 1
                    value = f"{si}:{n_local}".encode() if write else b""
                    s = time.time()
                    try:
                        if write:
                            await client.put(key, value)
                            out = None
                        else:
                            out = await client.get(key)
                        e = time.time()
                        if e < warm_until:
                            # warmup window: dial-up + election +
                            # batch ramp — kept out of steady stats
                            stats.warmup_ops += 1
                        else:
                            hist.observe(e - s)
                            if kcls is not None:
                                class_hists[kcls].observe(e - s)
                            stats.ops += 1
                        if b.linearizability_check:
                            self.history.add(
                                key, value if write else None,
                                out if not write else None, s, e)
                    except asyncio.CancelledError:
                        raise
                    except Exception as ex:
                        stats.errors += 1
                        log.debugf("bench op error: %r", ex)
                        if b.linearizability_check and write:
                            # a failed write may still commit later:
                            # record it with an open end time so reads
                            # of its value aren't flagged as anomalies
                            self.history.add(key, value, None, s,
                                             math.inf)
                    if b.throttle > 0:
                        await asyncio.sleep(
                            b.concurrency / b.throttle)
            finally:
                stats.hist.merge(hist)
                client.close()

        await asyncio.gather(*(stream(i) for i in range(b.concurrency)))
        stats.duration = time.time() - t0
        if b.linearizability_check:
            stats.anomalies = self.history.linearizable()
        return stats


class OpenLoopBenchmark:
    """Open-loop saturation probe: Poisson arrivals at a ramp of target
    rates over pipelined HTTP connections (module docstring).

    Every op is submitted when its arrival fires, whether or not
    earlier ops completed (in-flight is capped only to bound memory at
    deep over-saturation; ops shed at the cap are counted, never
    silently skipped).  Latency is measured from the SCHEDULED arrival,
    so rate-mismatch queueing is visible.  The whole run feeds one
    History; one linearizability verdict covers every rate step.
    """

    # submissions buffered per connection before a flush is forced (a
    # flush also fires whenever the generator sleeps)
    FLUSH_EVERY = 32

    def __init__(self, cfg: Config, rates: List[float],
                 step_s: float = 3.0, seed: int = 0, conns: int = 4,
                 W: float = 0.5, K: int = 1024,
                 max_inflight: int = 4096,
                 target: Optional[object] = None,
                 drain_s: float = 5.0,
                 linearizability_check: bool = True,
                 key_base: int = 0, client_tag: str = "ol",
                 ops_per_req: int = 1, key_map=None,
                 workload=None, wl_stream: int = 0):
        self.cfg = cfg
        self.rates = list(rates)
        self.step_s = step_s
        self.seed = seed
        self.n_conns = max(int(conns), 1)
        self.W = W
        self.K = max(int(K), 1)
        # parallel generator workers get disjoint key ranges + client
        # tags: per-key register linearizability composes across
        # workers, so each checks its own slice and the verdicts sum
        self.key_base = int(key_base)
        self.client_tag = client_tag
        # optional key-shape hook (shard ramp: disjoint-then-crossing
        # ranges over a ShardMap): draws j in [0, K) map to
        # ``key_map(j)`` instead of ``key_base + j``.  The map must be
        # injective so per-worker key slices stay disjoint and the
        # per-key linearizability verdicts still compose.
        self.key_map = key_map
        self.max_inflight = max_inflight
        self.drain_s = drain_s
        self.lin = linearizability_check
        # client-side command batching (HT-Paxos's other half): each
        # HTTP request carries this many independent KV commands over
        # the Transaction surface — one log slot, one reply, the whole
        # serving stack amortized.  1 = plain per-op REST.
        self.ops_per_req = max(int(ops_per_req), 1)
        # all connections target ONE node (it becomes the stable
        # leader, so no per-request forwarding hop muddies the curve)
        ids = cfg.ids
        self.target = ids[0] if target is None else target
        self.history = History()
        self.metrics = Registry(source="bench_open_loop")
        # declarative workload spec (workload/): key/write/class
        # come from the spec's counter-based sampler (stream
        # ``wl_stream`` — parallel workers pass distinct streams so
        # their draws are independent but each is deterministic), the
        # ramp's offered rates gain the spec's flash-crowd multipliers
        # (host_rates), and surge steps re-aim FlashCrowd.focus of the
        # draws at the hot set.  Composes with key_map/key_base the
        # same way the uniform draw does.
        self.workload = (workload.validate(self.K)
                         if workload is not None else None)
        self.wl_stream = int(wl_stream)
        self._wl_n = 0          # op counter across the whole ramp

    async def run(self) -> Dict:
        url = self.cfg.http_addrs[self.target]
        conns = [_Conn(url) for _ in range(self.n_conns)]
        for c in conns:
            await c.ensure()
        rng = random.Random(self.seed)
        inflight = [0]
        cmd_ids = [0] * self.n_conns
        steps: List[Dict] = []
        # flash-crowd lowering for the open loop: surge ramp steps
        # offer mult*rate (the arrival-surge half) and focus-bias the
        # key draws (the hot-spot half); flat tuples for flashless specs
        wl = self.workload
        wlc = _wlc() if wl is not None else None
        eff_rates = (wlc.host_rates(wl, self.rates) if wl is not None
                     else list(self.rates))
        surges = (wlc.surge_steps(wl, len(self.rates)) if wl is not None
                  else [False] * len(self.rates))
        try:
            for si, rate in enumerate(eff_rates):
                steps.append(await self._one_rate(
                    rate, conns, rng, inflight, cmd_ids,
                    surge=surges[si], ramp_i=si))
        finally:
            for c in conns:
                c.close()
        anomalies = self.history.linearizable() if self.lin else None
        achieved = [s["achieved_ops_s"] for s in steps]
        peak = max(range(len(steps)), key=lambda i: achieved[i]) \
            if steps else None
        return {
            "mode": "open-loop",
            "target": str(self.target),
            "conns": self.n_conns,
            "W": self.W,
            "K": self.K,
            "steps": steps,
            "peak_ops_s": achieved[peak] if steps else 0.0,
            "peak_offered_ops_s": steps[peak]["offered_ops_s"]
            if steps else 0.0,
            "total_completed": sum(s["completed"] for s in steps),
            "total_errors": sum(s["errors"] for s in steps),
            "total_shed": sum(s["shed"] for s in steps),
            "anomalies": anomalies,
            "history_ops": len(self.history),
            **({"workload": wl.name,
                "surge_steps": [i for i, s in enumerate(surges) if s]}
               if wl is not None else {}),
            # per-rate latency histograms (mergeable across parallel
            # generator workers — shared bucket layout)
            "metrics": self.metrics.snapshot(),
        }

    @staticmethod
    async def _safe_flush(conn: _Conn) -> None:
        """Flush; a broken connection reconnects for the NEXT ops (the
        in-flight ones fail over the dead reader task and count as
        errors — open loop sheds work, it never stalls)."""
        try:
            await conn.flush()
        except (ConnectionError, OSError):
            try:
                await conn.ensure()
            except OSError:
                pass

    async def _one_rate(self, rate: float, conns, rng, inflight,
                        cmd_ids, surge: bool = False,
                        ramp_i: int = 0) -> Dict:
        hist = self.metrics.histogram("paxi_op_seconds", rate=str(rate))
        stat = {"offered_ops_s": rate, "duration_s": self.step_s,
                "submitted": 0, "completed": 0, "errors": 0, "shed": 0,
                "unfinished": 0}
        if surge:
            stat["surge"] = True
        # workload spec mode (see __init__): deterministic sampler per
        # (spec, stream, op index), per-class latency series beside the
        # per-rate one, migration epoch = ramp position
        wl = self.workload
        wlc = _wlc() if wl is not None else None
        sampler = (wlc.host_sampler(wl, self.K, stream=self.wl_stream)
                   if wl is not None else None)
        class_hists = {
            c: self.metrics.histogram("paxi_op_seconds", rate=str(rate),
                                      key_class=c)
            for c in wlc.CLASSES} if sampler is not None else None
        wl_epoch = ramp_i if (wl is not None and wl.migrate_every > 0) \
            else 0
        step_open = [0]     # this step's in-flight ops
        closed = [False]    # set when the step's books close: later
        # completions still balance the in-flight counters and feed the
        # history (the checker needs every write that really happened),
        # but no longer move this step's throughput/latency stats
        # locals bound once: issue() and done() run per op
        n_conns = self.n_conns
        K, W, lin = self.K, self.W, self.lin
        key_base = self.key_base
        key_map = self.key_map
        history_add = self.history.add
        observe = hist.observe
        randrange, random_, expovariate = (rng.randrange, rng.random,
                                           rng.expovariate)
        wall = time.time
        # request bytes from templates: one % plus one append per op
        cid = self.client_tag.encode()
        put_tmpl = (b"PUT /%d HTTP/1.1\r\nContent-Length: %d\r\n"
                    b"Client-Id: " + cid + b"%d\r\n"
                    b"Command-Id: %d\r\n\r\n%s")
        get_tmpl = (b"GET /%d HTTP/1.1\r\nContent-Length: 0\r\n"
                    b"Client-Id: " + cid + b"%d\r\n"
                    b"Command-Id: %d\r\n\r\n")

        B = self.ops_per_req
        txn_tmpl = (b"POST /transaction HTTP/1.1\r\n"
                    b"Content-Length: %d\r\n"
                    b"Client-Id: " + cid + b"%d\r\n"
                    b"Command-Id: %d\r\n\r\n%s")
        json_loads = __import__("json").loads

        # one draw = (wire key, write?, key class | None); the workload
        # path threads the spec sampler through the same key_map /
        # key_base shaping as the uniform path
        if sampler is None:
            def draw():
                j = randrange(K)
                return ((key_map(j) if key_map is not None
                         else key_base + j), random_() < W, None)
        else:
            def draw(_s=surge, _ep=wl_epoch):
                self._wl_n += 1
                j, w, c = sampler(self._wl_n, surge=_s, epoch=_ep)
                return ((key_map(j) if key_map is not None
                         else key_base + j), w, c)

        def issue_batched(sched_t: float) -> None:
            """One arrival = one request of B independent commands on
            the Transaction surface (client-side batching)."""
            stat["submitted"] += B
            if inflight[0] >= self.max_inflight:
                stat["shed"] += B
                return
            ci = (stat["submitted"] // B) % n_conns
            conn = conns[ci]
            cmd_ids[ci] += 1
            wid = cmd_ids[ci]
            parts = []
            ops_meta = []
            for j in range(B):
                key, is_w, kcls = draw()
                if is_w:
                    v = "%d:%d:%d" % (ci, wid, j)
                    parts.append('{"key":%d,"value":"%s"}' % (key, v))
                    ops_meta.append((key, v.encode(), kcls))
                else:
                    parts.append('{"key":%d}' % key)
                    ops_meta.append((key, None, kcls))
            body = ("[" + ",".join(parts) + "]").encode()
            inflight[0] += B
            step_open[0] += 1
            submit_wall = wall()

            def done(status, _hdr, payload, exc, _ops=ops_meta,
                     _sched=sched_t, _sw=submit_wall):
                inflight[0] -= B
                step_open[0] -= 1
                now = wall()
                if exc is not None or status != 200:
                    if not closed[0]:
                        stat["errors"] += B
                    if lin:
                        for k, v, _c in _ops:
                            if v is not None:
                                history_add(k, v, None, _sw, math.inf)
                    return
                if not closed[0]:
                    stat["completed"] += B
                    observe(now - _sched)   # request latency, B cmds
                    if class_hists is not None:
                        for _k, _v, _c in _ops:
                            class_hists[_c].observe(now - _sched)
                if lin:
                    vals = json_loads(payload)["values"]
                    for j, (k, v, _c) in enumerate(_ops):
                        if v is None:
                            history_add(k, None,
                                        vals[j].encode("latin1"),
                                        _sw, now)
                        else:
                            history_add(k, v, None, _sw, now)

            conn.submit_raw(txn_tmpl % (len(body), ci, wid, body), done)

        def issue(sched_t: float) -> None:
            stat["submitted"] += 1
            if inflight[0] >= self.max_inflight:
                stat["shed"] += 1
                return
            ci = stat["submitted"] % n_conns
            conn = conns[ci]
            cmd_ids[ci] += 1
            cmd_id = cmd_ids[ci]
            key, write, kcls = draw()
            # unique value per write: read-from edges in the checker
            # are unambiguous, and the per-conn (client, command_id)
            # stream is monotonic for the server's at-most-once table
            if write:
                value = b"%d:%d" % (ci, cmd_id)
                frame = put_tmpl % (key, len(value), ci, cmd_id, value)
            else:
                value = b""
                frame = get_tmpl % (key, ci, cmd_id)
            inflight[0] += 1
            step_open[0] += 1
            submit_wall = wall()

            def done(status, _hdr, payload, exc, _k=key,
                     _v=value if write else None, _sched=sched_t,
                     _sw=submit_wall, _c=kcls):
                inflight[0] -= 1
                step_open[0] -= 1
                now = wall()
                if exc is not None or status != 200:
                    if not closed[0]:
                        stat["errors"] += 1
                    if lin and _v is not None:
                        # a failed/timed-out write may still commit:
                        # open end time (host/history.py convention)
                        history_add(_k, _v, None, _sw, math.inf)
                    return
                if not closed[0]:
                    stat["completed"] += 1
                    observe(now - _sched)   # includes queueing delay
                    if _c is not None:
                        class_hists[_c].observe(now - _sched)
                if lin:
                    history_add(_k, _v, payload if _v is None else None,
                                _sw, now)

            conn.submit_raw(frame, done)

        async def flush_full(force: bool) -> None:
            for c in conns:
                if c.pending_out >= (1 if force else self.FLUSH_EVERY):
                    await self._safe_flush(c)

        if B > 1:
            issue = issue_batched
            rate = rate / B      # arrivals are REQUESTS of B commands
        start = time.monotonic()
        wall0 = time.time()
        end = start + self.step_s
        next_t = start + expovariate(rate)
        while True:
            now = time.monotonic()
            if now >= end:
                break
            burst = 0
            while next_t <= now and next_t < end:
                issue(wall0 + (next_t - start))
                next_t += expovariate(rate)
                burst += 1
                if burst % self.FLUSH_EVERY == 0:
                    await flush_full(False)
            await flush_full(True)
            await asyncio.sleep(min(max(next_t - time.monotonic(), 0.0005),
                                    0.005))
        # catch-up: arrivals scheduled before the step boundary that the
        # loop didn't reach (congested event loop) are still offered
        # load — submit them late rather than under-reporting `offered`
        while next_t < end:
            issue(wall0 + (next_t - start))
            next_t += expovariate(rate)
            if stat["submitted"] % self.FLUSH_EVERY == 0:
                await flush_full(False)
        await flush_full(True)
        # grace window for stragglers of THIS step; anything past the
        # drain window is reported, not silently forgotten (its late
        # completion still decrements in-flight and feeds the history).
        # Completions during the drain COUNT, so the drain time joins
        # the denominator — a saturated backlog cannot inflate the
        # reported rate by completing "for free" after the boundary.
        drain_t0 = time.monotonic()
        deadline = drain_t0 + self.drain_s
        while step_open[0] > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        stat["unfinished"] = step_open[0]
        closed[0] = True
        dur = self.step_s + (time.monotonic() - drain_t0)
        stat["duration_s"] = round(dur, 3)
        stat["achieved_ops_s"] = round(stat["completed"] / dur, 1)
        stat["latency_ms"] = {
            "mean": round(hist.mean() * 1e3, 3),
            "p50": round(hist.percentile(50) * 1e3, 3),
            "p95": round(hist.percentile(95) * 1e3, 3),
            "p99": round(hist.percentile(99) * 1e3, 3),
            "max": round(hist.max * 1e3, 3),
        }
        if class_hists is not None:
            # per-key-class tail split (the host face of the sim's
            # m_wl_hist_* planes; full series stay in the registry)
            stat["key_class_latency"] = {
                c: {"n": h.count,
                    "p50_ms": round(h.percentile(50) * 1e3, 3),
                    "p99_ms": round(h.percentile(99) * 1e3, 3)}
                for c, h in class_hists.items()}
        return stat
