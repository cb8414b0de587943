"""Open-loop shard ramp: aggregate cmds/s vs shard count.

The compartmentalization claim ("Bipartisan Paxos", "HT-Paxos",
PAPERS.md) made measurable end-to-end: a FIXED fleet of replicas is
partitioned into G independent consensus groups behind the shard
router, and the same Poisson open-loop ramp (host/benchmark.py) is
offered to the one router endpoint for G in {1, 2, 4}.  Aggregate
throughput rises with G because the bottleneck role — the group
leader, whose per-command replication work fans out to n-1 followers
— is replicated while each instance's fan-in shrinks (fleet/G - 1
followers per leader); past that the bottleneck visibly MOVES to the
shared router/serving tier, which is the papers' point.

Workers get **disjoint-then-crossing key ranges**: phase A pins each
worker's range inside one group (traffic partitions perfectly — the
scaling ceiling), phase B re-points every worker at a range STRIDING
all G groups (every worker hits every group through the same router
conns — the realistic mixed case).  Ranges stay disjoint across
workers in both phases, so each worker's per-key linearizability
verdict composes and the run-level anomaly count is their sum.

Every run ends with a burst of cross-shard transactions through the
router's 2PC path and an **atomicity oracle** sweep: for each txn,
linearizable readback of every op key must show the txn's writes
everywhere or nowhere (shard/txn.atomic_check).

``migrate=True`` inserts a **migrate** phase after the ramp: paced
per-key-sequential traffic concentrates on group 0's range, a
Rebalancer reads the router's own load evidence to pick the split
point (deterministic midpoint fallback), and the coordinator streams
the NON-EMPTY range to the least-loaded group LIVE — under the
double-write fence, with per-key strict read-your-writes checking
through the whole window.  The phase row reports
``migration_blip_p99_ms`` (completion p99 inside the move window) vs
the steady-state p99, plus a seeded-keys readback oracle proving the
moved range arrived intact.  ``routers=N`` spreads the phase's
workers over N router endpoints (keys stay per-worker-disjoint, so
one key always flows through one router and the verdicts compose).
"""

from __future__ import annotations

import asyncio
import json
import random
import time
from typing import Dict, List, Optional

from paxi_tpu_torch.core.config import Config
from paxi_tpu_torch.core.ident import ID
from paxi_tpu_torch.host.benchmark import OpenLoopBenchmark
from paxi_tpu_torch.host.client import _Conn
from paxi_tpu_torch.shard.cluster import ShardedCluster
from paxi_tpu_torch.shard.txn import atomic_check


def _router_cfg(url: str) -> Config:
    """A one-entry Config so OpenLoopBenchmark can target the router
    like any node."""
    cfg = Config()
    cfg.addrs[ID("1.1")] = url
    cfg.http_addrs[ID("1.1")] = url
    return cfg


def worker_key_maps(shard_map, G: int, workers: int, K: int):
    """Per-worker injective key maps for both phases.

    disjoint: worker w draws from a K-key block inside group
    ``w % G``'s range.  crossing: worker w's j-th key lands in group
    ``j % G`` (upper half of each group's range, clear of the
    disjoint blocks), so every worker drives every group."""
    span = shard_map.span
    gsize = span // G
    maps = []
    kc = K // G + 1
    for w in range(workers):
        lo = (w % G) * gsize + (w // G) * K
        half = gsize // 2
        maps.append({
            "disjoint": (lambda j, _lo=lo: _lo + j),
            "crossing": (lambda j, _w=w, _g=G, _gs=gsize, _h=half,
                         _kc=kc: (j % _g) * _gs + _h + _w * _kc
                         + j // _g),
        })
    return maps


async def _txn_shots(router_url: str, shard_map, G: int, n_txns: int
                     ) -> Dict:
    """Cross-shard 2PC burst + atomicity oracle readback."""
    conn = _Conn(router_url)
    span, gsize = shard_map.span, shard_map.span // G
    committed = aborted = errors = 0
    shots = []
    try:
        for t in range(n_txns):
            # one fresh key per group, top slice of each range
            ops = [{"key": g * gsize + gsize - 512 + t,
                    "value": f"txn{t}:g{g}"} for g in range(G)]
            try:
                status, _, payload = await conn.request(
                    "POST", "/transaction",
                    {"Client-Id": "tpcshot",
                     "Command-Id": str(t + 1)},
                    json.dumps(ops).encode())
            except (IOError, OSError):
                errors += 1
                continue
            if status == 200:
                committed += 1
            else:
                aborted += 1
            shots.append(ops)
        atomic = violations = 0
        chk_cmd = 0
        for ops in shots:
            pairs: Dict[int, list] = {}
            for o in ops:
                # unique Command-Id per readback: a reused id would hit
                # the groups' at-most-once tables and replay the FIRST
                # readback's value, silently blinding the oracle
                chk_cmd += 1
                try:
                    st, _, obs = await conn.request(
                        "GET", f"/{o['key']}",
                        {"Client-Id": "tpcchk",
                         "Command-Id": str(chk_cmd)},
                        b"")
                except (IOError, OSError):
                    st, obs = 0, b""
                g = shard_map.group_of(o["key"])
                pairs.setdefault(g, []).append(
                    (o["value"].encode(), obs if st == 200 else b""))
            if atomic_check(pairs):
                atomic += 1
            else:
                violations += 1
    finally:
        conn.close()
    return {"txns": len(shots), "committed": committed,
            "aborted": aborted, "errors": errors, "atomic": atomic,
            "atomicity_violations": violations}


async def shard_ramp(algorithm: str = "paxos", shards: int = 2,
                     fleet: int = 12, workers: int = 4,
                     rates: Optional[List[float]] = None,
                     step_s: float = 3.0, K: int = 256, W: float = 0.5,
                     seed: int = 0, base_port: int = 18300,
                     txns: int = 8, lin: bool = True,
                     proc: bool = False, conns: int = 2,
                     drain_s: float = 4.0,
                     workload: str = "", migrate: bool = False,
                     routers: int = 1) -> Dict:
    """One G-point of the curve: ramp both phases, fire the 2PC burst,
    return the artifact row.

    ``workload``: name of a workload/ spec (e.g. hotrange,
    zipf99).  Adds a third "hot" phase where every worker draws keys
    from the spec's sampler and a LINEAR key map stretches [0, K) over
    the whole keyspace — the spec's hot ranks land inside group 0's
    range while the tail spreads across all groups, so skew shows up
    directly as per-group load imbalance in the router's
    ``paxi_router_group_commands_total`` counters (reported under
    ``router.group_commands`` with the hot group's share)."""
    G = shards
    if fleet % G:
        raise ValueError(f"fleet {fleet} not divisible into {G} groups")
    if migrate and G < 2:
        raise ValueError("migrate phase needs at least 2 groups")
    n = fleet // G
    rates = rates or [2000.0, 5000.0, 10000.0]
    sc = ShardedCluster(algorithm, groups=G, n=n, base_port=base_port,
                        router_port=base_port + 98, proc=proc,
                        routers=routers)
    await sc.start()
    try:
        rcfg = _router_cfg(sc.router_url)
        maps = worker_key_maps(sc.map, G, workers, K)

        async def phase(name: str) -> List[Dict]:
            traj: List[Dict] = []
            sampler = asyncio.ensure_future(
                _gauge_sampler(sc.router, traj))
            try:
                outs = await asyncio.gather(*[
                    OpenLoopBenchmark(
                        rcfg, rates=[r / workers for r in rates],
                        step_s=step_s, seed=seed + 101 * w, conns=conns,
                        W=W, K=K, client_tag=f"{name[:1]}{w}w",
                        linearizability_check=lin, drain_s=drain_s,
                        key_map=maps[w][name]).run()
                    for w in range(workers)])
            finally:
                sampler.cancel()
                try:
                    await sampler
                except asyncio.CancelledError:
                    pass
            steps = []
            for i, r in enumerate(rates):
                steps.append({
                    "offered_ops_s": r,
                    "achieved_ops_s": round(sum(
                        o["steps"][i]["achieved_ops_s"]
                        for o in outs), 1),
                    "completed": sum(o["steps"][i]["completed"]
                                     for o in outs),
                    "errors": sum(o["steps"][i]["errors"]
                                  for o in outs),
                    "shed": sum(o["steps"][i]["shed"] for o in outs),
                    "latency_p50_ms": round(max(
                        o["steps"][i]["latency_ms"]["p50"]
                        for o in outs), 3),
                    "latency_p99_ms": round(max(
                        o["steps"][i]["latency_ms"]["p99"]
                        for o in outs), 3),
                })
            return [{"phase": name, "steps": steps,
                     "anomalies": (sum(o["anomalies"] or 0
                                       for o in outs) if lin else None),
                     "peak_ops_s": max(s["achieved_ops_s"]
                                       for s in steps),
                     "router_gauges": _traj_report(traj)}]

        phases = await phase("disjoint") + await phase("crossing")
        if migrate:
            phases += await _migrate_phase(
                sc, rate=rates[0], run_s=max(3 * step_s, 4.0),
                workers=workers, seed=seed)
        group_fwd_base: Dict[str, int] = {}
        if workload:
            # snapshot per-group counters BEFORE the hot phase so its
            # row reports only hot-phase routing, not the ramp's
            group_fwd_base = _group_counters(
                await sc.router.metrics_snapshot())
            phases += await _hot_phase(
                workload, rcfg, sc.map, rates, workers, step_s, seed,
                conns, W, K, drain_s)
        # G == 1 exercises the single-group packed-transaction path
        # (same surface, single-log atomicity); G > 1 runs real 2PC.
        # The oracle reads the ROUTER's live map: after a migrate
        # phase the boot map no longer describes ownership.
        txn_report = await _txn_shots(sc.router_url,
                                      sc.router.shard_map, G, txns) \
            if txns > 0 else None
        router_metrics = await sc.router.metrics_snapshot()
        peak = max(p["peak_ops_s"] for p in phases)
        router_report = {
            "forwards": _counter(router_metrics,
                                 "paxi_router_forwards_total"),
            "stale_reroutes": _counter(
                router_metrics, "paxi_router_stale_reroutes_total"),
            "map_swaps": _counter(router_metrics,
                                  "paxi_router_map_swaps_total"),
            "group_commands": _group_counters(router_metrics),
            # drained endpoint: both gauges must have settled to zero
            "pending_depth": _gauge_values(
                router_metrics, "paxi_router_pending_depth"),
            "inflight": _gauge_values(router_metrics,
                                      "paxi_router_inflight"),
        }
        if workload:
            total = _group_counters(router_metrics)
            hot = {g: total.get(g, 0) - group_fwd_base.get(g, 0)
                   for g in sorted(total)}
            hot_sum = sum(hot.values())
            router_report["hot_phase_group_commands"] = hot
            router_report["hot_group_share"] = round(
                max(hot.values()) / hot_sum, 3) if hot_sum else 0.0
        return {
            "mode": "shard-ramp",
            "algorithm": algorithm,
            "shards": G,
            "fleet": fleet,
            "replicas_per_group": n,
            "workers": workers,
            "W": W, "K": K,
            "cluster_proc": proc,
            **({"routers": routers} if routers > 1 else {}),
            **({"workload": workload} if workload else {}),
            "phases": phases,
            "aggregate_peak_ops_s": peak,
            "anomalies": (sum(p["anomalies"] or 0 for p in phases)
                          if lin else None),
            "txn": txn_report,
            "router": router_report,
        }
    finally:
        await sc.stop()


def _p(lat: List[float], q: float) -> float:
    if not lat:
        return 0.0
    s = sorted(lat)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]


async def _migrate_phase(sc: ShardedCluster, rate: float,
                         run_s: float, workers: int,
                         seed: int) -> List[Dict]:
    """The live-migration phase: hot-range traffic, a mid-phase
    Rebalancer-chosen split + streamed move of a NON-EMPTY range, and
    the blip/oracle evidence for the artifact.

    Every worker owns a disjoint key set in the upper quarter of
    group 0's range and runs ONE op at a time (write then read-your-
    write), so each key has a single sequential client and a read
    returning anything but the last acked write is a hard anomaly —
    the strictest per-key check there is, held THROUGH the move
    window.  Oracle keys seeded above all traffic keys guarantee the
    moved slice is non-empty and its bytes survive the stream."""
    from paxi_tpu_torch.shard.migrate import Rebalancer
    G, span = sc.G, sc.map.span
    gsize = span // G
    hot_hi = gsize                      # group 0's range is [0, gsize)
    urls = sc.router_urls
    # traffic keys: upper quarter of the hot range, per-worker blocks,
    # capped below the oracle strip
    base = (hot_hi * 3) // 4
    keys_of = [[base + w * 1024 + j * 8 for j in range(8)]
               for w in range(workers)]
    assert max(max(ks) for ks in keys_of) < hot_hi - 512
    # oracle keys: the very top of the range, above every traffic key,
    # so ANY load-median cut moves them — written once before the
    # move, untouched during it, read back after
    oracle = {hot_hi - 256 + i: f"mig-oracle-{i}".encode()
              for i in range(16)}
    conn = _Conn(sc.router_url)
    try:
        for i, (k, v) in enumerate(sorted(oracle.items())):
            st, _, _ = await conn.request(
                "PUT", f"/{k}", {"Client-Id": "migseed",
                                 "Command-Id": str(i + 1)}, v)
            if st != 200:
                raise RuntimeError(f"oracle seed write failed on {k}")
    finally:
        conn.close()

    t0 = time.monotonic()
    window = {"t_start": None, "t_end": None, "plan": None,
              "status": None, "fallback": False}
    stop = asyncio.Event()

    async def worker(w: int) -> Dict:
        wconn = _Conn(urls[w % len(urls)])
        rnd = random.Random(seed + 31 * w)
        vals: Dict[int, Optional[bytes]] = {}
        samples: List = []
        anomalies = errors = completed = 0
        cmd = 0
        per_op = workers / max(rate, 1.0)
        try:
            while not stop.is_set():
                k = rnd.choice(keys_of[w])
                cmd += 1
                t1 = time.monotonic()
                try:
                    if k not in vals or rnd.random() < 0.5:
                        v = f"w{w}c{cmd}".encode()
                        st, _, _ = await wconn.request(
                            "PUT", f"/{k}",
                            {"Client-Id": f"mg{w}",
                             "Command-Id": str(cmd)}, v)
                        if st == 200:
                            vals[k] = v
                        else:
                            # the write MAY have landed on one side:
                            # suspend this key's check until the next
                            # acked write re-anchors it
                            vals[k] = None
                            errors += 1
                    else:
                        st, _, obs = await wconn.request(
                            "GET", f"/{k}",
                            {"Client-Id": f"mg{w}",
                             "Command-Id": str(cmd)}, b"")
                        if st != 200:
                            errors += 1
                        elif vals.get(k) is not None \
                                and obs != vals[k]:
                            anomalies += 1
                except (IOError, OSError):
                    errors += 1
                    vals[k] = None
                t2 = time.monotonic()
                completed += 1
                samples.append((t2, (t2 - t1) * 1000.0))
                # fixed-interval pacing (closed loop + rate-derived
                # sleep): offered rate is approximate, which is fine
                # for a blip window — and no clock value ever steers
                # control flow (PXD141)
                await asyncio.sleep(per_op)
        finally:
            wconn.close()
        return {"samples": samples, "anomalies": anomalies,
                "errors": errors, "completed": completed,
                "vals": vals}

    async def mover() -> None:
        await asyncio.sleep(run_s * 0.3)
        # the split decision off the router's OWN evidence: command
        # deltas + the 64-bucket key histogram, with short hysteresis
        reb = Rebalancer(hot_share=0.5, min_ticks=2, min_cmds=10,
                         cooldown=0)
        sc.router.bucket_hits(reset=True)
        last = [c.value for c in sc.router._group_fwd]
        plan = None
        for _ in range(10):
            await asyncio.sleep(max(0.15, run_s * 0.02))
            cur = [c.value for c in sc.router._group_fwd]
            deltas = [a - b for a, b in zip(cur, last)]
            last = cur
            plan = reb.tick(sc.router.shard_map, deltas,
                            sc.router.bucket_hits(reset=True))
            if plan is not None:
                break
        if plan is None or plan.get("action") != "split" \
                or plan.get("src") != 0:
            # deterministic fallback: cut the hot range at the floor
            # of the traffic band so every live key moves too
            plan = {"action": "split", "lo": base - 64, "hi": hot_hi,
                    "src": 0, "dst": 1}
            window["fallback"] = True
        mig = sc.migrator(chunk=48)
        window["plan"] = plan
        window["t_start"] = time.monotonic()
        window["status"] = await mig.move_range(plan["lo"],
                                                plan["hi"],
                                                plan["dst"])
        window["t_end"] = time.monotonic()

    async def run() -> List[Dict]:
        tasks = [asyncio.ensure_future(worker(w))
                 for w in range(workers)]
        mv = asyncio.ensure_future(mover())
        await asyncio.sleep(run_s)
        try:
            await asyncio.wait_for(mv, timeout=60.0)
        finally:
            stop.set()
        return await asyncio.gather(*tasks)

    outs = await run()
    t_total = time.monotonic() - t0
    ws, we = window["t_start"], window["t_end"]
    in_win, steady = [], []
    for o in outs:
        for t, lat in o["samples"]:
            (in_win if ws is not None and ws <= t <= we
             else steady).append(lat)
    anomalies = sum(o["anomalies"] for o in outs)
    completed = sum(o["completed"] for o in outs)
    errors = sum(o["errors"] for o in outs)
    steady_p99 = round(_p(steady, 0.99), 3)
    blip_p99 = round(_p(in_win, 0.99), 3)

    # the migrated-range oracle: seeded keys must now route to dst
    # and read back byte-identical; live keys' last acked write must
    # read back too (the post-move readback half of the verdict)
    m_now = sc.router.shard_map
    plan = window["plan"]
    oracle_fail = moved_wrong = live_fail = 0
    conn = _Conn(sc.router_url)
    try:
        chk = 0
        for k, v in sorted(oracle.items()):
            chk += 1
            if m_now.group_of(k) != plan["dst"]:
                moved_wrong += 1
            st, _, obs = await conn.request(
                "GET", f"/{k}", {"Client-Id": "migchk",
                                 "Command-Id": str(chk)}, b"")
            if st != 200 or obs != v:
                oracle_fail += 1
        for o in outs:
            for k, v in sorted(o["vals"].items()):
                if v is None:
                    continue
                chk += 1
                st, _, obs = await conn.request(
                    "GET", f"/{k}", {"Client-Id": "migchk",
                                     "Command-Id": str(chk)}, b"")
                if st != 200 or obs != v:
                    live_fail += 1
    finally:
        conn.close()

    status = window["status"] or {}
    dualwrites = sum(
        r._dual_total.value
        for r in [sc.router] + [r for r, _ in sc.secondaries])
    return [{
        "phase": "migrate",
        "steps": [{
            "offered_ops_s": rate,
            "achieved_ops_s": round(completed / t_total, 1),
            "completed": completed,
            "errors": errors,
            "latency_p50_ms": round(_p(steady, 0.5), 3),
            "latency_p99_ms": steady_p99,
        }],
        "anomalies": anomalies,
        "peak_ops_s": round(completed / t_total, 1),
        "migration": {
            "plan": plan,
            "rebalancer_fallback": window["fallback"],
            "mid": status.get("mid"),
            "epoch": status.get("epoch"),
            "installed": status.get("installed"),
            "chunks": status.get("chunks"),
            "window_s": round((we - ws) if ws is not None else 0.0,
                              3),
            "window_samples": len(in_win),
            "steady_p99_ms": steady_p99,
            "migration_blip_p99_ms": blip_p99,
            "blip_ratio": round(blip_p99 / steady_p99, 3)
            if steady_p99 else None,
            "map_version": m_now.version,
            "dualwrites": dualwrites,
            "oracle": {
                "seeded_keys": len(oracle),
                "readback_failures": oracle_fail,
                "misrouted": moved_wrong,
                "live_readback_failures": live_fail,
                "clean": oracle_fail == moved_wrong == live_fail
                == 0,
            },
        },
    }]


async def _hot_phase(wl_name: str, rcfg: Config, shard_map,
                     rates: List[float], workers: int, step_s: float,
                     seed: int, conns: int, W: float, K: int,
                     drain_s: float) -> List[Dict]:
    """Workload-driven phase: every worker samples the SAME named spec
    (distinct counter streams) and a linear key map stretches the
    spec's [0, K) key ids over the whole keyspace, concentrating the
    hot ranks inside group 0's range."""
    from paxi_tpu_torch.workload import named_workload
    wl = named_workload(wl_name)
    stretch = max(shard_map.span // K, 1)
    outs = await asyncio.gather(*[
        OpenLoopBenchmark(
            rcfg, rates=[r / workers for r in rates], step_s=step_s,
            seed=seed + 307 * w, conns=conns, W=W, K=K,
            client_tag=f"h{w}w",
            # workers share the spec's key space (that is the point of
            # a hot range), so per-worker per-key histories are partial
            # and the per-worker linearizability verdict cannot compose
            linearizability_check=False, drain_s=drain_s,
            key_map=(lambda j, _s=stretch: j * _s),
            workload=wl, wl_stream=w).run()
        for w in range(workers)])
    steps = []
    for i, r in enumerate(rates):
        row = {
            "offered_ops_s": r,
            "achieved_ops_s": round(sum(
                o["steps"][i]["achieved_ops_s"] for o in outs), 1),
            "completed": sum(o["steps"][i]["completed"] for o in outs),
            "errors": sum(o["steps"][i]["errors"] for o in outs),
            "shed": sum(o["steps"][i]["shed"] for o in outs),
            "latency_p50_ms": round(max(
                o["steps"][i]["latency_ms"]["p50"] for o in outs), 3),
            "latency_p99_ms": round(max(
                o["steps"][i]["latency_ms"]["p99"] for o in outs), 3),
        }
        cls = {}
        for c in ("hot", "warm", "cold"):
            rows = [o["steps"][i]["key_class_latency"][c]
                    for o in outs
                    if c in o["steps"][i].get("key_class_latency", {})]
            if rows:
                cls[c] = {
                    "n": sum(x["n"] for x in rows),
                    "p50_ms": round(max(x["p50_ms"] for x in rows), 3),
                    "p99_ms": round(max(x["p99_ms"] for x in rows), 3),
                }
        if cls:
            row["key_class_latency"] = cls
        steps.append(row)
    return [{"phase": "hot", "workload": wl.name, "steps": steps,
             "anomalies": None,
             "peak_ops_s": max(s["achieved_ops_s"] for s in steps)}]


def _gauge_values(snap: Dict, name: str) -> Dict[str, float]:
    """Per-group gauge values keyed by the ``group`` label."""
    out: Dict[str, float] = {}
    for g in snap.get("gauges", []):
        if g["name"] == name:
            k = g.get("labels", {}).get("group", "?")
            out[k] = out.get(k, 0) + g["value"]
    return out


async def _gauge_sampler(router, out: List[Dict],
                         interval: float = 0.4) -> None:
    """Poll the router-tier gauges (per-group pending-queue depth +
    in-flight commands) while a phase's workers run, building the
    queue-trajectory evidence for WHERE the bottleneck sits: depth
    growing on one group = that group's leader saturating; depth flat
    while in-flight climbs = the shared router/serving tier."""
    t0 = time.monotonic()
    while True:
        snap = await router.metrics_snapshot()
        out.append({
            "t_s": round(time.monotonic() - t0, 2),
            "pending_depth": _gauge_values(
                snap, "paxi_router_pending_depth"),
            "inflight": _gauge_values(snap, "paxi_router_inflight"),
        })
        await asyncio.sleep(interval)


def _traj_report(traj: List[Dict], keep: int = 24) -> Dict:
    """Gauge trajectory -> artifact row: per-group maxima plus the
    (thinned) time series."""
    if not traj:
        return {"samples": 0}
    maxes: Dict[str, Dict[str, float]] = {"pending_depth": {},
                                          "inflight": {}}
    for s in traj:
        for kind in ("pending_depth", "inflight"):
            for g, v in s[kind].items():
                maxes[kind][g] = max(maxes[kind].get(g, 0), v)
    step = max(1, len(traj) // keep)
    return {"samples": len(traj),
            "max_pending_depth": {g: maxes["pending_depth"][g]
                                  for g in sorted(maxes["pending_depth"])},
            "max_inflight": {g: maxes["inflight"][g]
                             for g in sorted(maxes["inflight"])},
            "trajectory": traj[::step]}


def _counter(snap: Dict, name: str) -> int:
    return sum(c["value"] for c in snap.get("counters", [])
               if c["name"] == name)


def _group_counters(snap: Dict) -> Dict[str, int]:
    """Per-group routed-command totals keyed by the ``group`` label."""
    out: Dict[str, int] = {}
    for c in snap.get("counters", []):
        if c["name"] == "paxi_router_group_commands_total":
            g = c.get("labels", {}).get("group", "?")
            out[g] = out.get(g, 0) + c["value"]
    return out
