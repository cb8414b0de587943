"""Live range migration of the port (``paxi_tpu_torch/shard/migrate.py``)
against the JAX package's, on the CPU.

- The migration window as a value (``with_migration``,
  ``complete_migration``, the JSON form and its refusals) and the
  ``Rebalancer``'s split/merge/hysteresis decisions, step by step in
  both packages.
- On one ``VirtualClockFabric`` per run (``_torch_shard``; every
  coordinator at ``lease_s=0`` and ``busy_wait_s=0``, so no wall-clock
  sleep steers a run): the streamed move of a non-empty range, the
  round trip with its mid collision, the coordinator killed at every
  epoch and re-run, and every ``SHARD_MIGRATION_CASES`` row (a 2PC
  coordinator and a migration coordinator both killed, recovery and the
  move racing): equal status dicts, outcomes, maps, fabric steps and
  every replica's store, 2PC and migration state in both packages, the
  moved-range oracle clean.
- Over HTTP, the port alone on free ports: the double-write window
  through the router, a streamed move under load with two routers, and
  a stale router's write bounced off the MOVED marker and rerouted.
"""

import asyncio
import itertools

import pytest

pytest.importorskip("jax")

import _torch_serving as S  # noqa: E402
import _torch_shard as T  # noqa: E402

pytestmark = pytest.mark.host


# ---- the window as a value, the rebalancer ------------------------------
def _window_script(pkg):
    SM = T.mod(pkg, "shard").ShardMap
    out = []
    m = SM.static(2)
    g = m.span // 2
    lo, hi = g - 4096, g
    m1 = m.with_migration(lo, hi, 1)
    out += [m1.to_json(), [m1.group_of(k) for k in (lo, hi - 1, hi)],
            [m1.migration_of(k) for k in (lo, hi - 1, lo - 1,
                                          lo + m.span)]]
    m2 = m1.complete_migration(lo, hi)
    out += [m2.to_json(), [m2.group_of(k) for k in (lo, hi - 1, lo - 1)],
            m2.migration_of(lo)]
    m3 = SM.static(3)
    a, b = 64, m3.span // 3 - 5
    w = m3.with_migration(a, b, 2)
    out += [w.to_json(), SM.from_json(w.to_json()) == w,
            "migrations" in m3.to_json()]
    out += [T.outcome(m3.with_migration, b, a, 2),
            T.outcome(m3.with_migration, a, b, 0),
            T.outcome(m3.with_migration, 0, m3.span, 1),
            T.outcome(w.with_migration, a + 1, b - 1, 1),
            T.outcome(w.complete_migration, a + 1, b)]
    bad = w.to_json()
    bad["migrations"] = [[a, b, 1, 2]]
    out.append(T.outcome(SM.from_json, bad))
    return out


def test_migration_window_equals_reference():
    T.both(_window_script)


REBALANCER_TICKS = {
    "split": (dict(hot_share=0.6, min_ticks=2, min_cmds=10, cooldown=1),
              2, [[90, 10]] * 3, [10] * 16 + [0] * 48),
    "merge": (dict(hot_share=0.9, cold_share=0.05, min_ticks=2,
                   min_cmds=10, cooldown=0), 3, [[50, 48, 2]] * 2, [1] * 64),
    "quiet_reset": (dict(hot_share=0.6, min_ticks=2, min_cmds=10,
                         cooldown=0), 3, [[90, 5, 5], [1, 0, 0],
                                          [90, 5, 5], [90, 5, 5]], [1] * 64),
    "one_bucket": (dict(hot_share=0.5, min_ticks=1, min_cmds=1,
                        cooldown=0), 2, [[40, 2]], [0] * 5 + [40] + [0] * 58),
}


def _rebalance(pkg, kw, groups, ticks, hits):
    shard = T.mod(pkg, "shard")
    reb = shard.Rebalancer(**kw)
    m = shard.ShardMap.static(groups)
    return [reb.tick(m, cmds, hits) for cmds in ticks]


@pytest.mark.parametrize("case", sorted(REBALANCER_TICKS))
def test_rebalancer_decisions_equal_reference(case):
    plans = T.both(_rebalance, *REBALANCER_TICKS[case])
    assert any(p is not None for p in plans) or case == "quiet_reset"


def test_rebalancer_random_ticks_equal_reference():
    import random
    rnd = random.Random(7)
    for _ in range(20):
        groups = rnd.choice((2, 3, 4))
        kw = dict(hot_share=rnd.choice((0.4, 0.5, 0.7)),
                  cold_share=rnd.choice((0.0, 0.05, 0.2)),
                  min_ticks=rnd.randint(1, 3), min_cmds=rnd.randint(1, 60),
                  cooldown=rnd.randint(0, 2))
        ticks = [[rnd.randint(0, 80) for _ in range(groups)]
                 for _ in range(8)]
        hits = [rnd.randint(0, 9) for _ in range(64)]
        T.both(_rebalance, kw, groups, ticks, hits)


# ---- on the fabric ---------------------------------------------------------
def _seed_kvs(lo, n_keys=10):
    return {lo + 3 * i: f"s{lo + 3 * i}".encode() for i in range(n_keys)}


async def _seed(pkg, fab, sc, kvs, group):
    for i, (k, v) in enumerate(sorted(kvs.items())):
        await T.fput(pkg, fab, sc.leader_node(group), k, v, cmd_id=i + 1)


def _assert_moved(sc, kvs, mid, src=0, dst=1, overrides=None):
    """The migrated-range oracle at every replica."""
    want = {**kvs, **(overrides or {})}
    for r in sc.group(dst).replicas.values():
        assert all(r.db.get(k) == v for k, v in want.items()), r.id
        assert mid in r.db.migration_state()["done"], r.id
    for r in sc.group(src).replicas.values():
        assert not any(r.db.get(k) for k in want), r.id
        assert mid in r.db.migration_state()["released"], r.id


def _coord(pkg, sc, holder, **kw):
    return T.mod(pkg, "shard").MigrationCoordinator(
        T.mig_submit(pkg, sc), [holder], busy_wait_s=0.0, **kw)


def _streamed(pkg):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, tag="migfab")
        await sc.start()
        try:
            g = sc.map.span // 2
            lo, hi = g - 128, g
            kvs = _seed_kvs(lo)
            await _seed(pkg, fab, sc, kvs, 0)
            holder = shard.MapHolder(sc.map)
            st = (await T.drive(fab, _coord(pkg, sc, holder, chunk=4)
                                .move_range(lo, hi, 1))).result()
            assert st["epoch"] == "complete" and st["chunks"] >= 3
            assert st["installed"] >= len(kvs)
            await fab.run(80)
            _assert_moved(sc, kvs, st["mid"])
            again = (await T.drive(fab, _coord(pkg, sc, holder, chunk=4)
                                   .move_range(lo, hi, 1, src=0))).result()
            assert again["epoch"] == "complete"
            return (st, again, holder.shard_map.to_json(), fab.step,
                    T.replica_states(sc))
        finally:
            await sc.stop()
    return asyncio.run(main())


def test_streamed_move_equals_reference():
    T.both(_streamed)


def _round_trip(pkg):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, tag="migfab")
        await sc.start()
        try:
            g = sc.map.span // 2
            lo, hi = g - 128, g
            kvs = _seed_kvs(lo, n_keys=6)
            await _seed(pkg, fab, sc, kvs, 0)
            holder = shard.MapHolder(sc.map)

            async def move(dst, src, **kw):
                return await T.drive(fab, _coord(pkg, sc, holder, chunk=4)
                                     .move_range(lo, hi, dst, src=src, **kw))
            seen = [(await move(1, 0)).result(), (await move(0, 1)).result()]
            await fab.run(80)
            await T.fput(pkg, fab, sc.leader_node(0), lo, b"home", cid="rt")
            await fab.run(40)
            assert sc.leader_node(0).db.get(lo) == b"home"
            exc = (await move(1, 0)).exception()
            assert isinstance(exc, shard.MigrationError)
            seen.append(str(exc))
            seen.append((await move(1, 0, mid="rt-2")).result())
            await fab.run(80)
            _assert_moved(sc, {**kvs, lo: b"home"}, "rt-2")
            return seen, holder.shard_map.to_json(), fab.step, \
                T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


def test_round_trip_move_equals_reference():
    T.both(_round_trip)


def _crash_rerun(pkg, point):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, tag="migfab")
        await sc.start()
        try:
            g = sc.map.span // 2
            lo, hi = g - 128, g
            kvs = _seed_kvs(lo)
            await _seed(pkg, fab, sc, kvs, 0)
            holder = shard.MapHolder(sc.map)
            mig = _coord(pkg, sc, holder, chunk=4, crash_at=point)
            exc = (await T.drive(fab, mig.move_range(lo, hi, 1))).exception()
            assert isinstance(exc, shard.MigrationKilled), exc
            killed = (str(exc), mig.status(), fab.step)
            st = (await T.drive(fab, _coord(pkg, sc, holder, chunk=4)
                                .move_range(lo, hi, 1, src=0))).result()
            assert st["epoch"] == "complete"
            assert holder.shard_map.group_of(lo) == 1
            await fab.run(80)
            _assert_moved(sc, kvs, st["mid"])
            return killed, st, holder.shard_map.to_json(), fab.step, \
                T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


@pytest.mark.parametrize("point", ["snapshot", "double_write", "cutover"])
def test_crash_at_every_epoch_equals_reference(point):
    T.both(_crash_rerun, point)


def _migration_row(pkg, mig_kill, tpc_kill, groups, n, seed):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, groups, n, tag="migfab")
        await sc.start()
        try:
            span = sc.map.span
            g = span // groups
            lo, hi = g - 128, g
            kvs = _seed_kvs(lo, n_keys=6)
            k0, k1 = sorted(kvs)[1], g + 300 + seed
            await _seed(pkg, fab, sc, kvs, 0)
            await T.fput(pkg, fab, sc.leader_node(1), g + 7, b"g1",
                         cid="warm1")
            submit = T.tpc_submit(pkg, sc)
            coord = shard.ShardCoordinator(submit, lease_s=0.0)
            parts = {0: [(k0, b"tpc-v0")], 1: [(k1, b"tpc-v1")]}
            exc = (await T.drive(fab, coord.run_txn(
                parts, txid=f"tx-{seed}", crash_at=tpc_kill))).exception()
            assert isinstance(exc, shard.CoordinatorKilled), exc
            holder = shard.MapHolder(sc.map)
            mig = _coord(pkg, sc, holder, chunk=3, crash_at=mig_kill)
            rec = shard.ShardCoordinator(submit, lease_s=0.0)
            t_mig = asyncio.ensure_future(mig.move_range(lo, hi, 1))
            t_rec = asyncio.ensure_future(rec.recover(exc.txid, parts))
            for _ in range(4000):
                if t_mig.done() and t_rec.done():
                    break
                await fab.run(1)
            assert t_mig.done() and t_rec.done()
            assert isinstance(t_mig.exception(), shard.MigrationKilled)
            outcome = t_rec.result()
            assert outcome == ("c" if tpc_kill in ("after_decide",
                                                   "mid_commit") else "a")
            raced = (mig.status(), outcome, fab.step)
            st = (await T.drive(fab, _coord(pkg, sc, holder, chunk=3)
                                .move_range(lo, hi, 1, src=0),
                                max_steps=4000)).result()
            assert st["epoch"] == "complete"
            await fab.run(100)
            v0 = b"tpc-v0" if outcome == "c" else kvs[k0]
            _assert_moved(sc, kvs, st["mid"], overrides={k0: v0})
            for r in sc.group(1).replicas.values():
                assert ((r.db.get(k1) or b"") == b"tpc-v1") \
                    == (outcome == "c"), r.id
            return raced, st, holder.shard_map.to_json(), fab.step, \
                T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


MIGRATION_CASES = T.mod("paxi_tpu_torch", "hunt.cases").SHARD_MIGRATION_CASES


@pytest.mark.parametrize("mig_kill,tpc_kill,groups,n,seeds", MIGRATION_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in MIGRATION_CASES])
def test_migration_vs_tpc_kill_row_equals_reference(mig_kill, tpc_kill,
                                                    groups, n, seeds):
    for seed in seeds:
        T.both(_migration_row, mig_kill, tpc_kill, groups, n, seed)


# ---- over HTTP, the port alone ------------------------------------------
def _ids(cid):
    c = itertools.count(1)
    return lambda: {"Client-Id": cid, "Command-Id": str(next(c))}


async def hput(conn, hdrs, k, v):
    status, _, payload = await conn.request("PUT", f"/{k}", hdrs(), v)
    assert status == 200, payload
    return payload


async def hget(conn, hdrs, k):
    status, _, payload = await conn.request("GET", f"/{k}", hdrs(), b"")
    assert status == 200, payload
    return payload


def _http_cluster(routers):
    shard = T.mod("paxi_tpu_torch", "shard")
    base = S.free_shard_base(4, routers=routers)
    return shard.ShardedCluster("paxos", groups=2, n=2, base_port=base,
                                routers=routers)


def test_double_write_window_through_router():
    """Writes inside an open window ship to both groups and stay
    read-your-write clean through the cutover map swap."""
    _Conn = T.mod("paxi_tpu_torch", "host.client")._Conn

    async def main():
        sc = _http_cluster(1)
        await sc.start()
        conn = _Conn(sc.router_url)
        try:
            hdrs = _ids("dw")
            g = sc.map.span // 2
            lo, hi = g - 4096, g
            k = hi - 100
            await hput(conn, hdrs, k, b"w0")
            r = sc.router
            r.install_map(r.shard_map.with_migration(lo, hi, 1))
            d0 = r._dual_total.value
            await hput(conn, hdrs, k, b"va")
            assert r._dual_total.value == d0 + 1
            assert await hget(conn, hdrs, k) == b"va"
            await hput(conn, hdrs, k, b"vb")
            assert await hget(conn, hdrs, k) == b"vb"
            for _ in range(100):
                if sc.leader_node(1).db.get(k) == b"vb":
                    break
                await asyncio.sleep(0.02)
            assert sc.leader_node(1).db.get(k) == b"vb"
            r.install_map(r.shard_map.complete_migration(lo, hi))
            assert await hget(conn, hdrs, k) == b"vb"
        finally:
            conn.close()
            await sc.stop()
    S.run(main())


def test_http_move_under_load_with_two_routers():
    """A streamed move over HTTP while a writer drives the secondary
    router: no read-your-write violation, both routers on the cutover
    map, the data at the new owner and dropped at the old."""
    _Conn = T.mod("paxi_tpu_torch", "host.client")._Conn

    async def main():
        sc = _http_cluster(2)
        await sc.start()
        conn = _Conn(sc.router_url)
        try:
            hdrs = _ids("ld")
            g = sc.map.span // 2
            lo, hi = g - 4096, g
            kvs = {hi - 256 + 8 * i: f"s{i}".encode() for i in range(20)}
            for k, v in kvs.items():
                await hput(conn, hdrs, k, v)
            stop = asyncio.Event()
            violations = []

            async def writer():
                whdrs, last, i = _ids("wrk"), {}, 0
                wconn = _Conn(sc.router_urls[-1])
                try:
                    while not stop.is_set():
                        for k in list(kvs)[:4]:
                            v = f"c{i}".encode()
                            await hput(wconn, whdrs, k, v)
                            last[k] = v
                            got = await hget(wconn, whdrs, k)
                            if got != v:
                                violations.append((k, v, got))
                            i += 1
                        await asyncio.sleep(0)
                finally:
                    wconn.close()
                return last

            wtask = asyncio.ensure_future(writer())
            await asyncio.sleep(0.1)
            st = await asyncio.wait_for(
                sc.migrator(chunk=4).move_range(lo, hi, 1), 60)
            stop.set()
            last = await asyncio.wait_for(wtask, 30)
            assert st["epoch"] == "complete", st
            assert st["installed"] >= len(kvs) - 4, st
            assert violations == [], violations[:3]
            want = {**kvs, **last}
            v2 = sc.map.version + 2
            assert sc.router.shard_map.version == v2
            assert sc.secondaries[0][0].shard_map.version == v2
            for k, v in want.items():
                assert await hget(conn, hdrs, k) == v, k
            await asyncio.sleep(0.2)
            for k, v in want.items():
                assert sc.leader_node(1).db.get(k) == v, k
                assert not sc.leader_node(0).db.get(k), k
        finally:
            conn.close()
            await sc.stop()
    S.run(main(), timeout=120)


def test_stale_router_write_rerouted_after_cutover():
    """A router outside the coordinator's holder list bounces off the
    MOVED marker, refreshes its map from the primary and lands the write
    (and a read) on the new owner."""
    shard = T.mod("paxi_tpu_torch", "shard")
    _Conn = T.mod("paxi_tpu_torch", "host.client")._Conn

    async def main():
        sc = _http_cluster(1)
        await sc.start()
        conn = _Conn(sc.router_url)
        urls = [cfg.http_addrs[cfg.ids[0]] for cfg in sc.cfgs]
        stale = shard.ShardRouter(sc.map, urls)
        stale._map_refresh = sc._refresh_for(stale)
        try:
            hdrs = _ids("st")
            g = sc.map.span // 2
            lo, hi = g - 4096, g
            kvs = {hi - 128 + 8 * i: f"s{i}".encode() for i in range(6)}
            for k, v in kvs.items():
                await hput(conn, hdrs, k, v)
            st = await sc.migrator(chunk=4).move_range(lo, hi, 1)
            assert st["epoch"] == "complete", st
            assert stale.shard_map.version == sc.map.version
            loop = asyncio.get_running_loop()
            base = stale._stale_total.value

            def frame(method, k, v):
                return (f"{method} /{k} HTTP/1.1\r\n"
                        f"Content-Length: {len(v)}\r\nClient-Id: stale\r\n"
                        f"Command-Id: {k}\r\n\r\n").encode() + v
            k = sorted(kvs)[0]
            slot = stale.route_kv(k, frame("PUT", k, b"late"), loop,
                                  write=True)
            await stale.flush()
            resp = await asyncio.wait_for(slot, 15)
            assert resp.startswith(b"HTTP/1.1 200"), resp[:80]
            assert stale._stale_total.value > base
            assert stale.shard_map.version == sc.map.version + 2
            for _ in range(100):
                if sc.leader_node(1).db.get(k) == b"late":
                    break
                await asyncio.sleep(0.02)
            assert sc.leader_node(1).db.get(k) == b"late"
            k2 = sorted(kvs)[1]
            stale2 = shard.ShardRouter(sc.map, urls)
            stale2._map_refresh = sc._refresh_for(stale2)
            try:
                slot = stale2.route_kv(k2, frame("GET", k2, b""), loop)
                await stale2.flush()
                resp = await asyncio.wait_for(slot, 15)
                assert resp.split(b"\r\n\r\n", 1)[1] == kvs[k2]
            finally:
                stale2.close()
        finally:
            stale.close()
            conn.close()
            await sc.stop()
    S.run(main())
