"""The sharded serving tier of the port (``paxi_tpu_torch/shard/``) against
the JAX package's, on the CPU.

- ``ShardMap``: the static partition, ``move_range`` (versions,
  coalescing, refusals), modulo folding and the JSON form, held equal
  between the packages through ``to_json``, ``group_of`` and
  ``ranges_of`` on scripted and seeded random move sequences.
- The router end to end over a cluster of two paxos groups, in both
  packages: routed placement, reserved prefixes refused, the stale-epoch
  reroute of an op queued before a map bump, ``/shardmap`` and its
  ``move``, a cross-shard and a single-group transaction, the
  group-labelled metrics; then the ``move`` refusals and unknown routes.
  Each package's run gives the same statuses, payloads and stores.
- The open loop through the port's router with crossing key ranges:
  per-key linearizability across groups.
- Interop (the wire is the same): the JAX package's ``_Conn`` and
  open-loop workers drive the port's router over the port's groups, and
  the port's router fronts the JAX package's groups.

Every port comes from the OS or a free block (``_torch_serving``).
"""

import asyncio
import json
import random

import pytest

pytest.importorskip("jax")

import _torch_serving as S  # noqa: E402
import _torch_shard as T  # noqa: E402

pytestmark = pytest.mark.host


def _view(m):
    probes = [0, 1, 99, 100, 150, 199, 200, 1023, 1024, 2048, 4095, 4096,
              5120, -1, -1000, m.span - 1, m.span, 3 * m.span + 17]
    return (m.to_json(), m.n_groups, [m.group_of(k) for k in probes],
            [m.ranges_of(g) for g in range(m.n_groups + 1)])


MAP_SCRIPTS = {
    "static4": (4, 1 << 12, []),
    "move_and_back": (2, 1000, [(100, 200, 1), (100, 200, 0)]),
    "move_refused": (2, 1000, [(500, 100, 1), (0, 2000, 1), (0, 10, -1)]),
    "default_span": (3, None, [(10, 99, 2), (0, 5, 1), (99, 1 << 19, 0)]),
    "coalesce_all": (3, 999, [(0, 333, 1), (666, 999, 1), (333, 666, 2),
                              (0, 999, 0)]),
    "bad_layouts": (0, 10, []),
}


def _map_script(pkg, groups, span, moves):
    SM = T.mod(pkg, "shard").ShardMap
    kw = {} if span is None else {"span": span}
    try:
        m = SM.static(groups, **kw)
    except ValueError as e:
        return [("ValueError", str(e)), T.outcome(SM.static, 5, 3)]
    out = [_view(m)]
    for lo, hi, g in moves:
        nxt = T.outcome(m.move_range, lo, hi, g)
        out.append(nxt)
        if isinstance(nxt, dict):
            m = SM.from_json(json.dumps(nxt))
            out.append(_view(m))
    bad = m.to_json()
    bad["starts"] = [5] + bad["starts"][1:]
    out.append(T.outcome(SM.from_json, bad))
    out.append(SM.from_json(json.dumps(m.to_json())) == m)
    return out


@pytest.mark.parametrize("case", sorted(MAP_SCRIPTS))
def test_shardmap_script_equals_reference(case):
    got = _map_script("paxi_tpu_torch", *MAP_SCRIPTS[case])
    assert got == _map_script("paxi_tpu", *MAP_SCRIPTS[case])


def _random_moves(pkg, seed):
    rnd = random.Random(seed)
    SM = T.mod(pkg, "shard").ShardMap
    m = SM.static(rnd.randint(1, 6), span=rnd.choice((64, 1000, 1 << 20)))
    out = []
    for _ in range(12):
        lo = rnd.randrange(0, m.span)
        hi = rnd.randrange(lo, m.span + 2)
        nxt = T.outcome(m.move_range, lo, hi, rnd.randrange(-1, 7))
        out.append(nxt)
        if isinstance(nxt, dict):
            m = SM.from_json(nxt)
        out.append([m.group_of(rnd.randrange(-m.span, 3 * m.span))
                    for _ in range(16)])
    return out


@pytest.mark.parametrize("seed", range(4))
def test_shardmap_random_moves_equal_reference(seed):
    assert _random_moves("paxi_tpu_torch", seed) \
        == _random_moves("paxi_tpu", seed)


# ---- the router end to end -------------------------------------------------
def _req(conn, method, path, body=b"", cid="t", cmd=1):
    return conn.request(method, path,
                        {"Client-Id": cid, "Command-Id": str(cmd)}, body)


def _router_story(pkg):
    """The reference's router test as a record of what each step saw."""
    shard, command = T.mod(pkg, "shard"), T.mod(pkg, "core.command")
    _Conn = T.mod(pkg, "host.client")._Conn
    seen = []

    async def main():
        sc = shard.ShardedCluster("paxos", groups=2, n=3,
                                  base_port=S.free_shard_base(6),
                                  tag=f"shr-{pkg}")
        await sc.start()
        conn = _Conn(sc.router_url)
        try:
            span = sc.map.span
            k0, k1 = 7, span // 2 + 7
            for i, (m, path, body) in enumerate([
                    ("PUT", f"/{k0}", b"alpha"), ("PUT", f"/{k1}", b"beta"),
                    ("GET", f"/{k0}", b""),
                    ("PUT", f"/{k0}", command.TXN_MAGIC + b"x"),
                    ("PUT", f"/{k0}", command.TPC_MAGIC + b"x")]):
                st, _, p = await _req(conn, m, path, body, cmd=i + 1)
                seen.append((st, p))
            g0, g1 = sc.leader_node(0), sc.leader_node(1)
            seen.append([g0.db.get(k0), g1.db.get(k0), g1.db.get(k1),
                         g0.db.get(k1)])
            # an op queued under map v1 whose key moves before the flush
            router, mk = sc.router, 1234
            loop = asyncio.get_running_loop()
            frame = (f"PUT /{mk} HTTP/1.1\r\nContent-Length: 5\r\n"
                     f"Client-Id: st\r\nCommand-Id: 9\r\n\r\n").encode() \
                + b"moved"
            slot = router.route_kv(mk, frame, loop)
            router.install_map(router.shard_map.move_range(mk, mk + 1, 1))
            await router.flush()
            resp = await asyncio.wait_for(slot, 10)
            snap = await router.metrics_snapshot()
            seen.append((resp.split(b"\r\n")[0], g1.db.get(mk),
                         g0.db.get(mk),
                         sum(c["value"] for c in snap["counters"]
                             if c["name"]
                             == "paxi_router_stale_reroutes_total")))
            st, _, p = await _req(conn, "GET", f"/{mk}", cmd=6)
            seen.append((st, p))
            st, _, p = await _req(conn, "GET", "/shardmap")
            seen.append((st, json.loads(p)))
            st, _, p = await conn.request(
                "POST", f"/shardmap/move?lo={mk}&hi={mk + 1}&group=1", {},
                b"")
            seen.append((st, json.loads(p)))
            st, _, p = await _req(conn, "POST", "/transaction", json.dumps(
                [{"key": k0, "value": "A2"},
                 {"key": k1, "value": "B2"}]).encode(), cmd=7)
            out = json.loads(p)
            seen.append((st, out["ok"], out["values"],
                         out["txid"].split("-")[:2]))
            seen.append([g0.db.get(k0), g1.db.get(k1)])
            st, _, p = await _req(conn, "POST", "/transaction", json.dumps(
                [{"key": k0, "value": "A3"},
                 {"key": k0 + 1, "value": "A4"}]).encode(), cmd=8)
            seen.append((st, json.loads(p), g0.db.get(k0)))
            st, _, p = await _req(conn, "GET", "/metrics?format=json")
            snap = json.loads(p)
            seen.append((st, sorted({c["labels"].get("group", "")
                                     for c in snap["counters"]}),
                         "paxi_router_forwards_total"
                         in {c["name"] for c in snap["counters"]}))
            st, _, p = await _req(conn, "GET", "/metrics")
            seen.append((st, b'group="1"' in p))
            # the control plane's refusals and unknown routes
            for path, m in (("/shardmap/move?lo=0&hi=64&group=1", "POST"),
                            ("/shardmap/move?lo=0&hi=64&group=9", "POST"),
                            ("/shardmap/move?lo=64&hi=0&group=1", "POST"),
                            ("/shardmap/move?lo=0", "POST"),
                            ("/shardmap/nope", "GET"),
                            ("/nope/route", "GET"),
                            ("/transaction", "GET"),
                            ("/metrics", "POST")):
                st, _, p = await conn.request(m, path, {}, b"")
                seen.append((path, st, json.loads(p)["version"]
                             if st == 200 else None))
            seen.append(sc.router.shard_map.group_of(10))
        finally:
            conn.close()
            await sc.stop()
    S.run(main())
    return seen


def test_router_end_to_end_equals_reference():
    got = _router_story("paxi_tpu_torch")
    want = _router_story("paxi_tpu")
    assert got == want
    assert got[:3] == [(200, b""), (200, b""), (200, b"alpha")]
    assert got[3][0] == got[4][0] == 400
    assert got[6][1:] == (b"moved", None, 1)


def test_cross_group_linearizability_per_key():
    """The open loop through the port's router, every worker crossing
    both groups: each key's history is served by one group, so the
    per-worker verdicts stay clean."""
    shard = T.mod("paxi_tpu_torch", "shard")
    sb = T.mod("paxi_tpu_torch", "shard.bench")
    OpenLoop = T.mod("paxi_tpu_torch", "host.benchmark").OpenLoopBenchmark

    async def main():
        sc = shard.ShardedCluster("paxos", groups=2, n=3,
                                  base_port=S.free_shard_base(6))
        await sc.start()
        try:
            maps = sb.worker_key_maps(sc.map, 2, 2, 64)
            outs = await asyncio.gather(*[
                OpenLoop(sb._router_cfg(sc.router_url), rates=[250.0],
                         step_s=0.8, seed=11 + w, conns=2, W=0.5, K=64,
                         client_tag=f"x{w}w", drain_s=3.0,
                         key_map=maps[w]["crossing"]).run()
                for w in range(2)])
            for out in outs:
                assert out["total_completed"] > 0
                assert (out["anomalies"] or 0) == 0
        finally:
            await sc.stop()
    S.run(main())


def test_worker_key_maps_equal_reference():
    for pkg_maps in ((2, 4, 256), (4, 3, 64), (1, 2, 16)):
        got = T.mod("paxi_tpu_torch", "shard.bench").worker_key_maps(
            T.mod("paxi_tpu_torch", "shard").ShardMap.static(pkg_maps[0]),
            *pkg_maps)
        want = T.mod("paxi_tpu", "shard.bench").worker_key_maps(
            T.mod("paxi_tpu", "shard").ShardMap.static(pkg_maps[0]),
            *pkg_maps)
        for g, w in zip(got, want):
            for phase in ("disjoint", "crossing"):
                assert [g[phase](j) for j in range(70)] \
                    == [w[phase](j) for j in range(70)]


# ---- interop: one wire ---------------------------------------------------------
def test_reference_clients_drive_the_ports_router():
    """The JAX package's ``_Conn`` and open-loop workers against the
    port's router: KV, a cross-shard 2PC and the crossing ramp."""
    shard = T.mod("paxi_tpu_torch", "shard")
    jconn = T.mod("paxi_tpu", "host.client")._Conn
    jsb = T.mod("paxi_tpu", "shard.bench")
    JOpenLoop = T.mod("paxi_tpu", "host.benchmark").OpenLoopBenchmark

    async def main():
        sc = shard.ShardedCluster("paxos", groups=2, n=3,
                                  base_port=S.free_shard_base(6))
        await sc.start()
        conn = jconn(sc.router_url)
        try:
            k0, k1 = 11, sc.map.span // 2 + 11
            assert (await _req(conn, "PUT", f"/{k0}", b"a", cmd=1))[0] \
                == 200
            st, _, p = await _req(conn, "POST", "/transaction", json.dumps(
                [{"key": k0, "value": "A"},
                 {"key": k1, "value": "B"}]).encode(), cmd=2)
            assert st == 200 and json.loads(p)["values"] == ["a", ""]
            assert sc.leader_node(1).db.get(k1) == b"B"
            st, _, p = await _req(conn, "GET", "/shardmap", cmd=3)
            assert st == 200 and json.loads(p)["version"] == 1
            maps = jsb.worker_key_maps(sc.map, 2, 2, 32)
            outs = await asyncio.gather(*[
                JOpenLoop(jsb._router_cfg(sc.router_url), rates=[200.0],
                          step_s=0.5, seed=3 + w, conns=2, W=0.5, K=32,
                          client_tag=f"j{w}w", drain_s=3.0,
                          key_map=maps[w]["crossing"]).run()
                for w in range(2)])
            for out in outs:
                assert out["total_completed"] > 0
                assert (out["anomalies"] or 0) == 0
        finally:
            conn.close()
            await sc.stop()
    S.run(main())


def test_ports_router_fronts_reference_groups():
    """The port's router and 2PC coordinator over the JAX package's
    groups: routed KV placement, a cross-shard transaction through
    ``/tpc``, a map move, the group-labelled metrics."""
    pshard = T.mod("paxi_tpu_torch", "shard")
    jshard = T.mod("paxi_tpu", "shard")
    pconn = T.mod("paxi_tpu_torch", "host.client")._Conn

    async def main():
        base = S.free_shard_base(6, routers=2)
        sc = jshard.ShardedCluster("paxos", groups=2, n=3, base_port=base,
                                   tag="shr-interop")
        await sc.start()
        urls = [cfg.http_addrs[cfg.ids[0]] for cfg in sc.cfgs]
        router = pshard.ShardRouter(pshard.ShardMap.static(2), urls,
                                    group_scrape=sc._scrape_groups)
        server = pshard.RouterServer(router,
                                     f"http://127.0.0.1:{base + 100}")
        await server.start()
        conn = pconn(f"http://127.0.0.1:{base + 100}")
        try:
            span = router.shard_map.span
            k0, k1 = 5, span // 2 + 5
            for i, (k, v) in enumerate(((k0, b"x0"), (k1, b"x1"))):
                assert (await _req(conn, "PUT", f"/{k}", v, cmd=i + 1))[0] \
                    == 200
            assert sc.leader_node(0).db.get(k0) == b"x0"
            assert sc.leader_node(1).db.get(k1) == b"x1"
            assert sc.leader_node(0).db.get(k1) is None
            st, _, p = await _req(conn, "POST", "/transaction", json.dumps(
                [{"key": k0, "value": "T0"},
                 {"key": k1, "value": "T1"}]).encode(), cmd=3)
            out = json.loads(p)
            assert st == 200 and out["ok"] and out["values"] == ["x0", "x1"]
            assert out["txid"].startswith("2pc-c-")
            for g, (k, v) in enumerate(((k0, b"T0"), (k1, b"T1"))):
                for r in sc.group(g).replicas.values():
                    for _ in range(100):
                        if r.db.get(k) == v:
                            break
                        await asyncio.sleep(0.02)
                    assert r.db.get(k) == v, r.id
                    assert r.db.staged_txns() == []
            st, _, p = await conn.request(
                "POST", f"/shardmap/move?lo={k0}&hi={k0 + 1}&group=1", {},
                b"")
            assert st == 200 and json.loads(p)["version"] == 2
            assert (await _req(conn, "PUT", f"/{k0}", b"m", cmd=4))[0] \
                == 200
            assert sc.leader_node(1).db.get(k0) == b"m"
            st, _, p = await _req(conn, "GET", "/metrics?format=json",
                                  cmd=5)
            groups = {c["labels"].get("group")
                      for c in json.loads(p)["counters"]}
            assert st == 200 and {"0", "1"} <= groups
        finally:
            conn.close()
            await server.stop()
            await sc.stop()
    S.run(main())


# ---- the CLI ----------------------------------------------------------------
def _tree(parser, path=""):
    """Every (sub)command's option strings, by command path."""
    import argparse
    out = {path: sorted(s for a in parser._actions for s in a.option_strings
                        if not isinstance(a, argparse._HelpAction))}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_tree(sub, f"{path} {name}".strip()))
    return out


def _reference_parser():
    """The JAX package's parser, built inside its ``main``."""
    import argparse
    grabbed = []
    parse = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        grabbed.append(self)
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        T.mod("paxi_tpu", "cli").main([])
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = parse
    return grabbed[0]


def test_cli_trees_differ_only_where_left_out():
    """With ``bench-host``'s shard flags the two CLIs' argument trees
    differ only in ``profile -gathers|-exchange`` (left out: they count
    compiled-HLO ops) and the port's own ``-device``."""
    got = _tree(T.mod("paxi_tpu_torch", "cli").build_parser())
    want = _tree(_reference_parser())
    assert sorted(got) == sorted(want)
    device = {"-device", "--device"}
    for cmd in got:
        extra = set(got[cmd]) - set(want[cmd])
        missing = set(want[cmd]) - set(got[cmd])
        assert extra <= device, (cmd, extra)
        assert not missing or cmd == "profile", (cmd, missing)
    assert set(want["profile"]) - set(got["profile"]) \
        == {"-gathers", "--gathers", "-exchange"}
    for flag in ("-shards", "-shard_fleet", "-shard_workers", "-txns",
                 "-migrate", "-routers"):
        assert flag in got["bench-host"]
