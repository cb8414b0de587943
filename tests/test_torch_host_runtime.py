"""The port's asyncio host runtime against the JAX package's, on the CPU.

Each case runs the same thing through both packages, each with its own
``SeqSchedule``, ``VirtualClockFabric``, ``Cluster``, codec registry and
``SpanCollector``, and holds the port's result equal to the JAX
package's: delivery logs, ``fabric.stats``, replica state, span
timelines and ``Registry`` snapshots (handler-time histograms read wall
clocks, so those compare by count).  The cases are the JAX package's own
fabric, replay-determinism and span tests, with their assertions kept on
the port's run: the fragile_counter twin under sequenced faults, paxos
under a crash window armed mid-replay, the fabric clock on forwarded
requests and leader-lease reads, the span model, sampler, collector and
stitch math, and two byte-identical span timelines of a traced paxos
workload.
"""

import asyncio
import importlib

import pytest

pytest.importorskip("jax")

PKGS = ("paxi_tpu", "paxi_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def sched_of(pkg, n_steps, faults=(), crashed=None, cut=None):
    """``faults``: (src, dst, msg_type, occurrence, action, delay)."""
    h = mod(pkg, "trace.host")
    return h.SeqSchedule(
        n_steps=n_steps,
        faults=[h.SeqFault(s, d, mt, occurrence=k, action=a,
                           delay_steps=x) for s, d, mt, k, a, x in faults],
        crashed=dict(crashed or {}), cut=dict(cut or {}))


def registry_view(snap):
    """A Registry snapshot with each histogram cut to its count (the
    handler-time histograms observe wall-clock durations)."""
    hist = sorted((h["name"], sorted(h["labels"].items()), h["count"])
                  for h in snap["histograms"])
    return {"counters": snap["counters"], "gauges": snap["gauges"],
            "histograms": hist}


# ---- the fabric, on the fragile_counter twin ---------------------------------
N_STEPS = 10


def fragile_replay(pkg, n_steps=N_STEPS, n=3, **sched):
    demo_host = mod(pkg, "trace.demo_host")
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")

    async def main():
        fab = fabric_mod.VirtualClockFabric(sched_of(pkg, n_steps, **sched))
        c = sim.Cluster("fragile_counter", cfg=sim.chan_config(n, tag="fab"),
                        http=False, fabric=fab)
        await c.start()
        demo_host.HUNT_DRIVER(c, fab)
        await fab.run(n_steps)
        gaps = demo_host.HUNT_ORACLE(c)
        seqs = {str(i): c[i].last for i in c.ids}
        regs = {str(i): registry_view(c[i].metrics.snapshot())
                for i in c.ids}
        await c.stop()
        return gaps, list(fab.delivery_log), dict(fab.stats), seqs, regs
    return asyncio.run(main())


FABRIC_CASES = {
    "fault_free": {},
    "reorder": dict(faults=[("1.1", "1.3", "Seq", 2, "delay", 2)]),
    "drop": dict(faults=[("1.1", "1.2", "Seq", 0, "drop", 0)]),
    "crash_cut": dict(crashed={"1.2": [2, 3]}, cut={("1.1", "1.3"): [4]}),
    "two_faults": dict(faults=[("1.1", "1.3", "Seq", 1, "delay", 3),
                               ("1.1", "1.2", "Seq", 4, "drop", 0)]),
}


@pytest.mark.parametrize("case", sorted(FABRIC_CASES))
def test_fabric_equals_reference(case):
    got = fragile_replay("paxi_tpu_torch", **FABRIC_CASES[case])
    assert got == fragile_replay("paxi_tpu", **FABRIC_CASES[case])
    assert got == fragile_replay("paxi_tpu_torch", **FABRIC_CASES[case])
    gaps, log, stats, seqs, _ = got
    if case == "fault_free":
        assert gaps == 0
        assert stats["submitted"] == stats["delivered"] == 2 * N_STEPS
        assert seqs == {"1.1": 0, "1.2": N_STEPS, "1.3": N_STEPS}
    elif case == "reorder":
        steps = [t for (t, _, dst, _) in log if dst == "1.3"]
        assert stats["delayed_fault"] == 1 and steps == sorted(steps)
        assert steps.count(5) == 2 and 3 not in steps and gaps == 1
    elif case == "drop":
        assert stats["dropped_fault"] == 1 and gaps == 1
        assert sum(dst == "1.2" for (_, _, dst, _) in log) == N_STEPS - 1
    elif case == "crash_cut":
        assert stats["dropped_crash"] == 2 and stats["dropped_cut"] == 1
        assert stats["delivered"] == 2 * N_STEPS - 3


@pytest.mark.parametrize("pkg", PKGS)
def test_ambient_fabric_wiring(pkg):
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")

    async def main():
        fab = fabric_mod.VirtualClockFabric()
        with fabric_mod.use_fabric(fab):
            c = sim.Cluster("fragile_counter", cfg=sim.chan_config(
                3, tag="amb"), http=False)
        await c.start()
        assert all(c[i].socket.fabric is fab for i in c.ids)
        assert set(fab._deliver) == {"1.1", "1.2", "1.3"}
        await c.stop()
        assert not fab._deliver
        assert fabric_mod.current_fabric() is None
    asyncio.run(main())


def test_two_runtimes_keep_their_own_state():
    """Each package has its own message registry, ambient fabric and
    chan fabric: nothing crosses."""
    jf, pf = mod("paxi_tpu", "host.fabric"), mod("paxi_tpu_torch",
                                                  "host.fabric")
    jc, pc = mod("paxi_tpu", "host.codec"), mod("paxi_tpu_torch",
                                                "host.codec")
    jn, pn = mod("paxi_tpu", "host.node"), mod("paxi_tpu_torch",
                                               "host.node")
    assert jc.registered("WireRequest") is jn.WireRequest
    assert pc.registered("WireRequest") is pn.WireRequest
    assert jn.WireRequest is not pn.WireRequest
    with pf.use_fabric(pf.VirtualClockFabric()):
        assert jf.current_fabric() is None
        assert pf.current_fabric() is not None
    # a frame of one runtime decodes in the other to its own class
    wr = pn.WireRequest(key=1, value=b"v", client_id="c", command_id=2,
                        properties={"trace": "t:s"})
    back = jc.Codec("json").decode_body(pc.Codec("json").encode(wr)[4:])
    assert type(back) is jn.WireRequest and back.properties == wr.properties


def test_http_serving_is_refused():
    """Once a refusal pin, now its reverse: ``Cluster("paxos", n=3)``
    serves the client REST API by default (``http=True``), and a PUT and
    a GET over HTTP answer as the JAX package's cluster does."""
    import _torch_serving as S

    async def main(pkg):
        sim = mod(pkg, "host.simulation")
        c = sim.Cluster("paxos", n=3)
        cfg = c.cfg
        assert set(cfg.http_addrs) == set(cfg.ids)
        # the chan peers stay; the HTTP addresses move to free ports
        cfg.http_addrs = {i: f"http://127.0.0.1:{p}"
                          for i, p in zip(cfg.ids, S.free_ports(3))}
        await c.start()
        try:
            assert all(r.http is not None for r in c.replicas.values())
            url = cfg.http_addrs[cfg.ids[0]]
            put = b"PUT /3 HTTP/1.1\r\nContent-Length: 2\r\n" \
                  b"Client-Id: t\r\nCommand-Id: 1\r\n\r\nok"
            get = b"GET /3 HTTP/1.1\r\nContent-Length: 0\r\n" \
                  b"Client-Id: t\r\nCommand-Id: 2\r\n\r\n"
            return await S.raw_exchange(url, put + get, n_responses=2)
        finally:
            await c.stop()

    got = S.run(main("paxi_tpu_torch"))
    assert got == S.run(main("paxi_tpu"))
    assert [b for _, _, b in got] == [b"", b"ok"]
    assert [s for s, _, _ in got] == ["HTTP/1.1 200 OK"] * 2


# ---- replay determinism (the fabric clock everywhere) ------------------------
def crash_armed_replay(pkg):
    command = mod(pkg, "core.command")
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")

    async def main():
        fab = fabric_mod.VirtualClockFabric()
        c = sim.Cluster("paxos", n=3, http=False, fabric=fab)
        await c.start()
        replies = []

        def driver(t):
            if t == 0:
                c["1.1"].handle_client_request(command.Request(
                    command=command.Command(0, b"seed", "c", 1),
                    reply_to=lambda rep: None))
            elif t == 2:
                for i in c.ids:     # the live fault surface, mid-replay
                    c[i].socket.crash(1000.0)
            elif t == 3:
                c["1.1"].handle_client_request(command.Request(
                    command=command.Command(1, b"x", "c", 2),
                    reply_to=replies.append))

        fab.on_step(driver)
        await fab.run(8, drain=True)
        out = (list(fab.delivery_log), dict(fab.stats),
               {str(i): c[i].db.get(1) for i in c.ids},
               [r.err for r in replies],
               {str(i): registry_view(c[i].metrics.snapshot())
                for i in c.ids})
        await c.stop()
        return out
    return asyncio.run(main())


def test_crash_armed_replay_commits_and_is_byte_identical():
    a = crash_armed_replay("paxi_tpu_torch")
    assert a == crash_armed_replay("paxi_tpu_torch")
    assert a == crash_armed_replay("paxi_tpu")
    _, stats, db, errs, _ = a
    assert errs == [None] and stats["delivered"] > 0
    assert db == {"1.1": b"x", "1.2": b"x", "1.3": b"x"}


@pytest.mark.parametrize("pkg", PKGS)
def test_crash_window_still_arms_live_sockets(pkg):
    Socket = mod(pkg, "host.socket").Socket
    ID = mod(pkg, "core.ident").ID
    sim = mod(pkg, "host.simulation")

    async def main():
        crashed = Socket(ID("1.1"), sim.chan_config(1, tag="live-crash"))
        assert crashed.fabric is None
        crashed.crash(1000.0)
        crashed._deliver("m")
        assert crashed.inbox.qsize() == 0
        fresh = Socket(ID("1.1"), sim.chan_config(1, tag="live-fresh"))
        fresh._deliver("m")
        assert fresh.inbox.qsize() == 1
    asyncio.run(main())


def forward_stamp(pkg, fabric):
    command = mod(pkg, "core.command")
    ID = mod(pkg, "core.ident").ID
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")

    async def main():
        fab = fabric_mod.VirtualClockFabric() if fabric else None
        c = sim.Cluster("paxos", n=3, http=False, fabric=fab)
        await c.start()
        r2 = c["1.2"]
        sent = []
        r2.socket.send = lambda to, msg: sent.append(msg)
        req = command.Request(command=command.Command(5, b"v", "cli", 1))
        if fab is None:
            r2.forward(ID("1.1"), req)
            for _ in range(10):
                await asyncio.sleep(0)
                if sent:
                    break
        else:
            fab.on_step(lambda t: t == 4 and r2.forward(ID("1.1"), req))
            await fab.run(6, drain=True)
        await c.stop()
        return [(type(m).__name__, m.timestamp) for m in sent]
    return asyncio.run(main())


def test_forward_stamp_rides_fabric_clock():
    got = forward_stamp("paxi_tpu_torch", True)
    assert got == forward_stamp("paxi_tpu", True) == [("WireRequest", 4.0)]
    (live,) = forward_stamp("paxi_tpu_torch", False)
    assert live[0] == "WireRequest" and live[1] > 0.0


def lease_replay(pkg):
    command = mod(pkg, "core.command")
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")

    def req(key, value, cid, sink):
        return command.Request(command=command.Command(key, value, "c", cid),
                               reply_to=sink.append)

    async def main():
        fab = fabric_mod.VirtualClockFabric()
        cfg = sim.chan_config(3, tag="lease-replay")
        cfg.leader_reads = True
        cfg.lease_s = 5.0               # virtual steps under a fabric
        c = sim.Cluster("paxos", cfg=cfg, n=3, http=False, fabric=fab)
        await c.start()
        reads, writes = [], []
        plan = {0: (b"v1", 1, writes), 7: (b"", 2, reads),
                8: (b"v2", 3, writes), 10: (b"", 4, reads)}

        def driver(t):
            if t == 2:
                for i in c.ids:
                    c[i].socket.crash(1000.0)
            elif t in plan:
                value, cid, sink = plan[t]
                c["1.1"].handle_client_request(req(7, value, cid, sink))

        fab.on_step(driver)
        await fab.run(16, drain=True)
        out = (list(fab.delivery_log), dict(fab.stats),
               {str(i): c[i].db.get(7) for i in c.ids},
               [(r.value, r.err) for r in reads], [r.err for r in writes])
        await c.stop()
        return out
    return asyncio.run(main())


def test_leader_lease_reads_replay_byte_identical():
    a = lease_replay("paxi_tpu_torch")
    assert a == lease_replay("paxi_tpu_torch") == lease_replay("paxi_tpu")
    _, stats, db, reads, werrs = a
    assert werrs == [None, None]
    assert reads == [(b"v1", None), (b"v2", None)]
    assert db == {"1.1": b"v2", "1.2": b"v2", "1.3": b"v2"}


# ---- obs: the span model, sampler, collector and stitch math -----------------
def _doc(trace, sid, parent, kind, t0, t1, node="n", **labels):
    return {"trace": trace, "sid": sid, "parent": parent, "kind": kind,
            "node": node, "t0": float(t0), "t1": float(t1),
            "labels": {k: str(v) for k, v in labels.items()}}


SPANS = [
    _doc("t1", "c-1", "", "request", 0, 10, node="client"),
    _doc("t1", "n-1", "c-1", "batch", 2, 3),
    _doc("t1", "n-2", "c-1", "quorum", 3, 6),
    _doc("t1", "n-3", "n-2", "exec", 6, 7),
    _doc("t1", "n-10", "c-1", "writeback", 7, 8),
    _doc("t2", "c-2", "", "request", 0, 4, node="client"),
    _doc("t3", "n-5", "gone-1", "exec", 1, 2),
    _doc("t4", "c-4", "", "txn", 0, 9, group="7"),
    _doc("t4", "a-1", "c-4", "tpc", 1, 2),
]


def _obs_run(pkg):
    obs = mod(pkg, "obs")
    stitch = mod(pkg, "obs.stitch")
    out = {}
    c = obs.TraceCtx("t", "s")
    out["ctx"] = (c.encode(), obs.TraceCtx.decode("t:s") == c,
                  obs.TraceCtx.decode(""), obs.TraceCtx.decode(":x"))

    class R:
        properties = {obs.TRACE_PROP: "a:b"}

    out["ctx_of"] = (obs.ctx_of(R()).encode(),
                     obs.first_ctx([object(), R()]).encode())
    sp = obs.Span("t", "n-1", "", "exec", "n", 1.0, 3.5)
    out["span"] = (sp.child().encode(), sp.dur, sp.to_json(),
                   obs.Span.from_json(sp.to_json()) == sp)
    out["validate"] = obs.validate_spans(
        [sp.to_json(), {"trace": 1}, dict(sp.to_json(), t1=0.0)])
    smp = obs.Sampler(0.25)
    out["sampler"] = [smp.decide() for _ in range(12)]
    out["sampler_edges"] = (obs.Sampler(0).decide(), obs.Sampler(1).decide())
    col = obs.SpanCollector(node="n", cap=3)
    ctx = obs.TraceCtx("t", "root")
    for i in range(5):
        col.open(("q", i // 2, i), "quorum", ctx, slot=str(i // 2))
    col.close_group(("q", 1))
    col.close(("q", 0, 0))
    out["collector"] = ([(d["sid"], d["parent"], d["labels"])
                         for d in col.export()], len(col))
    out["merge"] = [d["sid"] for d in obs.merge([SPANS[4:], SPANS[:4]])]
    out["sid_key"] = stitch.sid_key("1.1-10") > stitch.sid_key("1.1-9")
    out["trees"] = obs.trees(SPANS)
    out["orphans"] = [d["sid"] for d in obs.orphans(SPANS)]
    out["stitched"] = obs.stitched_traces(SPANS)
    out["phases"] = (obs.phases(SPANS, "t1"), obs.phases(SPANS, "nope"))
    out["aggregate"] = (obs.aggregate_phases(SPANS),
                        obs.aggregate_phases([]))
    labeled = [dict(d, labels=dict(d["labels"])) for d in SPANS[7:]]
    obs.label_group(labeled, 3)
    out["groups"] = obs.groups_of(labeled, "t4")
    fab = mod(pkg, "host.fabric").VirtualClockFabric()
    out["fabric_clock"] = (obs.SpanCollector(node="n", fabric=fab).now(),
                           fab.clock())
    return out


def test_obs_units_equal_reference():
    got = _obs_run("paxi_tpu_torch")
    assert got == _obs_run("paxi_tpu")
    assert got["sampler"].count(True) == 3
    # opens beyond the cap of 3 are shed
    assert got["collector"] == ([("n-3", "root", {"slot": "1"}),
                                 ("n-1", "root", {"slot": "0"})], 2)
    assert got["merge"][:3] == ["c-1", "c-2", "c-4"]
    assert got["orphans"] == ["n-5"] and "t1" in got["stitched"]
    ph = got["phases"][0]
    assert sum(ph[p] for p in ("queue", "batch", "quorum", "exec",
                               "writeback")) + ph["other"] == ph["e2e"]
    assert got["groups"] == ["3", "7"] and got["fabric_clock"] == (0.0, 0.0)


@pytest.mark.parametrize("kind", ["json", "pickle"])
def test_trace_context_survives_codec_batch(kind):
    def run(pkg):
        codec = mod(pkg, "host.codec")
        obs = mod(pkg, "obs")
        WireRequest = mod(pkg, "host.node").WireRequest
        c = codec.Codec(kind)
        reqs = [WireRequest(key=i, value=b"v", client_id="c", command_id=i,
                            properties={obs.TRACE_PROP: f"t1:n-{i}"})
                for i in range(3)]
        batch = [obs.ctx_of(g).encode() for g in codec.roundtrip(c, *reqs)]
        (one,) = codec.roundtrip(c, reqs[0])
        (plain,) = codec.roundtrip(c, WireRequest(
            key=9, value=b"", client_id="c", command_id=9))
        return batch, obs.ctx_of(one).encode(), obs.ctx_of(plain)
    got = run("paxi_tpu_torch")
    assert got == run("paxi_tpu")
    assert got == (["t1:n-0", "t1:n-1", "t1:n-2"], "t1:n-0", None)


def _registry_run(pkg):
    metrics = mod(pkg, "metrics")
    regs = []
    for node in ("1.1", "1.2"):
        r = metrics.Registry(node=node)
        r.counter("paxi_msgs_in_total", type="P2a").inc(3)
        r.gauge("paxi_inflight").set(2.5)
        h = r.histogram("paxi_commit_seconds")
        for v in (1e-5, 3e-4, 2e-3, 0.05, 2.0, 5e3):
            h.observe(v * (2 if node == "1.2" else 1))
        regs.append(r)
    snaps = [r.snapshot() for r in regs]
    merged = metrics.merge_snapshots(snaps)
    text = metrics.render_prometheus(merged)
    h = regs[0].histogram("paxi_commit_seconds")
    return (snaps, merged, text, metrics.parse_prometheus(text),
            metrics.pretty(merged), [h.percentile(p) for p in (50, 99)])


def test_registry_snapshots_equal_reference():
    got = _registry_run("paxi_tpu_torch")
    assert got == _registry_run("paxi_tpu")
    assert [c["value"] for c in got[1]["counters"]] == [3, 3]
    assert [h["count"] for h in got[1]["histograms"]] == [6, 6]


async def _traced_fabric_workload(pkg, tag):
    """3-replica paxos on the fabric; four writes injected with harness
    root spans under fixed trace ids; the merged span export."""
    command = mod(pkg, "core.command")
    obs = mod(pkg, "obs")
    fabric_mod = mod(pkg, "host.fabric")
    sim = mod(pkg, "host.simulation")
    fab = fabric_mod.VirtualClockFabric()
    c = sim.Cluster("paxos", cfg=sim.chan_config(3, tag=tag), http=False,
                    fabric=fab)
    await c.start()
    col = obs.SpanCollector(node="client", fabric=fab)
    try:
        for i in range(4):
            sp = col.start("request", obs.TraceCtx(f"w{i}"), key=str(i))
            fut = asyncio.get_running_loop().create_future()
            c["1.1"].handle_client_request(command.Request(
                command=command.Command(i, f"v{i}".encode(), "obs", i),
                properties={obs.TRACE_PROP: sp.child().encode()},
                reply_to=fut))
            task = asyncio.ensure_future(fut)
            for _ in range(300):
                if task.done():
                    break
                await fab.run(1)
            assert task.done() and task.result().err is None
            col.finish(sp)
        lists = [r.spans.export() for r in c.replicas.values()]
        lists.append(col.export())
        return obs.merge(lists)
    finally:
        await c.stop()


def test_two_fabric_replays_give_the_reference_timeline():
    obs = mod("paxi_tpu_torch", "obs")
    a = asyncio.run(_traced_fabric_workload("paxi_tpu_torch", "obsfa"))
    b = asyncio.run(_traced_fabric_workload("paxi_tpu_torch", "obsfa"))
    j = asyncio.run(_traced_fabric_workload("paxi_tpu", "obsfa"))
    assert obs.validate_spans(a) == []
    assert a == b == j
    stitched = obs.stitched_traces(a)
    assert stitched == [f"w{i}" for i in range(4)]
    for t in stitched:
        assert {"request", "quorum", "exec"} \
            <= {d["kind"] for d in a if d["trace"] == t}
        ph = obs.phases(a, t)
        assert ph is not None and ph["e2e"] > 0


def test_ids_and_local_config_equal_reference():
    """``ID``'s order is ``trace/host.py``'s ``id_order``, and
    ``local_ids`` is ``local_config(...).ids``, in both packages."""
    from paxi_tpu.core.config import local_config as jlocal
    from paxi_tpu_torch.core.config import local_config
    from paxi_tpu_torch.core.ident import ID
    from paxi_tpu_torch.trace.host import id_order, local_ids
    ids = ["1.10", "1.2", "2.1", "1.1", "3", "10.1", "2.10", "2.9"]
    assert [id_order(i) for i in sorted(ids, key=id_order)] \
        == [(i.zone, i.node) for i in sorted(map(ID, ids))]
    for n, z in ((3, 1), (5, 1), (9, 3), (12, 3), (20, 2)):
        assert local_ids(n, z) == [str(i) for i in local_config(n, zones=z).ids]
        assert [str(i) for i in local_config(n, zones=z).ids] \
            == [str(i) for i in jlocal(n, zones=z).ids]
