"""The port's serving stack against the JAX package's, on the CPU.

- The wire: ``_response`` and ``read_request`` byte for byte, bad and
  oversized heads included; a 3-replica paxos ``Cluster(http=True)`` of
  each package on its chan fabric answering the same scripted requests
  (KV, ``/transaction``, ``/local``, refusals, every admin endpoint,
  ``/admin/history``, ``/metrics`` both ways and ``/spans`` with
  sampling on) with equal statuses, ``Err`` headers and bodies, and
  metrics and spans of the same names, labels and shapes.
- Interop: the port's ``Client`` against the JAX package's cluster and
  the JAX package's ``Client`` against the port's give the same answers.
- A closed loop of ``N`` ops at concurrency 1 records the same ordered
  history in both packages, with 0 anomalies.
- The native checker, built here with ``g++``, answers as the pure-Python
  loop and the JAX package's ``check_key`` on seeded random histories.
- ``obs.render`` gives the JAX package's strings on a host replay's spans.

Every port comes from the OS (``_torch_serving``).
"""

import asyncio
import json
import math
import random

import pytest

pytest.importorskip("jax")

import _torch_serving as S  # noqa: E402
from _torch_serving import PKGS, mod  # noqa: E402


# ---- the wire, unit by unit ------------------------------------------------
RESPONSES = [
    (200, b"", None), (200, b"value", None),
    (200, b"{}", {"Content-Type": "application/json"}),
    (400, b"", {"Err": "reserved value prefix"}), (404, b"", None),
    (405, b"", {"Err": "GET only"}),
    (500, b"", {"Err": "request timed out"}), (302, b"x", None),
]


@pytest.mark.parametrize("case", range(len(RESPONSES)))
def test_response_bytes_equal_reference(case):
    status, body, headers = RESPONSES[case]
    got = mod("paxi_tpu_torch", "host.http")._response(status, body, headers)
    assert got == mod("paxi_tpu", "host.http")._response(status, body,
                                                         headers)
    assert got.startswith(b"HTTP/1.1 %d " % status) and got.endswith(body)


HEADS = [
    b"GET /1 HTTP/1.1\r\nContent-Length: 0\r\nClient-Id: c\r\n"
    b"Command-Id: 1\r\n\r\n",
    b"PUT /7 HTTP/1.1\r\nContent-Length: 3\r\nProperty-Trace: t:1\r\n"
    b"\r\nabc",
    b"POST /transaction HTTP/1.1\r\ncontent-length: 2\r\n\r\n[]",
    b"GET /metrics?format=json HTTP/1.1\r\n\r\n",
    b"BROKEN\r\n\r\n",                          # no method/path split
    b"GET /1 HTTP/1.1\r\nContent-Length: x\r\n\r\n",
    b"GET /1 HTTP/1.1\r\nContent-Length: 5\r\n\r\nab",   # short body
    b"GET /1 HTTP/1.1\r\nHost: a",                         # no head end
    b"GET /" + b"k" * 200 + b" HTTP/1.1\r\n\r\n",          # oversized
]


def _read_one(pkg, raw):
    http = mod(pkg, "host.http")

    async def main():
        reader = asyncio.StreamReader(limit=128)
        reader.feed_data(raw)
        reader.feed_eof()
        try:
            return ("ok", await http.read_request(reader))
        except Exception as e:  # the failure is the datum compared
            return ("raised", type(e).__name__, str(e))
    return S.run(main())


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_read_request_equals_reference(case):
    got = _read_one("paxi_tpu_torch", HEADS[case])
    assert got == _read_one("paxi_tpu", HEADS[case])
    if case == len(HEADS) - 1:
        assert got == ("raised", "ValueError", "oversized request head")


# ---- one cluster of each package, the same scripted requests ---------------
def _req(method, path, body=b"", headers=None):
    h = {"Content-Length": str(len(body))}
    h.update(headers or {})
    head = f"{method} {path} HTTP/1.1\r\n" + "".join(
        f"{k}: {v}\r\n" for k, v in h.items()) + "\r\n"
    return head.encode() + body


def _kv(method, key, body=b"", cid="s", cmd=1):
    return _req(method, f"/{key}", body,
                {"Client-Id": cid, "Command-Id": str(cmd)})


TXN = json.dumps([{"key": 2, "value": "x"}, {"key": 1}]).encode()
# (replica index, request): sent one at a time, in order
SCRIPT = [
    (0, _kv("PUT", 1, b"a", cmd=1)),
    (0, _kv("GET", 1, cmd=2)),
    (1, _kv("GET", 1, cmd=3)),                  # forwarded to the leader
    (0, _kv("GET", 99, cmd=4)),                 # missing key
    (0, _kv("POST", 3, b"b", cmd=5)),
    (0, _req("POST", "/transaction", TXN,
             {"Client-Id": "s", "Command-Id": "6"})),
    (0, _req("POST", "/transaction", b"[]")),   # empty: 400
    (0, _req("GET", "/transaction")),           # 405
    (0, _kv("PUT", 4, b"\x00txn!", cmd=7)),     # reserved prefix
    (0, _req("PUT", "/5", b"v", {"Property-Note": "n"})),   # slow path
    (0, _req("GET", "/local/1")),
    (0, _req("GET", "/local/x")),
    (0, _req("GET", "/notakey")),
    (0, _req("GET", "/a/b/c")),                 # unknown route
    (0, _req("POST", "/metrics")),              # 405
    (0, _req("POST", "/spans")),                # 405
    (0, _req("POST", "/tpc", b'{"kind": "nope"}')),
    (0, _req("POST", "/mig", b'{"kind": "nope"}')),
    (2, _req("POST", "/admin/drop?id=1.1&t=0.01")),
    (2, _req("POST", "/admin/slow?id=1.1&delay=1&t=0.01")),
    (2, _req("POST", "/admin/flaky?id=1.1&p=0&t=0.01")),
    (2, _req("POST", "/admin/crash?t=0.01")),
    (2, _req("POST", "/admin/drop")),           # missing args: 400
    (2, _req("POST", "/admin/nope")),           # 404
    (0, _req("GET", "/admin/history?key=1")),
    (0, _req("GET", "/admin/history?key=x")),
]


def _shape(x):
    """A JSON value's structure: keys and element shapes, no values (a
    histogram's sparse bucket map counts as one value)."""
    if isinstance(x, dict) and x and all(k.isdigit() for k in x):
        return "sparse"
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return sorted({json.dumps(_shape(v), sort_keys=True) for v in x})
    return type(x).__name__


def _series(snap):
    return {kind: sorted({(m["name"], tuple(sorted(m["labels"].items())))
                          for m in snap[kind]})
            for kind in ("counters", "histograms")}


async def _serve_script(pkg):
    sim = mod(pkg, "host.simulation")
    obs = mod(pkg, "obs")
    cfg = S.serving_config(pkg)
    urls = [cfg.http_addrs[i] for i in cfg.ids]
    c = sim.Cluster("paxos", cfg=cfg)
    await c.start()
    obs.set_sample_rate(1.0)
    try:
        out = []
        for who, frame in SCRIPT:
            (status, headers, body), = await S.raw_exchange(urls[who], frame)
            out.append((status, headers.get("err"), body))
        # let the crash window close before the scrapes
        await asyncio.sleep(0.05)
        (_, _, mjson), = await S.raw_exchange(
            urls[0], _req("GET", "/metrics?format=json"))
        (_, mh, mtext), = await S.raw_exchange(urls[0],
                                               _req("GET", "/metrics"))
        (_, _, sp), = await S.raw_exchange(urls[0], _req("GET", "/spans"))
        (_, _, sp2), = await S.raw_exchange(urls[0],
                                            _req("GET", "/spans?clear=1"))
        (_, _, sp3), = await S.raw_exchange(urls[0], _req("GET", "/spans"))
        return {"script": out, "metrics": json.loads(mjson),
                "metrics_type": mh["content-type"],
                "prom_names": sorted({ln.split("{")[0].split(" ")[0]
                                      for ln in mtext.decode().splitlines()
                                      if ln and not ln.startswith("#")}),
                "spans": json.loads(sp), "spans_again": json.loads(sp2),
                "spans_cleared": json.loads(sp3)}
    finally:
        obs.set_sample_rate(0.0)
        await c.stop()


@pytest.fixture(scope="module")
def served():
    return {pkg: S.run(_serve_script(pkg)) for pkg in PKGS}


def test_scripted_requests_equal_reference(served):
    got, want = served["paxi_tpu_torch"], served["paxi_tpu"]
    assert got["script"] == want["script"]
    statuses = [s.split()[1] for s, _, _ in got["script"]]
    assert statuses.count("200") >= 12 and "404" in statuses \
        and "405" in statuses and "400" in statuses
    assert got["script"][1][2] == b"a" and got["script"][2][2] == b"a"
    assert json.loads(got["script"][5][2]) == {"ok": True,
                                               "values": ["", "a"]}


def test_metrics_scrape_equals_reference(served):
    got, want = served["paxi_tpu_torch"], served["paxi_tpu"]
    assert _series(got["metrics"]) == _series(want["metrics"])
    assert _shape(got["metrics"]) == _shape(want["metrics"])
    assert got["metrics_type"] == want["metrics_type"]
    assert got["prom_names"] == want["prom_names"]
    assert "paxi_client_requests_total" in got["prom_names"]


def test_spans_scrape_equals_reference(served):
    got, want = served["paxi_tpu_torch"], served["paxi_tpu"]
    obs = mod("paxi_tpu_torch", "obs")
    for key in ("spans", "spans_again", "spans_cleared"):
        assert _shape(got[key]) == _shape(want[key]), key
        assert got[key]["node"] == want[key]["node"] == "1.1"
    kinds = sorted(d["kind"] for d in got["spans"]["spans"])
    assert kinds == sorted(d["kind"] for d in want["spans"]["spans"])
    assert "request" in kinds and obs.validate_spans(
        got["spans"]["spans"]) == []
    assert got["spans"] == got["spans_again"] or \
        len(got["spans_again"]["spans"]) >= len(got["spans"]["spans"])
    assert got["spans_cleared"]["spans"] == []


# ---- interop: each package's Client against the other's cluster -----------
async def _client_session(client_pkg, cluster_pkg):
    sim = mod(cluster_pkg, "host.simulation")
    client_mod = mod(client_pkg, "host.client")
    cfg = S.serving_config(cluster_pkg, tag="interop")
    c = sim.Cluster("paxos", cfg=cfg)
    await c.start()
    cl = client_mod.Client(cfg, client_id=f"x-{client_pkg}")
    admin = client_mod.AdminClient(cfg)
    try:
        out = []
        await cl.put(1, b"one")
        out.append(await cl.get(1))
        out.append(await cl.get(2))
        out.append(await cl.transaction([(2, b"two"), (1, b"")]))
        out.append(await cl.get(2))
        out.append(await cl.local_get(1))
        await admin.flaky(str(cfg.ids[2]), str(cfg.ids[0]), 0.0, 0.01)
        await admin.slow(str(cfg.ids[2]), str(cfg.ids[0]), 1.0, 0.01)
        await admin.drop(str(cfg.ids[2]), str(cfg.ids[0]), 0.01)
        try:
            await admin._admin(cfg.ids[2], "/admin/nope")
        except IOError as e:
            out.append(str(e))
        out.append(sorted(d["kind"] for d in await cl.spans_all()))
        return out
    finally:
        cl.close()
        admin.close()
        await c.stop()


def test_clients_interoperate_both_ways():
    want = S.run(_client_session("paxi_tpu", "paxi_tpu"))
    assert want[:5] == [b"one", b"", [b"", b"one"], b"two", b"one"]
    assert S.run(_client_session("paxi_tpu_torch", "paxi_tpu")) == want
    assert S.run(_client_session("paxi_tpu", "paxi_tpu_torch")) == want
    assert S.run(_client_session("paxi_tpu_torch", "paxi_tpu_torch")) == want


# ---- a closed loop of N ops --------------------------------------------------
async def _closed_loop(pkg, n_ops=80):
    sim = mod(pkg, "host.simulation")
    config = mod(pkg, "core.config")
    bm = mod(pkg, "host.benchmark")
    cfg = S.serving_config(pkg, tag="loop")
    c = sim.Cluster("paxos", cfg=cfg)
    await c.start()
    try:
        b = config.Bconfig(T=0, N=n_ops, K=4, W=0.5, concurrency=1,
                           linearizability_check=True)
        bench = bm.Benchmark(cfg, b, seed=3)
        stats = await bench.run()
    finally:
        await c.stop()
    ops = sorted((o.start, k, o) for k, v in bench.history._ops.items()
                 for o in v)
    hist = [("r", k, o.output) if o.is_read else ("w", k, o.input)
            for _, k, o in ops]
    return stats, hist


def test_closed_loop_history_equals_reference():
    pstats, phist = S.run(_closed_loop("paxi_tpu_torch"))
    jstats, jhist = S.run(_closed_loop("paxi_tpu"))
    assert phist == jhist and len(phist) == 80
    assert (pstats.ops, pstats.errors, pstats.anomalies) \
        == (jstats.ops, jstats.errors, jstats.anomalies) == (80, 0, 0)
    assert {k for k in pstats.summary()} == {k for k in jstats.summary()}
    assert {kind for kind, _, _ in phist} == {"r", "w"}


# ---- the native checker ------------------------------------------------------
def _history(rng, n_ops, stale, lost):
    """One key's register history: a share ``stale`` of the reads return
    an older value, and a share ``lost`` of the writes never land."""
    history = mod("paxi_tpu_torch", "host.history")
    ops, t, current, vals = [], 0.0, b"", 0
    for _ in range(n_ops):
        t += rng.random()
        dur = rng.random() * 2
        if rng.random() < 0.5:
            vals += 1
            v = f"v{vals}".encode()
            if not rng.random() < lost:
                current = v
            end = math.inf if rng.random() < 0.02 else t + dur
            ops.append(history.Operation(v, None, t, end))
        else:
            out = current
            if rng.random() < stale and vals:
                out = f"v{max(vals - rng.randrange(1, 3), 1)}".encode()
            ops.append(history.Operation(None, out, t, t + dur))
    return ops


def _python_loop(ops):
    history = mod("paxi_tpu_torch", "host.history")
    anomalies = 0
    ops = sorted(ops, key=lambda o: (o.start, o.end))
    while True:
        bad = history._find_cycle_read(ops)
        if bad is None:
            return anomalies
        anomalies += 1
        ops = [o for o in ops if o is not bad]


def test_native_checker_builds_in_the_port():
    native = mod("paxi_tpu_torch", "host.native")
    assert native.native_available(), native.build_error
    path = native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.exists() and "paxi_tpu_torch" in str(native.SOURCE)


@pytest.mark.parametrize("seed,n_ops,stale,lost", [
    (0, 32, 0.0, 0.0), (2, 32, 0.3, 0.1), (2, 90, 0.0, 0.0),
    (3, 120, 0.2, 0.3), (4, 250, 0.05, 0.0), (5, 400, 0.0, 0.0),
    (7, 400, 0.05, 0.0)])
def test_native_checker_equals_reference(seed, n_ops, stale, lost):
    from paxi_tpu.host.history import Operation as JOp
    from paxi_tpu.host.history import check_key as jcheck
    native = mod("paxi_tpu_torch", "host.native")
    history = mod("paxi_tpu_torch", "host.history")
    ops = _history(random.Random(seed), n_ops, stale, lost)
    calls = native.calls
    got = native.check_key_native(ops)
    assert native.calls == calls + 1
    want = jcheck([JOp(o.input, o.output, o.start, o.end) for o in ops])
    assert got == _python_loop(ops) == want == history.check_key(ops)
    if stale:
        assert got > 0
    if not stale:
        assert got == 0


# ---- obs.render ----------------------------------------------------------------
def test_render_equals_reference():
    import test_torch_host_runtime as R
    spans = S.run(R._traced_fabric_workload("paxi_tpu", "render"))
    pspans = S.run(R._traced_fabric_workload("paxi_tpu_torch", "render"))
    assert pspans == spans
    prender = mod("paxi_tpu_torch", "obs.render")
    jrender = mod("paxi_tpu", "obs.render")
    for width in (24, 48):
        text = prender.ascii_timeline(spans, width=width)
        assert text == jrender.ascii_timeline(spans, width=width)
        assert text.count("\n") >= len(spans)
    assert prender.chrome_trace(spans) == jrender.chrome_trace(spans)
    one = [d for d in spans if d["trace"] == "w1"]
    assert prender.ascii_timeline(one) == jrender.ascii_timeline(one)
    assert prender.ascii_timeline([]) == jrender.ascii_timeline([])
