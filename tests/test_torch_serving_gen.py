"""The port's load generators against the JAX package's, on the CPU.

``KeyGen`` draws the same keys for every ``Bconfig.distribution`` and
seed; ``OpenLoopBenchmark`` offers the same arrival schedule (offsets,
keys, ops, frames) for a seed, with and without a workload spec, run on
a virtual clock against connections that record each frame;
``surge_steps``/``host_rates`` and ``Stats.summary`` are equal.
"""

import types

import pytest

pytest.importorskip("jax")

from _torch_serving import PKGS, mod  # noqa: E402

DISTS = [dict(distribution="uniform"),
         dict(distribution="uniform", min=100, K=7),
         dict(distribution="conflict", conflicts=30),
         dict(distribution="conflict", conflicts=100, min=5),
         dict(distribution="normal", mu=20.0, sigma=9.0),
         dict(distribution="zipfian", zipfian_s=1.5, zipfian_v=2.0),
         dict(distribution="zipfian", K=50)]


def _keys(pkg, kw, seed, stream):
    config = mod(pkg, "core.config")
    b = config.Bconfig(**{"K": 40, **kw})
    gen = mod(pkg, "host.benchmark").KeyGen(b, seed=seed, stream=stream)
    return [gen.next() for _ in range(300)]


@pytest.mark.parametrize("case", range(len(DISTS)))
def test_keygen_equals_reference(case):
    for seed, stream in ((0, 0), (3, 2)):
        got = _keys("paxi_tpu_torch", DISTS[case], seed, stream)
        assert got == _keys("paxi_tpu", DISTS[case], seed, stream)
        assert len(set(got)) > 1


def test_keygen_unknown_distribution_raises_as_reference():
    for pkg in PKGS:
        config = mod(pkg, "core.config")
        gen = mod(pkg, "host.benchmark").KeyGen(
            config.Bconfig(distribution="pareto"))
        with pytest.raises(ValueError, match="unknown distribution"):
            gen.next()


# ---- the open loop on a virtual clock ----------------------------------------
class _Clock:
    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1000.0 + self.now

    async def sleep(self, d):
        self.now += max(d, 0.0)


def _recording_conn(clock, log):
    class Conn:
        def __init__(self, url):
            self.url = url
            self.pending_out = 0

        async def ensure(self):
            return None

        async def flush(self):
            return None

        def close(self):
            return None

        def submit_raw(self, frame, done):
            log.append((round(clock.now, 9), frame))
            if frame.startswith(b"POST /transaction"):
                n = frame.count(b'"key"')
                payload = ('{"ok": true, "values": [%s]}'
                           % ",".join(['""'] * n)).encode()
            else:
                payload = b""
            done(200, {}, payload, None)
    return Conn


def _open_loop(pkg, monkeypatch, seed, workload, ops_per_req):
    bm = mod(pkg, "host.benchmark")
    wl = mod(pkg, "workload").named_workload(workload) if workload else None
    clock, log = _Clock(), []
    monkeypatch.setattr(bm, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, time=clock.time))
    monkeypatch.setattr(bm, "asyncio", types.SimpleNamespace(
        sleep=clock.sleep))
    monkeypatch.setattr(bm, "_Conn", _recording_conn(clock, log))
    cfg = mod(pkg, "core.config").local_config(3)
    bench = bm.OpenLoopBenchmark(
        cfg, rates=[300.0, 900.0, 600.0], step_s=0.4, seed=seed, conns=3,
        K=32, W=0.4, key_base=10, ops_per_req=ops_per_req, workload=wl,
        wl_stream=1)
    import asyncio
    report = asyncio.run(bench.run())
    monkeypatch.undo()
    return log, report


@pytest.mark.parametrize("seed,workload,ops_per_req", [
    (0, "", 1), (7, "", 1), (1, "zipf99", 1), (2, "flash", 1),
    (3, "migrate", 1), (4, "", 3)])
def test_open_loop_schedule_equals_reference(monkeypatch, seed, workload,
                                             ops_per_req):
    got_log, got = _open_loop("paxi_tpu_torch", monkeypatch, seed,
                              workload, ops_per_req)
    want_log, want = _open_loop("paxi_tpu", monkeypatch, seed, workload,
                                ops_per_req)
    assert got_log == want_log
    assert got == want
    assert got["total_completed"] == ops_per_req * len(got_log)
    # the recording connections answer every read with the initial
    # value, so the verdict counts anomalies: the same count in both
    assert got["anomalies"] is not None and len(got_log) > 100


# ---- flash lowering and the summary --------------------------------------------
@pytest.mark.parametrize("name", ["uniform", "zipf99", "flash", "hotrange",
                                  "migrate"])
def test_surge_steps_and_host_rates_equal_reference(name):
    rates = [100.0 * (i + 1) for i in range(80)]
    j, p = (mod(pkg, "workload.compile") for pkg in PKGS)
    jw = mod("paxi_tpu", "workload").named_workload(name)
    pw = mod("paxi_tpu_torch", "workload").named_workload(name)
    for n in (0, 1, 31, 45, 100):
        assert p.surge_steps(pw, n) == j.surge_steps(jw, n)
    assert p.host_rates(pw, rates) == j.host_rates(jw, rates)
    if name == "flash":
        assert any(p.surge_steps(pw, 100))
        assert max(p.host_rates(pw, rates)) > max(rates)


def _summary(pkg, lats, **kw):
    bm = mod(pkg, "host.benchmark")
    stats = bm.Stats(ops=len(lats), errors=2, duration=3.5, **kw)
    for x in lats:
        stats.hist.observe(x)
    return stats.summary(), [bm.Stats._pct(sorted(lats), p)
                             for p in (50, 95, 99, 100)]


@pytest.mark.parametrize("kw", [{}, {"anomalies": 0},
                                {"warmup_s": 1.0, "warmup_ops": 9,
                                 "anomalies": 3}])
def test_stats_summary_equals_reference(kw):
    import random
    rng = random.Random(5)
    lats = [rng.expovariate(400.0) for _ in range(500)]
    got = _summary("paxi_tpu_torch", lats, **kw)
    assert got == _summary("paxi_tpu", lats, **kw)
    assert got[0]["ops"] == 500 and got[0]["latency_p99_ms"] > 0
    assert _summary("paxi_tpu_torch", [], **kw) == _summary("paxi_tpu", [],
                                                            **kw)
