"""The port's serving commands and twins against the JAX package's, on
the CPU.

- ``metrics -file`` on the committed ``BENCH_HOST.json`` and
  ``FUZZ_SOAK.json``, and ``spans render|export -file`` on a host
  replay's spans: the JAX package's output.
- ``server -simulation`` and ``client -N 60`` as subprocesses of the
  port: exit 0, 0 errors, 0 anomalies, the JSON keys of the JAX package's
  ``client`` line.
- The twins: ``bench_host`` on paxos and dynamo at ``BENCH_HOST_T=1`` and
  ``soak_host``'s schedules against the root scripts, and one paxos soak
  with 0 anomalies.  Neither writes the root JSON files.

Every port comes from the OS (``_torch_serving``).
"""

import asyncio
import contextlib
import importlib
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import _torch_serving as S  # noqa: E402
from _torch_serving import mod  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


_run, _last_json = S.run_cli, S.last_json


def both(argv):
    return _run("paxi_tpu", argv), _run("paxi_tpu_torch", argv)


@pytest.mark.parametrize("artifact,rc", [("BENCH_HOST.json", 0),
                                         ("FUZZ_SOAK.json", 1)])
def test_metrics_file_equals_reference(artifact, rc, capsys):
    """FUZZ_SOAK.json embeds no snapshot: both exit 1 with one message."""
    (j, jout), (p, pout) = both(["metrics", "-file", str(ROOT / artifact)])
    assert j == p == rc and pout == jout
    err = capsys.readouterr().err.splitlines()
    if rc:
        assert len(err) == 2 and err[0] == err[1]
    else:
        assert "counters:" in pout and "histograms:" in pout


def test_metrics_refusals_equal_reference(tmp_path):
    (tmp_path / "empty.json").write_text('{"a": [1, 2]}')
    (j, _), (p, _) = both(["metrics", "-file", str(tmp_path / "empty.json")])
    assert j == p == 1
    (j, _), (p, _) = both(["metrics"])
    assert j == p == 2


@pytest.fixture(scope="module")
def span_artifact(tmp_path_factory):
    import test_torch_host_runtime as R
    spans = S.run(R._traced_fabric_workload("paxi_tpu", "spancli"))
    path = tmp_path_factory.mktemp("spans") / "replay.json"
    path.write_text(json.dumps({"run": {"spans": spans}, "n": len(spans)}))
    return path


@pytest.mark.parametrize("cmd", ["render", "export"])
def test_spans_file_equals_reference(span_artifact, cmd, tmp_path):
    argv = ["spans", cmd, "-file", str(span_artifact)]
    (j, jout), (p, pout) = both(argv)
    assert j == p == 0 and pout == jout
    if cmd == "render":
        assert pout.rstrip().endswith("0 orphans")
    else:
        assert json.loads(pout)["traceEvents"]
        outs = [tmp_path / f"{pkg}.json" for pkg in S.PKGS]
        for pkg, out in zip(S.PKGS, outs):
            assert _run(pkg, argv + ["-out", str(out)])[0] == 0
        assert outs[0].read_text() == outs[1].read_text()
    (tmp_path / "none.json").write_text("[]")
    (j, _), (p, _) = both(["spans", cmd, "-file", str(tmp_path / "none.json")])
    assert j == p == 1


# ---- server -simulation + client, as processes ------------------------------
def test_server_and_client_processes(tmp_path):
    config = mod("paxi_tpu_torch", "core.config")
    transport = mod("paxi_tpu_torch", "host.transport")
    cfg = config.local_config(3, base_port=S.free_base(3))
    cfg.benchmark = config.Bconfig(T=0, N=60, K=8, concurrency=2,
                                   linearizability_check=True)
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    server = subprocess.Popen(
        [sys.executable, "-m", "paxi_tpu_torch", "server", "-simulation",
         "-algorithm", "paxos", "-config", path], cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        up = S.run(transport.wait_listening(cfg.http_addrs[cfg.ids[0]],
                                            timeout_s=S.WAIT_S), 40)
        assert up, server.stderr.read1().decode() if server.poll() else ""
        r = subprocess.run(
            [sys.executable, "-m", "paxi_tpu_torch", "client", "-config",
             path, "-N", "60", "-history_file", str(tmp_path / "h.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=90)
        assert r.returncode == 0, r.stderr[-3000:]
        got = _last_json(r.stdout)
    finally:
        server.terminate()
        try:
            server.wait(timeout=10)
        except subprocess.TimeoutExpired:
            server.kill()
            server.wait(timeout=10)
    # the JAX package's client prints its Stats.summary() (a second client
    # run against this server would reuse the benchmark's client and
    # command ids, which the server's at-most-once table answers from
    # its cache)
    want = mod("paxi_tpu", "host.benchmark").Stats(
        ops=60, errors=0, duration=1.0, anomalies=0).summary()
    assert sorted(got) == sorted(want)
    assert got["ops"] == 60 and got["errors"] == got["anomalies"] == 0
    assert json.loads((tmp_path / "h.json").read_text())


# ---- the twins ------------------------------------------------------------------
ROOT_FILES = ("BENCH_HOST.json", "SOAK_HOST.json")


@pytest.fixture
def root_files_untouched():
    before = {f: (ROOT / f).read_bytes() for f in ROOT_FILES}
    yield
    assert {f: (ROOT / f).read_bytes() for f in ROOT_FILES} == before


def _root_script(name):
    """One of the JAX package's root scripts (``bench_host.py``,
    ``soak_host.py``) as a module; its ``main`` is never called here."""
    sys.path.insert(0, str(ROOT))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(str(ROOT))


def _reference_row(monkeypatch, name, n, zones, lin):
    """The root script's ``bench_one`` on a free port block."""
    ref = _root_script("bench_host")
    base = S.free_base(n)
    monkeypatch.setattr(ref, "local_config",
                        lambda n, zones=1: mod("paxi_tpu", "core.config")
                        .local_config(n, zones=zones, base_port=base))
    return asyncio.run(ref.bench_one(name, n, zones, lin))


def test_bench_host_twin_lines(monkeypatch, tmp_path, root_files_untouched):
    bh = mod("paxi_tpu_torch", "bench_host")
    monkeypatch.setenv("BENCH_HOST_T", "1")
    out = tmp_path / "bh.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bh.main(["--protocols", "paxos,dynamo", "--out", str(out),
                      "--base-port", str(S.free_base(3))])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert rc == 0 and json.loads(out.read_text()) == lines
    assert [r["protocol"] for r in lines] == ["paxos", "dynamo"]
    rows = {r[0]: r for r in bh.CONFIGS}
    for got in lines:
        want = _reference_row(monkeypatch, *rows[got["protocol"]])
        assert sorted(got) == sorted(want)
        assert sorted(got["latency"]) == sorted(want["latency"])
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        assert got["consistency"] == want["consistency"]
        assert got["errors"] == want["errors"] == 0
    assert lines[0]["anomalies"] == 0 and lines[0]["ops"] > 0
    assert lines[1]["anomalies"] is None


def test_bench_host_twin_tables_equal_reference():
    ref_bench, ref_soak = _root_script("bench_host"), _root_script("soak_host")
    assert mod("paxi_tpu_torch", "bench_host").CONFIGS == ref_bench.CONFIGS
    assert mod("paxi_tpu_torch", "soak_host").CASES == ref_soak.CASES
    assert str(mod("paxi_tpu_torch", "bench_host").OUT).startswith(
        str(ROOT / "build"))
    assert str(mod("paxi_tpu_torch", "soak_host").OUT).startswith(
        str(ROOT / "build"))


def test_soak_schedules_equal_reference():
    ref = _root_script("soak_host")
    soak = mod("paxi_tpu_torch", "soak_host")
    phost = mod("paxi_tpu_torch", "trace.host")
    jhost = mod("paxi_tpu", "trace.host")
    pconf = mod("paxi_tpu_torch", "core.config")
    jconf = mod("paxi_tpu", "core.config")
    for name, n, zones, leader_too in soak.CASES:
        got = soak.fault_schedule(pconf.local_config(n, zones=zones).ids,
                                  leader_too)
        want = ref.fault_schedule(jconf.local_config(n, zones=zones).ids,
                                  leader_too)
        assert phost.directives_json(got) == jhost.directives_json(want)
        assert len(got) == 3 + leader_too, name


def test_soak_twin_paxos(monkeypatch, tmp_path, root_files_untouched):
    """The crash, drop and flaky windows open under load (4 s), the
    leader crash as it ends.  The server's 10 s request timeout stays:
    at 1 s, a timed-out write that the client retries elsewhere can also
    commit late, and both packages then count an anomaly under load."""
    soak = mod("paxi_tpu_torch", "soak_host")
    monkeypatch.setenv("SOAK_HOST_T", "4")
    out = tmp_path / "soak.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = soak.main(["--protocols", "paxos", "--out", str(out),
                        "--base-port", str(S.free_base(3))])
    (row,) = json.loads(out.read_text())
    assert rc == 0 and json.loads(buf.getvalue()) == row
    assert row["protocol"] == "paxos" and row["anomalies"] == 0
    assert row["ops"] > 0 and len(row["fault_schedule"]) == 4
    assert row["metrics"]["cluster"]["counters"]
