"""``bench-host`` of the port against the JAX package's, on the CPU: the
closed loop, a two-rate ``--open-loop``, the cluster in its own process
(``--cluster-proc``), the open loop over two generator processes
(``-gen_procs 2``) and the sharded ramp (``--shards 2``, two groups
behind the router, with its 2PC burst) in each package give lines of the
same keys and 0 anomalies.  The port's ``bench_shard`` twin at a toy
rate writes a document of the root ``bench_shard.py``'s keys under its
``--out``, never the root ``BENCH_SHARD.json``.  Every port comes from
the OS or a free block (``_torch_serving``).
"""

import json

import pytest

pytest.importorskip("jax")

import _torch_serving as S  # noqa: E402

_run, _last_json = S.run_cli, S.last_json


BENCH_ARGS = {
    "closed": ["-T", "1", "-warmup", "0.2", "-K", "16"],
    "open": ["--open-loop", "-rates", "150,300", "-step_s", "0.3",
             "-K", "16", "-conns", "2"],
}


@pytest.mark.parametrize("mode", sorted(BENCH_ARGS))
def test_bench_host_equals_reference_keys(mode, tmp_path):
    outs = {}
    for pkg in S.PKGS:
        argv = ["bench-host"] + BENCH_ARGS[mode] + [
            "-base_port", str(S.free_base(3)),
            "-out", str(tmp_path / f"{pkg}.json")]
        rc, text = _run(pkg, argv)
        assert rc == 0, text
        outs[pkg] = (_last_json(text),
                     json.loads((tmp_path / f"{pkg}.json").read_text()))
    (pline, pfull), (jline, jfull) = outs["paxi_tpu_torch"], outs["paxi_tpu"]
    assert sorted(pline) == sorted(jline)
    assert sorted(pfull) == sorted(jfull)
    assert pline["anomalies"] == jline["anomalies"] == 0
    assert pline["mode"] == jline["mode"]
    if mode == "open":
        assert [sorted(s) for s in pline["steps"]] \
            == [sorted(s) for s in jline["steps"]]
        assert pline["total_completed"] > 0
    else:
        assert pline["ops"] > 0 and pline["errors"] == 0


@pytest.mark.parametrize("mode", ["cluster_proc", "gen_procs"])
def test_bench_host_processes_equal_reference_keys(mode, tmp_path):
    """The cluster in its own ``server -simulation`` process, and the
    open loop fanned over two ``--attach`` generator processes."""
    argv = {"cluster_proc": ["--cluster-proc", "-T", "1", "-warmup", "0.2",
                             "-K", "16"],
            "gen_procs": ["--open-loop", "-gen_procs", "2", "-rates",
                          "200", "-step_s", "0.3", "-K", "16"]}[mode]
    lines = {}
    for pkg in S.PKGS:
        rc, text = _run(pkg, ["bench-host"] + argv + [
            "-base_port", str(S.free_base(3))])
        assert rc == 0, text
        lines[pkg] = _last_json(text)
    got, want = lines["paxi_tpu_torch"], lines["paxi_tpu"]
    assert sorted(got) == sorted(want) and got["cluster_proc"] is True
    assert got["anomalies"] == want["anomalies"] == 0
    if mode == "gen_procs":
        assert got["gen_procs"] == 2 and got["total_completed"] > 0
        assert [sorted(s) for s in got["steps"]] \
            == [sorted(s) for s in want["steps"]]


SHARD_ARGS = ["bench-host", "--shards", "2", "-shard_fleet", "4",
              "-shard_workers", "2", "-rates", "200", "-step_s", "0.3",
              "-K", "16", "-txns", "2"]


def test_bench_host_shards_is_refused(tmp_path):
    """``--shards 2`` through both CLIs: the same line and artifact keys,
    0 anomalies, the 2PC burst committed and atomic.  (The name is from
    when the port refused ``--shards`` with exit 2; it is refused no
    more.)"""
    outs = {}
    for pkg in S.PKGS:
        rc, text = _run(pkg, SHARD_ARGS + [
            "-base_port", str(S.free_shard_base(4)),
            "-out", str(tmp_path / f"{pkg}.json")])
        assert rc == 0, text
        outs[pkg] = (_last_json(text),
                     json.loads((tmp_path / f"{pkg}.json").read_text()))
    (pline, pfull), (jline, jfull) = outs["paxi_tpu_torch"], outs["paxi_tpu"]
    assert sorted(pline) == sorted(jline)
    assert sorted(pfull) == sorted(jfull)
    assert pline["anomalies"] == jline["anomalies"] == 0
    assert pline["mode"] == "shard-ramp" and pline["shards"] == 2
    assert [p["phase"] for p in pfull["phases"]] \
        == [p["phase"] for p in jfull["phases"]] == ["disjoint", "crossing"]
    assert [sorted(p) for p in pfull["phases"]] \
        == [sorted(p) for p in jfull["phases"]]
    assert sorted(pline["txn"]) == sorted(jline["txn"])
    assert pline["txn"]["committed"] == 2
    assert pline["txn"]["atomicity_violations"] == 0
    assert sorted(pline["router"]) == sorted(jline["router"])
    assert pline["router"]["forwards"] > 0


def test_bench_shard_twin_document(monkeypatch, tmp_path):
    """The ``bench_shard`` twin at a toy rate: G = 1, 2, 4 over a fleet of
    8, a migration in each G >= 2 run; the document's keys are the root
    script's, its exit code follows its gates, and the root
    ``BENCH_SHARD.json`` stays as it was."""
    import contextlib
    import importlib
    import io
    import sys
    root = S.mod("paxi_tpu_torch", "bench_shard").OUT.parents[2]
    before = (root / "BENCH_SHARD.json").read_bytes()
    sys.path.insert(0, str(root))
    try:
        ref = importlib.import_module("bench_shard")
    finally:
        sys.path.remove(str(root))
    twin = S.mod("paxi_tpu_torch", "bench_shard")
    assert (twin.GS, twin.BLIP_GATE) == (ref.GS, ref.BLIP_GATE)
    for k, v in {"BENCH_SHARD_FLEET": "8", "BENCH_SHARD_WORKERS": "2",
                 "BENCH_SHARD_RATES": "200", "BENCH_SHARD_STEP_S": "0.3"
                 }.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "shard" / "BENCH_SHARD.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = twin.main(["--out", str(out), "--base-port",
                        str(S.free_shard_base(8, runs=3))])
    doc = json.loads(out.read_text())
    want = json.loads(before)
    assert sorted(doc) == sorted(want)
    assert [r["shards"] for r in doc["curve"]] == [1, 2, 4]
    assert sorted(doc["curve"][0]) == sorted(want["curve"][0])
    assert all(r["anomalies"] == 0 for r in doc["curve"])
    assert all(r["txn"]["atomicity_violations"] == 0 for r in doc["curve"])
    assert doc["migration_gates_ok"] is True
    assert rc == (0 if doc["g4_above_g1_control"] else 1)
    last = json.loads(buf.getvalue().splitlines()[-1])
    assert last["anomalies"] == 0 and sorted(last["migration_blip_p99_ms"]) \
        == ["2", "4"]
    assert (root / "BENCH_SHARD.json").read_bytes() == before
    assert str(twin.OUT).startswith(str(root / "build"))
