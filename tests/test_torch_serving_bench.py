"""``bench-host`` of the port against the JAX package's, on the CPU: the
closed loop, a two-rate ``--open-loop``, the cluster in its own process
(``--cluster-proc``) and the open loop over two generator processes
(``-gen_procs 2``) in each package give lines of the same keys and 0
anomalies; ``--shards`` exits 2 (``shard/`` is not ported).  Every port
comes from the OS (``_torch_serving``).
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


def test_bench_host_shards_is_refused(capsys):
    rc, _ = _run("paxi_tpu_torch", ["bench-host", "--shards", "2"])
    assert rc == 2
    assert "shard/" in capsys.readouterr().err
