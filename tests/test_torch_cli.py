"""``python -m paxi_tpu_torch`` against ``python -m paxi_tpu``, on the CPU.

Each subcommand of the port's CLI (``-device cpu``) prints what the JAX
package's prints for the same arguments, compared after ``json.loads``
(the JAX sim casts its metrics with ``int``, the port's are 0-d tensors):
``sim`` fault-free and fuzzed, ``scenario run`` (sim side) and ``list``,
``workload run`` and ``list``, ``metrics --series`` (JSON and CSV),
``trace info|replay|shrink`` on a JAX-captured trace, ``hunt
run|status|report --no-host``, ``scenario run -host`` (the host runtime
on the virtual-clock fabric), and ``profile`` (its keys; timings differ
by nature).  Exit codes are the reference's.
"""

import contextlib
import io
import json

import pytest

pytest.importorskip("jax")

from paxi_tpu_torch import cli as pcli  # noqa: E402


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def both(argv, device=True):
    """(rc, stdout) of the JAX CLI and of the port's on ``argv``."""
    from paxi_tpu import cli as jcli
    j = _run(jcli.main, argv)
    p = _run(pcli.main, argv + (["-device", "cpu"] if device else []))
    return j, p


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def assert_same(argv, device=True, rc=0):
    (jrc, jout), (prc, pout) = both(argv, device)
    assert prc == jrc == rc
    assert _json_lines(pout) == _json_lines(jout)
    assert _json_lines(pout)
    return _json_lines(pout)


SMALL = ["-groups", "4", "-steps", "16", "-replicas", "3", "-slots", "16"]


@pytest.mark.parametrize("extra", [
    [], ["-p_drop", "0.2", "-p_dup", "0.1", "-max_delay", "3",
         "-p_crash", "0.1", "-p_partition", "0.2", "-seed", "3"]],
    ids=["fault_free", "fuzzed"])
def test_sim(extra):
    (line,) = assert_same(["sim", "-algorithm", "paxos"] + SMALL + extra)
    assert line["invariant_violations"] == 0 and line["groups"] == 4


def test_sim_violating_exit_code():
    (line,) = assert_same(["sim", "-algorithm", "fragile_counter",
                           "-groups", "4", "-steps", "20", "-p_drop", "0.3",
                           "-max_delay", "2"], rc=1)
    assert line["invariant_violations"] > 0


def test_sim_profile_trace(tmp_path):
    rc, out = _run(pcli.main, ["sim"] + SMALL + [
        "-profile", str(tmp_path / "prof"), "-device", "cpu"])
    assert rc == 0 and json.loads(out)["groups"] == 4
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_scenario_run_and_list():
    (line,) = assert_same(["scenario", "run", "-scenario", "wan3z",
                           "-algorithm", "paxos", "-replicas", "3",
                           "-zones", "3", "-groups", "4", "-steps", "24",
                           "-p_drop", "0.1"])
    assert line["runtime"] == "sim" and line["scenario"] == "wan3z"
    (j, jout), (p, pout) = both(["scenario", "list"])
    assert p == j == 0 and pout == jout and len(_json_lines(pout)) >= 8


def test_scenario_refusals():
    (j, _), (p, _) = both(["scenario", "run", "-scenario", "nope"])
    assert j == p == 2
    (j, _), (p, _) = both(["scenario", "run", "-scenario", "wan3z",
                           "-replicas", "2"])
    assert j == p == 2
    # the host fabric: paxos under wan3z prints the JAX package's line
    # and exit code (both host runtimes count one anomaly in this run)
    (line,) = assert_same(["scenario", "run", "-host", "-scenario", "wan3z",
                           "-algorithm", "paxos", "-replicas", "3",
                           "-zones", "3", "-steps", "40"], rc=1)
    assert line["runtime"] == "host" and line["ops_ok"] > 0
    assert line["fabric_stats"]["edge_delayed"] > 0
    (j, _), (p, _) = both(["scenario", "run", "-host", "-algorithm", "paxos",
                           "-replicas", "3", "-zones", "3", "-p_drop", "0.1"])
    assert j == p == 2
    # the defaults: wpaxos 3 x 3 under wan3z on its host twin, whose
    # linearizability history counts anomalies in both packages
    (line,) = assert_same(["scenario", "run", "-host"], rc=1)
    assert line["algorithm"] == "wpaxos" and line["anomalies"] > 0
    assert line["oracle_violations"] == 0 and line["ops_failed"] == 0


def test_workload_run_and_list():
    (line,) = assert_same(["workload", "run", "-workload", "zipf99",
                           "-groups", "4", "-steps", "24"])
    assert line["key_class_latency"] and line["workload"] == "zipf99"
    (j, jout), (p, pout) = both(["workload", "list", "-keys", "32"])
    assert p == j == 0 and pout == jout
    (j, _), (p, _) = both(["workload", "run", "-workload", "nope"])
    assert j == p == 2


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_metrics_series(fmt):
    argv = ["metrics", "--series", "-groups", "4", "-steps", "12",
            "-p_drop", "0.2", "-max_delay", "2"]
    if fmt == "csv":
        argv.append("--csv")
    (j, jout), (p, pout) = both(argv)
    assert j == p == 0
    if fmt == "csv":
        assert pout == jout and pout.count("\n") == 12 + 3
    else:
        assert json.loads(pout) == json.loads(jout)
    rc, _ = _run(pcli.main, ["metrics", "-device", "cpu"])
    assert rc == 2


@pytest.fixture(scope="module")
def jax_trace(tmp_path_factory):
    """A fragile_counter witness captured by the JAX package, as a file."""
    from paxi_tpu import trace as jtr
    from paxi_tpu.hunt import cases as jc
    from paxi_tpu.protocols import sim_protocol
    name, cfg, scheds, groups, steps, _ = jc.DEMO_CASES[0]
    t = jtr.capture(sim_protocol(name), cfg, scheds[0], 1, groups, steps,
                    proto_name=name)
    return jtr.save(str(tmp_path_factory.mktemp("t") / "witness"), t)


def test_trace_info_replay(jax_trace):
    (info,) = assert_same(["trace", "info", jax_trace])
    assert info["protocol"] == "fragile_counter" and info["events"] > 0
    (rep,) = assert_same(["trace", "replay", jax_trace])
    assert rep["reproduced"] is True
    (rep2,) = assert_same(["trace", "replay", "--twice", jax_trace])
    assert rep2 == rep


def test_trace_shrink(jax_trace, tmp_path):
    from paxi_tpu import cli as jcli
    outs = {}
    for who, main, extra in (("jax", jcli.main, []),
                             ("port", pcli.main, ["-device", "cpu"])):
        rc, out = _run(main, ["trace", "shrink", jax_trace, "-o",
                              str(tmp_path / who), "--max-trials", "20"]
                       + extra)
        assert rc == 0
        lines = out.splitlines()
        stats = json.loads(lines[-1])
        assert stats.pop("out").startswith(str(tmp_path / who))
        outs[who] = (lines[:-1], stats)
    assert outs["port"] == outs["jax"]
    # the port's minimal witness replays in the port, reproduced
    rc, out = _run(pcli.main, ["trace", "replay", str(tmp_path / "port.npz"),
                               "-device", "cpu"])
    assert rc == 0 and json.loads(out)["reproduced"] is True


def test_hunt_run_status_report(tmp_path):
    from paxi_tpu import cli as jcli
    common = ["--protocols", "fragile_counter", "--budget", "1", "--quick",
              "--shrink-trials", "40", "--no-host", "--traces-dir",
              str(tmp_path / "none"), "--quiet"]
    lines = {}
    for who, main, extra in (("jax", jcli.main, []),
                             ("port", pcli.main, ["--device", "cpu"])):
        d = ["--dir", str(tmp_path / who)]
        for cmd in ("run", "status", "report"):
            rc, out = _run(main, ["hunt", cmd] + d + common + extra)
            assert rc == 0, (who, cmd)
            lines[who, cmd] = _json_lines(out)
    for cmd in ("run", "status", "report"):
        assert lines["port", cmd] == lines["jax", cmd], cmd
    assert lines["port", "run"][0]["totals"]["witnesses"] == 1
    # host replay on for a seeded twin's base: wankeeper_nofloor with no
    # run to do prints the JAX package's lines
    d = ["--dir", str(tmp_path / "port"), "--protocols", "fragile_counter",
         "--device", "cpu"]
    nofloor = ["hunt", "run", "--protocols", "wankeeper_nofloor",
               "--budget", "0", "--traces-dir", str(tmp_path / "none"),
               "--quiet"]
    from paxi_tpu import cli as jcli
    j, jout = _run(jcli.main, nofloor + ["--dir", str(tmp_path / "jn")])
    p, pout = _run(pcli.main, nofloor + ["--dir", str(tmp_path / "pn"),
                                         "--device", "cpu"])
    assert p == j == 0 and _json_lines(pout) == _json_lines(jout)
    rc, out = _run(pcli.main, ["hunt", "status", "--budget", "1"] + d)
    assert rc == 0 and json.loads(out) == lines["port", "status"][0]
    (j, _), (p, _) = both(["hunt", "status", "--dir", str(tmp_path / "x"),
                           "--protocols", "nope"])
    assert j == p == 2


@pytest.mark.parametrize("shard", ["0", "2"])
def test_profile_keys(shard):
    argv = ["profile", "-algorithm", "paxos_pg", "-groups", "4", "-steps",
            "8", "-repeats", "1", "-replicas", "3", "-slots", "16",
            "-shard", shard]
    (j, jout), (p, pout) = both(argv)
    assert j == p == 0
    a, b = json.loads(jout), json.loads(pout)
    assert sorted(b) == sorted(a) and sorted(b["phases"]) \
        == sorted(a["phases"])
    same = ("algorithm", "groups", "steps", "replicas", "ring_slots", "mesh",
            "committed_slots", "invariant_violations", "profile_dir")
    assert {k: b[k] for k in same} == {k: a[k] for k in same}
    assert b["phases"]["lower_s"] is None and b["hlo_ops"] is None
    assert b["exchange"] == "plain" and b["device"] == "cpu"


def test_sim_shard_one_process():
    """``sim -shard`` outside torchrun: this process alone, a mesh of one
    rank, which draws the rank's key (``split(rng, 1)[0]``)."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.parallel import make_mesh, make_sharded_run
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    rc, out = _run(pcli.main, ["sim", "-shard", "-device", "cpu"] + SMALL)
    got = json.loads(out)
    _, metrics, viols = make_sharded_run(
        sim_protocol("paxos"), SimConfig(n_replicas=3, n_slots=16),
        mesh=make_mesh(device="cpu"))(tr.PRNGKey(0), 4, 16)
    assert rc == 0 and got["invariant_violations"] == int(viols) == 0
    assert got["committed_slots"] == int(metrics["committed_slots"]) > 0
