"""The hunt's host replay in the port against the JAX package's, on the CPU.

Every verdict here comes from both packages' host runtimes replaying the
same witness (the same ``.npz`` file, or the same hand-built schedule),
each on its own virtual-clock fabric: ``Classification.to_json()``, the
``HostOutcome`` JSON (with ``span_count``) and the merged span timeline
must be equal.  The cases:

- the JAX package's classifier fixtures (``tests/test_hunt.py``):
  reproduced, diverged (a phantom occurrence), unmappable (a mailbox
  outside the map, a duplication) and the lone-delay arm;
- a ``fragile_counter`` micro-campaign with host replay on, its
  ``state.json``, ``HUNT_REPORT.json`` and the report's markdown (above
  its static triage text) equal to the JAX package's apart from
  ``wall_s``, and a resume that redoes nothing;
- the ``switchpaxos_nogap`` witness at the hunt's 16 groups and the
  switchpaxos PART witness (32 groups x 140 steps, seed 1), each
  captured once by the port on the CPU;
- ``scenario run -host`` (paxos, switchpaxos, the demos, and the twins
  of slice 14: epaxos, wpaxos and wankeeper under wan3z) and ``trace
  host`` (``--all``, ``--seq``) printing ``python -m paxi_tpu``'s JSON;
  the twins with wall-clock timers run on one logical clock in both
  packages (``_torch_host_twins.step_clock``);
- host replay of protocols whose twins came in slice 14 (a
  ``wankeeper_nofloor`` fixture, ``hunt run`` over ``bpaxos_noread``),
  equal to the JAX package's, and a sim-only name failing as
  ``python -m paxi_tpu`` fails.
"""

import asyncio
import contextlib
import io
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from paxi_tpu_torch import cli as pcli  # noqa: E402
from paxi_tpu_torch import trace as ptr  # noqa: E402
from paxi_tpu_torch.hunt import cases as hc  # noqa: E402
from paxi_tpu_torch import hunt as P  # noqa: E402

import _torch_host_twins as H  # noqa: E402


def fixture_trace(pkg, faults=(), violations=1, n_steps=6, mailbox="seq",
                  protocol="fragile_counter"):
    """A hand-built single-group trace of ``pkg``'s own classes;
    ``faults``: (kind, t, i, j), kind in drop/dup/delay."""
    if pkg == "jax":
        from paxi_tpu.sim import FuzzConfig, SimConfig
        from paxi_tpu.trace.format import Trace, make_meta
    else:
        from paxi_tpu_torch.sim import FuzzConfig, SimConfig
        from paxi_tpu_torch.trace.format import Trace, make_meta
    R, T = 3, n_steps
    planes = {"drop": np.zeros((T, R, R), bool),
              "delay": np.ones((T, R, R), np.int32),
              "dup": np.zeros((T, R, R), bool)}
    for kind, t, i, j in faults:
        if kind == "delay":
            planes["delay"][t, i, j] = 2
        else:
            planes[kind][t, i, j] = True
    sched = {"conn": np.ones((T, R, R), bool),
             "crashed": np.zeros((T, R), bool),
             "faults": {mailbox: planes}}
    return Trace(meta=make_meta(protocol, SimConfig(n_replicas=3),
                                FuzzConfig(p_drop=0.2, max_delay=2), 0, 1, 0,
                                group_violations=violations), sched=sched)


FIXTURES = {
    "reproduced": dict(faults=[("drop", 1, 0, 2)]),
    "phantom": dict(faults=[("drop", 1, 1, 2)]),
    "unmapped": dict(faults=[("drop", 1, 0, 2)], mailbox="p2b"),
    "dup": dict(faults=[("dup", 1, 0, 2)]),
    "lone_delay": dict(faults=[("delay", 1, 0, 2)]),
    "delay_and_drop": dict(faults=[("delay", 1, 0, 2), ("drop", 2, 0, 1)]),
}
WANT = {"reproduced": "reproduced", "phantom": "diverged",
        "unmapped": "unmappable", "dup": "unmappable",
        "lone_delay": "unmappable", "delay_and_drop": "reproduced"}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_verdicts_equal_reference(name):
    from paxi_tpu.hunt import classify_witness as jcw
    got = P.classify_witness(fixture_trace("torch", **FIXTURES[name]))
    assert got.to_json() \
        == jcw(fixture_trace("jax", **FIXTURES[name])).to_json()
    assert got.outcome == WANT[name]
    if name == "reproduced":
        assert got.host["oracle_violations"] > 0
        assert "host bug candidate" in got.reason
    if name == "phantom":
        assert got.host["fabric_stats"]["dropped_fault"] == 0


@pytest.mark.parametrize("collisions", [None, 2, 0])
def test_lone_delay_collision_arm_equals_reference(collisions):
    from paxi_tpu.hunt import classify_witness as jcw
    ts = [fixture_trace(pkg, faults=[("delay", 1, 0, 2)])
          for pkg in ("torch", "jax")]
    if collisions is not None:
        for t in ts:
            t.meta["capture_counters"] = {"delay_collisions": collisions}
    got, want = P.classify_witness(ts[0]), jcw(ts[1])
    assert got.to_json() == want.to_json()
    # a clean replay of a lone delay is unmappable unless the counter
    # proves no collision
    assert got.outcome == ("diverged" if collisions == 0 else "unmappable")
    assert collisions == 0 or "lone-delay" in got.reason


# ---- the micro-campaign with host replay on --------------------------------
def _no_wall(x):
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


def _md_data(text):
    """The report's markdown above its static triage section."""
    return text.split("## Taxonomy / triage")[0]


def test_fragile_campaign_with_host_replay_equals_reference(tmp_path):
    from paxi_tpu.hunt import Campaign as JCampaign
    kw = dict(protocols=["fragile_counter"], budget=1, quick=True,
              shrink_trials=40, log=lambda m: None,
              traces_dir=str(tmp_path / "nothing"))
    rj = JCampaign(tmp_path / "jax", **kw).run()
    from paxi_tpu_torch.hunt import Campaign
    rp = Campaign(tmp_path / "port", device="cpu", **kw).run()
    assert _no_wall(rp) == _no_wall(rj)
    for name in ("state.json", "HUNT_REPORT.json", "corpus/index.json"):
        a = json.loads((tmp_path / "port" / name).read_text())
        b = json.loads((tmp_path / "jax" / name).read_text())
        assert _no_wall(a) == _no_wall(b), name
    md = (tmp_path / "port" / "HUNT_REPORT.md").read_text()
    assert _md_data(md) == _md_data(
        (tmp_path / "jax" / "HUNT_REPORT.md").read_text())
    tot = rp["summary"]["totals"]
    assert tot["runs"] == 1 and tot["witnesses"] >= 1
    assert tot["unclassified"] == 0
    assert (tot["reproduced"] + tot["diverged"] + tot["unmappable"]
            == tot["witnesses"])
    for w in rp["witnesses"].values():
        c = w["classification"]
        assert "span_count" in (c.get("host") or {"span_count": 0})
        if c["outcome"] == "unmappable":
            assert "lone-delay" in c["reason"], c
    assert "reproduced" in md and "Taxonomy" in md
    # resume: the budget is spent, nothing is redone
    rp2 = Campaign(tmp_path / "port", device="cpu", **kw).run()
    assert rp2["summary"] == rp["summary"]


# ---- the switchpaxos witnesses, captured by the port on the CPU -------------
@pytest.fixture(scope="module")
def witnesses(tmp_path_factory):
    """The nogap witness at the hunt's 16 groups and the PART witness at
    32 groups x 140 steps (seed 1), as files."""
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    d = tmp_path_factory.mktemp("sw_witnesses")
    name, cfg, scheds, groups, steps, _ = [
        c for c in hc.DEMO_CASES if c[0] == "switchpaxos_nogap"][0]
    nogap = ptr.capture(sim_protocol(name), cfg, scheds[0], 0, groups,
                        steps, proto_name=name, device="cpu")
    part = ptr.capture(sim_protocol("switchpaxos"),
                       SimConfig(n_replicas=5, n_slots=32), hc.PART, 1, 32,
                       140, proto_name="switchpaxos", device="cpu")
    assert nogap is not None and part is not None
    return {"nogap": ptr.save(str(d / "nogap"), nogap),
            "part": ptr.save(str(d / "part"), part)}


@pytest.mark.parametrize("which", ["nogap", "part"])
def test_switchpaxos_witness_replays_equal_reference(witnesses, which):
    from paxi_tpu import trace as jtr
    from paxi_tpu.hunt.classify import classify as jclassify
    from paxi_tpu.hunt.classify import coverage_of as jcov
    from paxi_tpu.hunt.classify import replay_witness as jrw
    path = witnesses[which]
    pt, jt = ptr.load(path), jtr.load(path)
    if which == "part":
        assert pt.meta["schedule_hash"].startswith("8a9d866c")
        assert pt.meta["group_violations"] == 45
    a = asyncio.run(P.replay_witness(pt))
    b = asyncio.run(P.replay_witness(pt))
    j = asyncio.run(jrw(jt))
    assert a.to_json() == b.to_json() == j.to_json()
    assert a.spans == b.spans == j.spans and len(a.spans) > 0
    assert a.to_json()["span_count"] == len(a.spans)
    cov = P.coverage_of(pt)
    assert cov == jcov(jt) and cov["exact"]
    v = pt.meta["group_violations"]
    got = P.classify(v, cov, a)
    assert got.to_json() == jclassify(v, jcov(jt), j).to_json()
    # both host runtimes stay safe under either schedule: the sim's
    # agreement breaks are not reproduced on the host
    assert got.outcome == "diverged" and not a.violated


def test_hunt_verdicts_on_the_witness_corpus(witnesses, tmp_path):
    """The JAX package's campaign and the port's classify the same seeded
    corpus to the same verdicts."""
    import shutil

    from paxi_tpu.hunt import Campaign as JCampaign
    from paxi_tpu_torch.hunt import Campaign
    seeds = tmp_path / "seeds"
    seeds.mkdir()
    shutil.copy(witnesses["nogap"], seeds)
    kw = dict(protocols=["switchpaxos_nogap"], budget=0, quick=True,
              log=lambda m: None, traces_dir=str(seeds))
    rj = JCampaign(tmp_path / "jax", **kw).run()
    rp = Campaign(tmp_path / "port", device="cpu", **kw).run()
    assert _no_wall(rp) == _no_wall(rj)
    assert rp["summary"]["totals"]["witnesses"] == 1
    assert rp["summary"]["totals"]["unclassified"] == 0


@pytest.mark.parametrize("seed", [0, 7])
def test_op_stream_and_timeline_equal_reference(seed):
    """The default KV workload draws its op stream from the standard
    library's ``random.Random(seed)`` (the port's own ``random`` module is
    another thing): the same keys, ops and span timeline as the JAX
    package's replay, and two port replays byte-identical."""
    import random
    import sys

    from paxi_tpu.hunt.classify import replay_schedule as jrs
    from paxi_tpu.sim import SimConfig as JSim
    from paxi_tpu.trace.host import SeqSchedule as JSched
    from paxi_tpu_torch.sim import SimConfig
    from paxi_tpu_torch.trace.host import SeqSchedule
    assert sys.modules["paxi_tpu_torch.hunt.classify"].random is random
    a, b = (asyncio.run(P.replay_schedule(
        "paxos", SimConfig(n_replicas=3), SeqSchedule(n_steps=30),
        seed=seed)) for _ in range(2))
    j = asyncio.run(jrs("paxos", JSim(n_replicas=3), JSched(n_steps=30),
                        seed=seed))
    ops = [(d["trace"], d["labels"]) for d in a.spans
           if d["node"] == "client"]
    assert ops == [(d["trace"], d["labels"]) for d in j.spans
                   if d["node"] == "client"] and len(ops) == 20
    assert a.spans == b.spans == j.spans
    assert a.to_json() == j.to_json() and not a.violated


# ---- the CLI: scenario run -host and trace host -----------------------------
def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{")]


def _both(argv):
    from paxi_tpu import cli as jcli
    return _run(jcli.main, argv), _run(pcli.main, argv)


def _both_clocked(argv, port_extra=()):
    """``_both`` with each package's timed twins on a logical clock."""
    from paxi_tpu import cli as jcli
    with H.step_clock("paxi_tpu", []):
        j = _run(jcli.main, argv)
    with H.step_clock("paxi_tpu_torch", []):
        p = _run(pcli.main, argv + list(port_extra))
    return j, p


@pytest.mark.parametrize("args", [
    ["-scenario", "churn", "-algorithm", "paxos", "-replicas", "3",
     "-zones", "1", "-steps", "50"],
    ["-scenario", "seqchurn", "-algorithm", "switchpaxos", "-replicas", "5",
     "-zones", "1", "-steps", "60", "-seed", "2"],
    ["-scenario", "wan3z", "-algorithm", "fragile_counter", "-replicas",
     "3", "-zones", "3", "-steps", "30"],
    ["-scenario", "wan3z", "-algorithm", "epaxos", "-replicas", "3",
     "-zones", "3"],
    ["-scenario", "wan3z", "-algorithm", "wpaxos", "-replicas", "9",
     "-zones", "3"],
    ["-scenario", "wan3z", "-algorithm", "wankeeper", "-replicas", "9",
     "-zones", "3", "-steps", "24"],
    ["-scenario", "churn", "-algorithm", "relay_churn", "-replicas", "3"],
], ids=["paxos_churn", "switchpaxos_seqchurn", "fragile_wan3z",
        "epaxos_wan3z", "wpaxos_wan3z", "wankeeper_wan3z", "relay_churn"])
def test_scenario_run_host_equals_reference(args):
    (jrc, jout), (prc, pout) = _both_clocked(
        ["scenario", "run", "-host"] + args)
    assert prc == jrc and pout == jout and len(pout) == 1
    assert pout[0]["runtime"] == "host"


@pytest.mark.parametrize("flags", [[], ["--seq"], ["--all"],
                                   ["--seq", "--step-ms", "20"]])
@pytest.mark.parametrize("which", ["nogap", "part"])
def test_trace_host_equals_reference(witnesses, which, flags):
    (jrc, jout), (prc, pout) = _both(["trace", "host", witnesses[which]]
                                     + flags)
    assert prc == jrc == 0 and pout == jout and len(pout) == 1
    if "--all" in flags:
        assert pout[0]["coverage"]["switchpaxos"]["exact"]
    if "--seq" in flags:
        assert pout[0]["sequenced"]["faults"]


def test_trace_host_on_a_fixture(tmp_path):
    path = ptr.save(str(tmp_path / "fx"), fixture_trace(
        "torch", faults=[("drop", 1, 0, 2), ("delay", 3, 0, 1),
                         ("dup", 2, 1, 0)]))
    for flags in ([], ["--seq"], ["--all"]):
        (jrc, jout), (prc, pout) = _both(["trace", "host", path] + flags)
        assert prc == jrc == 0 and pout == jout


# ---- the twins of slice 14 on the hunt's paths ------------------------------
def test_host_replay_of_a_queued_twin_is_refused(tmp_path):
    """No twin is queued any more: a ``wankeeper_nofloor`` witness replays
    on the wankeeper twin, ``hunt run`` takes ``bpaxos_noread`` with host
    replay on and ``scenario run -host`` takes epaxos, each giving the
    JAX package's output (the refusals these replaced exited 2)."""
    from paxi_tpu.hunt import classify_witness as jcw
    from paxi_tpu.hunt import replay_witness as jrw
    t = fixture_trace("torch", faults=[("drop", 1, 0, 2)], mailbox="p1a",
                      protocol="wankeeper_nofloor")
    jt = fixture_trace("jax", faults=[("drop", 1, 0, 2)], mailbox="p1a",
                       protocol="wankeeper_nofloor")
    with H.step_clock("paxi_tpu_torch", []):
        got = P.classify_witness(t)
        a = asyncio.run(P.replay_witness(t))
    with H.step_clock("paxi_tpu", []):
        want = jcw(jt)
        b = asyncio.run(jrw(jt))
    assert got.to_json() == want.to_json() and got.host is not None
    assert a.to_json() == b.to_json() and a.spans == b.spans
    assert a.ops_ok > 0 and a.steps == t.n_steps
    # with host replay off it classifies as a coverage gap, as in JAX
    assert P.classify_witness(t, host_replay=False).to_json() \
        == jcw(jt, host_replay=False).to_json()
    argv = ["hunt", "run", "--protocols", "bpaxos_noread", "--budget", "0",
            "--traces-dir", str(tmp_path / "none"), "--quiet"]
    from paxi_tpu import cli as jcli
    jrc, jout = _run(jcli.main, argv + ["--dir", str(tmp_path / "jax")])
    prc, pout = _run(pcli.main, argv + ["--dir", str(tmp_path / "port"),
                                        "--device", "cpu"])
    assert prc == jrc == 0 and _no_wall(pout) == _no_wall(jout) and pout
    (jrc, jout), (prc, pout) = _both_clocked(
        ["scenario", "run", "-host", "-algorithm", "epaxos", "-replicas",
         "3", "-zones", "3"])
    assert prc == jrc == 0 and pout == jout and pout[0]["ops_ok"] > 0


def test_scenario_host_of_a_sim_only_name_fails_as_reference():
    """A sim name without a host twin of its own fails in
    ``replay_schedule``'s registry lookup: the exit code and the last line
    of standard error are ``python -m paxi_tpu``'s."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    name = "wpaxos_thinq1"
    argv = ["scenario", "run", "-host", "-algorithm", name, "-replicas",
            "3", "-zones", "3", "-steps", "4"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for pkg in ("paxi_tpu", "paxi_tpu_torch"):
        r = subprocess.run([sys.executable, "-m", pkg] + argv, cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        out[pkg] = (r.returncode, r.stdout, r.stderr.strip().splitlines()[-1])
    assert out["paxi_tpu_torch"] == out["paxi_tpu"]
    assert out["paxi_tpu"] == (1, "", f"KeyError: '{name}'")
