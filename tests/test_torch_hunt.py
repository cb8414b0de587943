"""The port's hunt subsystem against the JAX package's, exactly.

The case tables (every cfg and fuzz by ``dataclasses.asdict``) and
``sched_name``; the host data the port copies (every host module's
``TRACE_MSG_MAP``, the sim -> host registry, the local config's replica
ids in numeric order); ``seq_schedule``, ``coverage_of`` and ``classify``
on hand-built fixture traces and on a JAX capture; the corpus (dedup,
retroactive hashing, corpora crossing both ways); and whole campaigns with
host replay off: a ``fragile_counter`` micro-campaign's ``state.json``,
``HUNT_REPORT.json`` and corpus index equal to JAX's apart from
``wall_s`` (and a resume that redoes nothing), and a ``switchpaxos_nogap``
campaign to the same witness hashes.
"""

import dataclasses
import importlib
import json
import shutil

import numpy as np
import pytest

pytest.importorskip("jax")

from paxi_tpu_torch import hunt as P  # noqa: E402
from paxi_tpu_torch.hunt import cases as pc  # noqa: E402
from paxi_tpu_torch.trace import format as pfmt  # noqa: E402
from paxi_tpu_torch.trace import host as phost  # noqa: E402


def _case_rows(cases):
    return [(n, dataclasses.asdict(cfg), [dataclasses.asdict(f) for f in s],
             g, t, k) for n, cfg, s, g, t, k in cases]


def _no_wall(x):
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


def _read(root, name):
    with open(root / name) as f:
        return json.load(f)


# ---- the case tables ----------------------------------------------------
def test_case_tables_equal_reference():
    from paxi_tpu.hunt import cases as jc
    assert _case_rows(pc.CASES) == _case_rows(jc.CASES)
    assert _case_rows(pc.DEMO_CASES) == _case_rows(jc.DEMO_CASES)
    assert _case_rows([pc.BUG_DEMO]) == _case_rows([jc.BUG_DEMO])
    assert pc.SEEDS == jc.SEEDS
    for name in ("DROP", "DUP", "PART", "KILL", "GEO3Z", "GEO2Z",
                 "GEO_CHURN"):
        assert dataclasses.asdict(getattr(pc, name)) \
            == dataclasses.asdict(getattr(jc, name)), name
    pairs = [(f, g) for a, b in zip(pc.CASES + pc.DEMO_CASES,
                                    jc.CASES + jc.DEMO_CASES)
             for f, g in zip(a[2], b[2])]
    assert [pc.sched_name(f) for f, _ in pairs] \
        == [jc.sched_name(g) for _, g in pairs]
    # the counts the soak and the hunt rely on
    assert sum(len(c[2]) for c in pc.CASES) == 51
    assert sum(len(c[2]) for c in pc.CASES) * len(pc.SEEDS) == 255
    assert sorted({pc.sched_name(f) for c in pc.CASES + pc.DEMO_CASES
                   for f in c[2]}) == [
        "churn", "drop", "dup", "partition", "perm_kill", "wan2z+drop",
        "wan3z+drop", "wan3z_churn"]
    fz = pc.FuzzConfig(max_delay=3)
    assert pc.sched_name(fz) == jc.sched_name(jc.FuzzConfig(max_delay=3)) \
        == "delay"


@pytest.mark.parametrize("protocols,quick", [
    (None, False), (None, True), (["switchpaxos", "switchpaxos_nogap"], True),
    (["wpaxos", "fragile_counter"], False)])
def test_hunt_cases_equal_reference(protocols, quick):
    from paxi_tpu.hunt import cases as jc
    a = pc.hunt_cases(protocols, quick=quick)
    b = jc.hunt_cases(protocols, quick=quick)
    assert sorted(a) == sorted(b)
    for p in a:
        assert _case_rows(a[p]) == _case_rows(b[p]), p


# ---- the host data the port copies ----------------------------------------
def test_trace_msg_maps_equal_host_modules():
    """Every map comes from its twin, as in the JAX package."""
    from paxi_tpu.protocols import _HOST_MODULES
    from paxi_tpu_torch.protocols import _HOST_MODULES as PHOST
    assert sorted(PHOST) == sorted(_HOST_MODULES)
    for name, module in _HOST_MODULES.items():
        want = dict(importlib.import_module(module).TRACE_MSG_MAP)
        assert phost.trace_msg_map(name) == want, name
        assert phost.trace_msg_map(name) == dict(
            importlib.import_module(PHOST[name]).TRACE_MSG_MAP), name


def test_host_algorithm_and_maps_for_every_sim_name():
    from paxi_tpu.protocols import _SIM_MODULES as JSIM
    from paxi_tpu.trace import host as jhost
    from paxi_tpu_torch.protocols import _SIM_MODULES as PSIM
    assert sorted(PSIM) == sorted(JSIM)
    for name in sorted(JSIM) + ["nope"]:
        assert phost.host_algorithm(name) == jhost.host_algorithm(name), \
            name
        assert phost.trace_msg_map(name) == jhost.trace_msg_map(name), name


@pytest.mark.parametrize("n,zones", [(3, 1), (5, 1), (6, 2), (7, 1),
                                     (9, 3), (12, 1), (22, 2)])
def test_local_ids_equal_local_config(n, zones):
    from paxi_tpu.core.config import local_config
    want = [str(i) for i in local_config(n, zones=zones).ids]
    assert phost.local_ids(n, zones) == want
    # numeric (zone, node) order, not lexical
    shuffled = list(reversed(want))
    assert sorted(shuffled, key=phost.id_order) == want


# ---- projection, coverage, classification ----------------------------------
def fixture_trace(pkg, faults=(), violations=1, n_steps=6, mailbox="seq"):
    """tests/test_hunt.py's hand-built single-group fragile_counter trace,
    in package ``pkg`` ("jax" or "torch").  ``faults``: (kind, t, i, j)
    with kind in drop/dup/delay; crashes as ("crash", t, i, 0) and cuts
    as ("cut", t, i, j)."""
    if pkg == "jax":
        from paxi_tpu.sim import FuzzConfig, SimConfig
        from paxi_tpu.trace.format import Trace, make_meta
    else:
        from paxi_tpu_torch.sim import FuzzConfig, SimConfig
        from paxi_tpu_torch.trace.format import Trace, make_meta
    R, T = 3, n_steps
    sched = {"conn": np.ones((T, R, R), bool),
             "crashed": np.zeros((T, R), bool),
             "faults": {mailbox: {
                 "drop": np.zeros((T, R, R), bool),
                 "delay": np.ones((T, R, R), np.int32),
                 "dup": np.zeros((T, R, R), bool)}}}
    for kind, t, i, j in faults:
        if kind == "delay":
            sched["faults"][mailbox]["delay"][t, i, j] = 2
        elif kind == "crash":
            sched["crashed"][t, i] = True
        elif kind == "cut":
            sched["conn"][t, i, j] = False
        else:
            sched["faults"][mailbox][kind][t, i, j] = True
    return Trace(meta=make_meta("fragile_counter", SimConfig(n_replicas=3),
                                FuzzConfig(p_drop=0.2, max_delay=2), 0, 1,
                                0, group_violations=violations),
                 sched=sched)


FIXTURES = {
    "drop": dict(faults=[("drop", 1, 0, 2)]),
    "unmapped": dict(faults=[("drop", 1, 0, 2)], mailbox="p2b"),
    "dup": dict(faults=[("dup", 1, 0, 2)]),
    "lone_delay": dict(faults=[("delay", 2, 1, 0), ("delay", 3, 1, 0)]),
    "mixed": dict(faults=[("drop", 0, 2, 1), ("delay", 4, 0, 1),
                          ("crash", 2, 1, 0), ("cut", 3, 0, 2),
                          ("drop", 5, 2, 1)]),
}


def _outcomes():
    from paxi_tpu.hunt.classify import HostOutcome as JH
    return [(None, None), (JH(oracle_violations=2),
                           P.HostOutcome(oracle_violations=2)),
            (JH(ops_ok=5), P.HostOutcome(ops_ok=5)),
            (JH(anomalies=1, ops_failed=3),
             P.HostOutcome(anomalies=1, ops_failed=3))]


def _verdict(classify, viol, cov, host):
    try:
        return classify(viol, cov, host).to_json()
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_coverage_and_classify_on_fixtures(fixture):
    from paxi_tpu.hunt import classify as jclassify
    from paxi_tpu.hunt import coverage_of as jcov
    from paxi_tpu.trace.host import seq_schedule as jseq
    kw = FIXTURES[fixture]
    jt, pt = fixture_trace("jax", **kw), fixture_trace("torch", **kw)
    ids = ["1.1", "1.2", "1.3"]
    assert phost.seq_schedule(pt, ids)[0].to_json() \
        == jseq(jt, ids)[0].to_json()
    assert phost.seq_schedule(pt, ids)[1] == jseq(jt, ids)[1]
    a, b = jcov(jt), P.coverage_of(pt)
    assert a == b
    for collisions in (None, 0, 3):
        cov_a, cov_b = dict(a, delay_collisions=collisions), \
            dict(b, delay_collisions=collisions)
        for jh, ph in _outcomes():
            assert _verdict(P.classify, 1, cov_b, ph) \
                == _verdict(jclassify, 1, cov_a, jh)


def test_classify_witness_without_host():
    from paxi_tpu.hunt import classify_witness as jcw
    for name, kw in FIXTURES.items():
        jt, pt = fixture_trace("jax", **kw), fixture_trace("torch", **kw)
        assert P.classify_witness(pt, host_replay=False).to_json() \
            == jcw(jt, host_replay=False).to_json(), name
    # with host replay (the default, as in the JAX package) the verdicts
    # are the JAX package's too: the unmappable witnesses need no host,
    # a mappable one replays on both host runtimes
    assert P.classify_witness(fixture_trace("torch", **FIXTURES["dup"]),
                              host_replay=True).outcome == "unmappable"
    for name, kw in FIXTURES.items():
        assert P.classify_witness(fixture_trace("torch", **kw)).to_json() \
            == jcw(fixture_trace("jax", **kw)).to_json(), name


@pytest.fixture(scope="module")
def jax_witness(tmp_path_factory):
    """A fragile_counter witness captured (and shrunk) by the JAX package,
    saved as files."""
    from paxi_tpu import trace as jtr
    from paxi_tpu.hunt import cases as jc
    from paxi_tpu.protocols import sim_protocol
    name, cfg, scheds, groups, steps, _ = jc.DEMO_CASES[0]
    t = jtr.capture(sim_protocol(name), cfg, scheds[0], 0, groups, steps,
                    proto_name=name)
    mini, _ = jtr.shrink(t, max_trials=12)
    d = tmp_path_factory.mktemp("jax_traces")
    return (jtr.save(str(d / "capture"), t), jtr.save(str(d / "mini"), mini))


def test_coverage_of_jax_capture(jax_witness):
    from paxi_tpu import trace as jtr
    from paxi_tpu.hunt import classify_witness as jcw
    from paxi_tpu.hunt import coverage_of as jcov
    from paxi_tpu.trace.host import seq_schedule as jseq
    for path in jax_witness:
        jt, pt = jtr.load(path), pfmt.load(path)
        assert P.coverage_of(pt) == jcov(jt)
        ids = phost.local_ids(3)
        assert phost.seq_schedule(pt, ids)[0].to_json() \
            == jseq(jt, ids)[0].to_json()
        assert P.classify_witness(pt, host_replay=False).to_json() \
            == jcw(jt, host_replay=False).to_json()


# ---- the corpus ------------------------------------------------------------
def test_corpus_dedup_retroactive_and_crossing(jax_witness, tmp_path):
    from paxi_tpu import trace as jtr
    from paxi_tpu.hunt import Corpus as JCorpus
    cap, mini = jax_witness
    t = pfmt.load(cap)
    c = P.Corpus(tmp_path / "port")
    h, new = c.add(t, origin="a")
    assert new and h == t.meta["schedule_hash"] and len(c) == 1
    assert c.add(t, origin="b") == (h, False) and len(c) == 1
    assert h in c and c.load(h).meta["schedule_hash"] == h
    with pytest.raises(KeyError):
        c.load("0" * 64)
    # retroactive hashing: traces whose meta predates the stamp
    seeds = tmp_path / "seeds"
    seeds.mkdir()
    for p in (cap, mini):
        jt = jtr.load(p)
        jt.meta.pop("schedule_hash", None)
        jtr.save(str(seeds / p.rsplit("/", 1)[1]), jt)
    (seeds / "junk.npz").write_bytes(b"not a trace")
    jc_, pc_ = JCorpus(tmp_path / "jseed"), P.Corpus(tmp_path / "pseed")
    assert pc_.seed_from(seeds) == jc_.seed_from(seeds) == (2, 1)
    assert pc_.index == jc_.index
    assert h in pc_
    # a JAX-written corpus loads in the port to the same index, and back
    shutil.copytree(tmp_path / "jseed", tmp_path / "jcopy")
    assert P.Corpus(tmp_path / "jcopy").index == jc_.index
    assert JCorpus(tmp_path / "pseed").index == pc_.index
    for k in pc_.index:
        assert JCorpus(tmp_path / "pseed").load(k).meta["schedule_hash"] \
            == P.Corpus(tmp_path / "jcopy").load(k).meta["schedule_hash"]


# ---- whole campaigns ---------------------------------------------------------
def _campaigns(tmp_path, protocol, budget, shrink_trials, seeds_dir=None):
    from paxi_tpu.hunt import Campaign as JCampaign
    kw = dict(protocols=[protocol], budget=budget, quick=True,
              shrink_trials=shrink_trials, log=lambda m: None,
              traces_dir=str(seeds_dir or tmp_path / "no_traces"))
    j = JCampaign(tmp_path / "jax", host_replay=False, **kw)
    p = P.Campaign(tmp_path / "port", host_replay=False, device="cpu", **kw)
    return j, p


def _assert_same_campaign(tmp_path):
    for name in ("state.json", "HUNT_REPORT.json", "corpus/index.json"):
        assert _no_wall(_read(tmp_path / "port", name)) \
            == _no_wall(_read(tmp_path / "jax", name)), name


def test_fragile_counter_campaign_equals_reference(tmp_path):
    j, p = _campaigns(tmp_path, "fragile_counter", 1, 40)
    rj, rp = j.run(), p.run()
    assert _no_wall(rp) == _no_wall(rj)
    _assert_same_campaign(tmp_path)
    s = rp["summary"]["totals"]
    assert s["runs"] == 1 and s["witnesses"] == 1 \
        and s["unclassified"] == 0 and s["unmappable"] == 1
    assert p.status() == j.status()
    # resume: the same budget redoes nothing
    before = _read(tmp_path / "port", "state.json")
    again = P.Campaign(tmp_path / "port", protocols=["fragile_counter"],
                       budget=1, quick=True, shrink_trials=40,
                       log=lambda m: None, device="cpu",
                       traces_dir=str(tmp_path / "no_traces"))
    again.run()
    assert _read(tmp_path / "port", "state.json") == before
    # a raised budget extends the seed stream, as the reference's does
    j2, p2 = _campaigns(tmp_path, "fragile_counter", 2, 40)
    j2.run()
    p2.run()
    _assert_same_campaign(tmp_path)
    assert len(_read(tmp_path / "port", "state.json")["runs"]) == 2


def test_nogap_campaign_equals_reference(tmp_path):
    j, p = _campaigns(tmp_path, "switchpaxos_nogap", 1, 8)
    j.run()
    p.run()
    _assert_same_campaign(tmp_path)
    st = _read(tmp_path / "port", "state.json")
    assert st["runs"][0]["violations"] > 0
    (w,) = st["witnesses"].values()
    assert w["events_after"] <= w["events_before"]
    assert sorted(_read(tmp_path / "port", "corpus/index.json")) \
        == sorted(_read(tmp_path / "jax", "corpus/index.json"))


def test_campaign_classifies_a_seeded_backlog(jax_witness, tmp_path):
    seeds = tmp_path / "seeds"
    seeds.mkdir()
    for p in jax_witness:
        shutil.copy(p, seeds)
    j, p = _campaigns(tmp_path, "fragile_counter", 0, 40, seeds_dir=seeds)
    j.run()
    p.run()
    _assert_same_campaign(tmp_path)
    st = _read(tmp_path / "port", "state.json")
    assert len(st["witnesses"]) == 2 and st["runs"] == []


def test_campaign_refusals(tmp_path):
    with pytest.raises(KeyError, match="no hunt cases"):
        P.Campaign(tmp_path / "a", protocols=["nope"], device="cpu")
    # host replay on: every protocol replays on a host twin, the default
    # campaign's included, with the JAX package's case lists
    from paxi_tpu.hunt import Campaign as JCampaign
    for i, protocols in enumerate((["wankeeper_nofloor"], None)):
        c = P.Campaign(tmp_path / f"b{i}", protocols=protocols,
                       host_replay=True, device="cpu")
        j = JCampaign(tmp_path / f"j{i}", protocols=protocols,
                      host_replay=True)
        assert c.host_replay and sorted(c.cases) == sorted(j.cases)
    assert len(c.cases) == 13
    with pytest.raises(ValueError, match="v7"):
        (tmp_path / "c").mkdir()
        (tmp_path / "c" / "state.json").write_text('{"version": 7}')
        P.Campaign(tmp_path / "c", protocols=["fragile_counter"],
                   device="cpu")


def test_invariant_terms_of_a_nogap_witness(tmp_path, monkeypatch, capsys):
    """scripts/torch_invariant_terms.py splits a switchpaxos_nogap
    witness's violations over the oracle's terms, and they sum to the
    recorded violations."""
    import importlib.util
    import sys
    from pathlib import Path

    from paxi_tpu_torch import trace as T
    from paxi_tpu_torch.protocols import sim_protocol
    path = Path(__file__).resolve().parents[1] / "scripts" \
        / "torch_invariant_terms.py"
    spec = importlib.util.spec_from_file_location("invariant_terms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    name, cfg, scheds, groups, steps, _ = pc.hunt_cases(
        ["switchpaxos_nogap"], quick=True)["switchpaxos_nogap"][0]
    t = T.capture(sim_protocol(name), cfg, scheds[0], 0, groups, 40,
                  proto_name=name, device="cpu")
    f = T.save(str(tmp_path / "w"), t)
    monkeypatch.setattr(sys, "argv", ["x", f, "--device", "cpu"])
    assert mod.main() == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[-1]["violations"] == lines[-1]["recorded_violations"] \
        == t.meta["group_violations"] > 0
    assert sum(lines[-1]["terms"].values()) == lines[-1]["violations"]
    assert lines[0]["step"] == t.meta["first_violation_step"]
