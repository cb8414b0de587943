"""The port's record, replay and shrink (paxi_tpu_torch.trace and the
runner's record/pinned paths) against the JAX package's, exactly:

- per-group invariants of paxos, epaxos, sdpaxos, wpaxos and
  wpaxos_thinq1 on carries harvested from fuzzed runs, element for
  element against ``paxi_tpu.sim.runner.per_group_invariants``;
- ``make_recorded_run`` on paxos under drops, delays, partitions and
  crashes (8 groups x 30 steps): state, metrics, total, the (T, G)
  violations and every schedule plane; ``make_pinned_run`` with a group's
  recorded schedule equals the plain run and the reference's pinned run;
- traces across the runtimes: a forced-group paxos capture under the
  wan3z geo schedule and the smallest violating ``wpaxos_thinq1`` witness
  found (2 groups x 20 steps, seed 1) captured by each package replay in
  the other to the capture's state hash, counters and latency histogram;
  each package loads the other's ``.npz``, and the schedule hashes agree;
- ``shrink`` of that witness replays to its own hash, and (slow tier)
  equals the reference's: the same remaining events, stats and meta;
- ``state_hash``, ``to_host_snapshot`` and ``series=True`` counters.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_tree_equal, to_np  # noqa: E402
from paxi_tpu import scenarios as jscn  # noqa: E402
from paxi_tpu import trace as jtr  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import runner as jrun  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch import scenarios as pscn  # noqa: E402
from paxi_tpu_torch import trace as ptr  # noqa: E402
from paxi_tpu_torch.metrics import lathist  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, runner  # noqa: E402

PAXOS = dict(n_replicas=5, n_slots=16)
THINQ1 = dict(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
              steal_threshold=2, locality=0.3)
MIXED = dict(p_drop=0.15, max_delay=3, p_partition=0.2, p_crash=0.1,
             window=8)
# the smallest violating wpaxos_thinq1 case under the hunt's GEO3Z
# schedule found: group 1 first violates at step 14
WITNESS = dict(seed=1, n_groups=2, n_steps=20)


def _jfuzz(**kw):
    scn = kw.pop("scenario", None)
    return JFuzz(**kw, scenario=None if scn is None else jscn.NAMED[scn])


def _pfuzz(**kw):
    scn = kw.pop("scenario", None)
    return FuzzConfig(**kw,
                      scenario=None if scn is None else pscn.NAMED[scn])


# ---- per-group invariants ------------------------------------------------

PG_CASES = {
    "paxos": (PAXOS, MIXED, 8, 12),
    "epaxos": (dict(n_replicas=5, n_slots=16, n_keys=4), MIXED, 4, 12),
    "sdpaxos": (dict(n_replicas=5, n_slots=16, n_keys=8), MIXED, 4, 12),
    "wpaxos": (dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                    steal_threshold=3, locality=0.8), MIXED, 4, 12),
    # a step where group 1 violates
    "wpaxos_thinq1": (THINQ1, dict(p_drop=0.05, scenario="wan3z"), 2, 14),
}


def _harvest(name, cfg_kw, fz, g, t0, seed=1):
    """The port's carries before and after step ``t0`` of a fuzzed run
    (the port's runs equal the reference's: test_torch_*_sim.py)."""
    proto, cfg = sim_protocol(name), SimConfig(**cfg_kw)
    body = runner.make_scan_body(proto, cfg, _pfuzz(**fz))
    with torch.inference_mode():
        carry = runner.init_carry(proto, cfg, _pfuzz(**fz), g,
                                  tr.PRNGKey(seed), "cpu")
        for t in range(t0):
            carry, _ = body(carry, t)
        new, _ = body(carry, t0)
    return carry[0], new[0]


@pytest.mark.parametrize("name", PG_CASES)
def test_group_invariants_equal_the_reference(name):
    cfg_kw, fz, g, t0 = PG_CASES[name]
    old, new = _harvest(name, cfg_kw, fz, g, t0)
    proto, jproto = sim_protocol(name), jax_protocol(name)
    # the step as run, and backwards (ballots fall, commits vanish: many
    # violations, spread unevenly over the groups)
    for a, b in ((old, new), (new, old)):
        got = runner.per_group_invariants(proto, SimConfig(**cfg_kw), a, b)
        want = jrun.per_group_invariants(
            jproto, JCfg(**cfg_kw),
            {k: jnp.asarray(v.numpy()) for k, v in a.items()},
            {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        assert got.shape == (g,)
        assert_tree_equal(want, got, name)
        assert int(torch.sum(got)) == int(
            proto.invariants(a, b, SimConfig(**cfg_kw)))
    back = runner.per_group_invariants(proto, SimConfig(**cfg_kw), new, old)
    assert int(back.sum()) > 0
    if name == "wpaxos_thinq1":
        fwd = runner.per_group_invariants(proto, SimConfig(**cfg_kw), old,
                                          new)
        assert int(fwd[1]) > 0 and int(fwd[0]) == 0


# ---- record and pinned runs ----------------------------------------------

@pytest.fixture(scope="module")
def recorded():
    """(reference record, port record) of paxos under MIXED, 8 x 30."""
    j = jrun.make_recorded_run(jax_protocol("paxos"), JCfg(**PAXOS),
                               _jfuzz(**MIXED))(jr.PRNGKey(1), 8, 30)
    p = runner.make_recorded_run(sim_protocol("paxos"), SimConfig(**PAXOS),
                                 _pfuzz(**MIXED), device="cpu")(
        tr.PRNGKey(1), 8, 30)
    return to_np(j), p


@pytest.mark.parametrize("part", ["state", "metrics", "total", "viol_steps",
                                  "sched"])
def test_recorded_run_equals_the_reference(recorded, part):
    i = ["state", "metrics", "total", "viol_steps", "sched"].index(part)
    j, p = recorded
    want = dict(j[i]) if isinstance(j[i], dict) else j[i]
    assert_tree_equal(want, p[i], part)
    if part == "viol_steps":
        assert tuple(p[i].shape) == (30, 8)
    if part == "sched":
        assert int((~p[i]["conn"]).sum()) > 0
        assert int(p[i]["crashed"].sum()) > 0
        assert sum(int(f["drop"].sum()) for f in p[i]["faults"].values())


def _group_sched(sched, g):
    return {"conn": sched["conn"][..., g],
            "crashed": sched["crashed"][..., g],
            "faults": {n: {k: v[..., g] for k, v in f.items()}
                       for n, f in sched["faults"].items()}}


def test_pinned_run_equals_the_plain_run_and_the_reference(recorded):
    g = 3
    sched = _group_sched(recorded[1][4], g)
    pinned = runner.make_pinned_run(sim_protocol("paxos"),
                                    SimConfig(**PAXOS), _pfuzz(**MIXED), g,
                                    device="cpu")(tr.PRNGKey(1), 8, sched)
    plain = runner.make_run(sim_protocol("paxos"), SimConfig(**PAXOS),
                            _pfuzz(**MIXED), device="cpu")(
        tr.PRNGKey(1), 8, 30)
    assert_tree_equal(plain[0], pinned[0], "state")
    assert_tree_equal(plain[1], pinned[1], "metrics")
    assert_tree_equal(recorded[1][3][:, g], pinned[3], "viol_steps")
    want = jrun.make_pinned_run(jax_protocol("paxos"), JCfg(**PAXOS),
                                _jfuzz(**MIXED), g)(
        jr.PRNGKey(1), 8, to_np(sched))
    for i, part in enumerate(["state", "metrics", "total", "viol_steps"]):
        w = to_np(want[i])
        assert_tree_equal(dict(w) if isinstance(w, dict) else w,
                          pinned[i], part)


def test_pinned_run_leaves_the_recorded_schedule_alone(recorded):
    sched = _group_sched(recorded[1][4], 0)
    before = {k: v.clone() for k, v in sched["faults"]["p2a"].items()}
    runner.make_pinned_run(sim_protocol("paxos"), SimConfig(**PAXOS),
                           _pfuzz(**MIXED), 0, device="cpu")(
        tr.PRNGKey(1), 8, sched)
    for k, v in before.items():
        assert torch.equal(v, sched["faults"]["p2a"][k])
    with pytest.raises(ValueError, match="group 9"):
        runner.make_pinned_run(sim_protocol("paxos"), SimConfig(**PAXOS),
                               _pfuzz(**MIXED), 9, device="cpu")(
            tr.PRNGKey(1), 8, sched)


# ---- traces across the runtimes -------------------------------------------

def _norm(meta):
    return json.loads(json.dumps(meta))


def test_forced_group_geo_capture_crosses_runtimes(tmp_path):
    kw = dict(seed=2, n_groups=8, n_steps=30, group=2)
    jt = jtr.capture(jax_protocol("paxos"), JCfg(**PAXOS),
                     _jfuzz(p_drop=0.05, scenario="wan3z"), **kw)
    pt = ptr.capture(sim_protocol("paxos"), SimConfig(**PAXOS),
                     _pfuzz(p_drop=0.05, scenario="wan3z"), device="cpu",
                     **kw)
    assert _norm(pt.meta) == _norm(jt.meta)
    assert_tree_equal(to_np(jt.sched), pt.sched, "sched")
    r = ptr.replay(jt, device="cpu")
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.lat_hist == jt.meta["capture_lat_hist"]
    jr_ = jtr.replay(jt)
    np.testing.assert_array_equal(r.viol_steps, jr_.viol_steps)
    assert r.metrics == jr_.metrics
    # each package loads the other's file
    pt2 = ptr.load(jtr.save(str(tmp_path / "j"), jt))
    jt2 = jtr.load(ptr.save(str(tmp_path / "p"), pt))
    assert pt2.meta == jt2.meta and pt2.meta["schedule_hash"] == \
        jt.meta["schedule_hash"]
    assert pt2.fuzz_config().scenario == pscn.NAMED["wan3z"]


@pytest.fixture(scope="module")
def witnesses():
    """The thin-Q1 witness captured by each package."""
    jt = jtr.capture(jax_protocol("wpaxos_thinq1"), JCfg(**THINQ1),
                     _jfuzz(p_drop=0.05, scenario="wan3z"), **WITNESS)
    pt = ptr.capture(sim_protocol("wpaxos_thinq1"), SimConfig(**THINQ1),
                     _pfuzz(p_drop=0.05, scenario="wan3z"), device="cpu",
                     **WITNESS)
    return jt, pt


def test_witness_capture_equals_the_reference(witnesses):
    jt, pt = witnesses
    assert pt is not None and pt.group == 1
    assert pt.meta["first_violation_step"] == 14
    assert _norm(pt.meta) == _norm(jt.meta)
    assert_tree_equal(to_np(jt.sched), pt.sched, "sched")
    assert pt.n_events() == jt.n_events()
    assert ptr.list_events(pt.sched) == jtr.list_events(jt.sched)


def test_reference_witness_replays_in_the_port(witnesses):
    jt, _ = witnesses
    r = ptr.check_determinism(jt, device="cpu")
    assert r.violations == jt.meta["group_violations"] > 0
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.lat_hist == jt.meta.get("capture_lat_hist")
    assert r.first_violation_step() == jt.meta["first_violation_step"]


def test_port_witness_replays_in_the_reference(witnesses, tmp_path):
    _, pt = witnesses
    jt2 = jtr.load(ptr.save(str(tmp_path / "w"), pt))
    assert jt2.meta["schedule_hash"] == pt.meta["schedule_hash"]
    assert jt2.fuzz_config().scenario == jscn.NAMED["wan3z"]
    r = jtr.replay(jt2)
    assert r.violations == pt.meta["group_violations"]
    assert r.state_hash == pt.meta["capture_state_hash"]
    assert r.counters == pt.meta["capture_counters"]
    assert r.lat_hist == pt.meta.get("capture_lat_hist")
    # and the port's own load replays the same
    r2 = ptr.replay(ptr.load(str(tmp_path / "w")), device="cpu")
    assert r2.state_hash == pt.meta["capture_state_hash"]
    np.testing.assert_array_equal(r.viol_steps, r2.viol_steps)


@pytest.mark.slow
def test_shrink_equals_the_reference(witnesses):
    """The reference's shrink and the port's, 40 trials each as the hunt
    runs them (slow tier: the reference's replays recompile per schedule
    length)."""
    jt, pt = witnesses
    jmin, jstats = jtr.shrink(jt, max_trials=40)
    pmin, pstats = ptr.shrink(pt, max_trials=40, device="cpu")
    assert pstats == jstats
    assert ptr.list_events(pmin.sched) == jtr.list_events(jmin.sched)
    assert _norm(pmin.meta) == _norm(jmin.meta)


def test_port_shrink_of_the_witness(witnesses):
    _, pt = witnesses
    pmin, stats = ptr.shrink(pt, max_trials=20, device="cpu")
    assert stats["violations"] > 0 and stats["replays"] == 20
    assert stats["events_after"] < stats["events_before"] == pt.n_events()
    assert stats["steps_after"] <= stats["steps_before"] == 20
    assert pmin.meta["shrunk"] is True
    assert pmin.meta["schedule_hash"] != pt.meta["schedule_hash"]
    r = ptr.replay(pmin, device="cpu")
    assert r.violations == pmin.meta["group_violations"] > 0
    assert r.state_hash == pmin.meta["replay_state_hash"]
    assert r.counters == pmin.meta["replay_counters"]


def test_no_violation_no_trace_and_sharded_replay_raises(witnesses):
    fz = _pfuzz(p_drop=0.05, scenario="wan3z")
    assert ptr.capture(sim_protocol("wpaxos"), SimConfig(**THINQ1), fz,
                       device="cpu", **WITNESS) is None
    with pytest.raises(NotImplementedError, match="item 12"):
        ptr.replay(witnesses[1], mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="nothing to shrink"):
        ptr.shrink(witnesses[1].with_sched(ptr.neutralize(
            witnesses[1].sched, ptr.list_events(witnesses[1].sched))),
            max_trials=2, device="cpu")


# ---- hashes, snapshots and series -----------------------------------------

def test_state_hash_equals_the_reference():
    rng = np.random.default_rng(0)
    state = {"log": rng.integers(0, 9, (3, 4)).astype(np.int32),
             "ok": rng.integers(0, 2, 5).astype(bool),
             "nest": {"b": np.arange(3, dtype=np.int32),
                      "a": np.ones(2, np.int32)},
             "m_lat": np.full(3, 7, np.int32)}
    assert ptr.state_hash(state) == jtr.state_hash(state)
    tens = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
                {a: torch.from_numpy(b) for a, b in v.items()})
            for k, v in state.items()}
    assert ptr.state_hash(tens) == jtr.state_hash(state)
    assert ptr.state_hash(state) == ptr.state_hash(
        {k: v for k, v in state.items() if k != "m_lat"})


def test_snapshot_and_series_equal_the_reference():
    from paxi_tpu.sim import simulate as jax_simulate
    from paxi_tpu_torch.sim import simulate
    j = jax_simulate(jax_protocol("paxos"), JCfg(**PAXOS), 8, 24,
                     _jfuzz(**MIXED), seed=4, series=True)
    p = simulate(sim_protocol("paxos"), SimConfig(**PAXOS), 8, 24,
                 _pfuzz(**MIXED), seed=4, device="cpu", series=True)
    assert sorted(p.counter_series) == sorted(j.counter_series)
    assert_tree_equal(to_np(dict(j.counter_series)), p.counter_series,
                      "series")
    for k, v in p.counter_series.items():
        assert int(v.sum()) == int(p.counters[k])
    assert p.latency_snapshot(0.05, zone="a") == \
        j.latency_snapshot(0.05, zone="a")
    hist = p.latency_hist
    from paxi_tpu.metrics import lathist as jlathist
    assert lathist.to_host_snapshot(hist, 123, 0.5) == \
        jlathist.to_host_snapshot(hist, 123, 0.5)
    with pytest.raises(ValueError):
        lathist.to_host_snapshot(np.zeros(3, np.int32), 0)
