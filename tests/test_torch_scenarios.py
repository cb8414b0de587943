"""The port's scenario engine (paxi_tpu_torch.scenarios) against the JAX
package's, exactly: the spec's fields, ``asdict``/``from_dict`` round trip
and ``validate`` errors; the compiled planes (``forced_crash`` over 200
steps and ``delay_base``) for every named scenario at 3, 5 and 9
replicas; and whole scenario runs — paxos and wpaxos under five named
scenarios, epaxos under one geo and one churn scenario — bit for bit
against ``paxi_tpu.sim.make_run`` on the same seed (state, metrics,
violations, in-scan violations)."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_tree_equal, to_np  # noqa: E402
from paxi_tpu import scenarios as jscn  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.scenarios import schedule as jsched  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import make_run as jax_make_run  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch import scenarios as pscn  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.scenarios import schedule as psched  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run  # noqa: E402

NAMES = sorted(jscn.NAMED)
HORIZON = 200


def _rich(m):
    return m.Scenario(
        name="rich", n_zones=3,
        zones=m.ZoneLatency(matrix=((1, 2, 3), (2, 1, 2), (3, 2, 1)),
                            jitter=2),
        churn=m.LeaderChurn(start=4, period=20, kill_for=8, first=1,
                            stride=2),
        reconfig=m.Reconfig(epochs=((0, (0, 1, 2)), (30, (0, 1)))),
        outages=(m.ZoneOutage(zone=1, t0=10, t1=20),),
        switch=m.SwitchChurn(start=3, period=9, down_for=4))


def test_catalog_and_fields_equal_the_reference():
    assert sorted(pscn.NAMED) == NAMES
    for name in NAMES:
        j, p = jscn.NAMED[name], pscn.NAMED[name]
        assert dataclasses.asdict(j) == dataclasses.asdict(p), name
        assert j.max_latency() == p.max_latency()
        assert j.kills_nodes() == p.kills_nodes()
        assert jscn.describe(j) == pscn.describe(p)
    assert dataclasses.asdict(_rich(jscn)) == dataclasses.asdict(
        _rich(pscn))
    assert pscn.named_scenario("wan3z") is pscn.NAMED["wan3z"]
    with pytest.raises(KeyError):
        pscn.named_scenario("nope")


@pytest.mark.parametrize("name", NAMES + ["rich"])
def test_from_dict_round_trip(name):
    s = _rich(pscn) if name == "rich" else pscn.NAMED[name]
    d = json.loads(json.dumps(dataclasses.asdict(s)))
    assert pscn.Scenario.from_dict(d) == s
    assert hash(pscn.Scenario.from_dict(d)) == hash(s)
    # each package rebuilds the other's meta to the same fields
    assert dataclasses.asdict(jscn.Scenario.from_dict(d)) == \
        dataclasses.asdict(pscn.Scenario.from_dict(d))


def _bad_specs(m):
    return [
        (m.Scenario(n_zones=2, zones=m.ZoneLatency(matrix=((1,),))), 4),
        (m.Scenario(n_zones=2, zones=m.ZoneLatency(matrix=((1, 0),
                                                           (2, 1)))), 4),
        (m.Scenario(n_zones=2, zones=m.ZoneLatency(
            matrix=((1, 2), (2, 1)), jitter=-1)), 4),
        (m.Scenario(n_zones=0), 3),
        (m.Scenario(n_zones=5), 3),
        (m.Scenario(reconfig=m.Reconfig(epochs=((10, (0, 1)),
                                                (10, (0,))))), 3),
        (m.Scenario(reconfig=m.Reconfig(epochs=((0, (0, 3)),))), 3),
        (m.Scenario(n_zones=2, outages=(m.ZoneOutage(zone=2, t0=0,
                                                     t1=5),)), 4),
        (m.Scenario(n_zones=2, outages=(m.ZoneOutage(zone=1, t0=5,
                                                     t1=2),)), 4),
        (m.Scenario(churn=m.LeaderChurn(period=10, kill_for=20)), 3),
        (m.Scenario(churn=m.LeaderChurn(period=0)), 3),
        (m.Scenario(switch=m.SwitchChurn(start=-1)), 3),
        (m.Scenario(switch=m.SwitchChurn(period=4, down_for=8)), 3),
    ]


@pytest.mark.parametrize("i", range(13))
def test_validate_raises_the_reference_error(i):
    (js, n), (ps, _) = _bad_specs(jscn)[i], _bad_specs(pscn)[i]
    with pytest.raises(ValueError) as want:
        js.validate(n)
    with pytest.raises(ValueError) as got:
        ps.validate(n)
    assert str(got.value) == str(want.value)


def test_valid_specs_validate():
    for name in NAMES:
        assert pscn.NAMED[name].validate(9) is pscn.NAMED[name]
    assert pscn.zone_of(9, 3) == jscn.zone_of(9, 3)
    assert pscn.zone_of(7, 2) == jscn.zone_of(7, 2)


@pytest.mark.parametrize("n", [3, 5, 9])
@pytest.mark.parametrize("name", NAMES)
def test_planes_equal_the_reference(name, n):
    j, p = jscn.NAMED[name], pscn.NAMED[name]
    assert_tree_equal(jsched.delay_base(j, n), psched.delay_base(p, n),
                      "delay_base")
    want = jsched.crashed_plane(j, n, HORIZON)
    assert_tree_equal(want, psched.crashed_plane(p, n, HORIZON),
                      "crashed_plane")
    # the torch overlay at every step, and at t = -1 (the refresh asks
    # for the step before step 0), against jnp's floor arithmetic
    for t in range(-1, HORIZON):
        got = psched.forced_crash(p, t, n, "cpu")
        assert got.dtype == torch.bool
        assert_tree_equal(np.asarray(jsched.forced_crash(j, jnp.int32(t),
                                                         n)), got, str(t))


def test_switch_schedule_equals_the_reference():
    for args in ((10, 0, 8), (20, 40, 12), (-1, 5, 2), (3, 9, 4)):
        for t in range(-2, 120):
            assert psched.switch_down_at(*args, t) == \
                jsched.switch_down_at(*args, t)
            assert psched.switch_session_at(*args, t) == \
                jsched.switch_session_at(*args, t)


def test_latency_split_and_apply_switch():
    m = {"commit_lat_local_n": 4, "commit_lat_local_sum": 9,
         "commit_lat_cross_n": 3, "commit_lat_cross_sum": 20}
    assert pscn.latency_split(m) == jscn.latency_split(m)
    cfg = pscn.apply_switch(SimConfig(), pscn.NAMED["seqchurn"])
    assert (cfg.sw_down_start, cfg.sw_down_period, cfg.sw_down_for) == \
        (20, 40, 12)
    assert pscn.apply_switch(SimConfig(), pscn.NAMED["wan3z"]) == \
        SimConfig()


def test_wheel_sized_to_the_scenario():
    geo = pscn.with_scenario(FuzzConfig(), pscn.NAMED["wan3z"])
    assert geo.wheel == 6 and geo.faulty
    assert pscn.with_scenario(FuzzConfig(max_delay=8),
                              pscn.NAMED["wan3z"]).wheel == 8


# ---- whole runs under a scenario, against the reference ------------------

PAXOS = dict(n_replicas=5, n_slots=16)
WPAXOS = dict(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
              steal_threshold=2, locality=0.3)
EPAXOS = dict(n_replicas=5, n_slots=16, n_keys=4)
RUN_SCENARIOS = ("wan3z", "churn", "wan3z_churn", "zoneflap",
                 "shrink_grow5")
RUNS = {f"paxos_{s}": ("paxos", PAXOS, s, 8) for s in RUN_SCENARIOS}
RUNS.update({f"wpaxos_{s}": ("wpaxos", WPAXOS, s, 4)
             for s in RUN_SCENARIOS})
RUNS.update({f"epaxos_{s}": ("epaxos", EPAXOS, s, 4)
             for s in ("wan3z", "churn")})
STEPS, SEED = 40, 3


def _run_pair(name, cfg, scn, g):
    jfz = JFuzz(p_drop=0.05, scenario=jscn.NAMED[scn])
    pfz = FuzzConfig(p_drop=0.05, scenario=pscn.NAMED[scn])
    j = jax_make_run(jax_protocol(name), JCfg(**cfg), jfz)(
        jr.PRNGKey(SEED), g, STEPS)
    p = make_run(sim_protocol(name), SimConfig(**cfg), pfz, device="cpu")(
        tr.PRNGKey(SEED), g, STEPS)
    return to_np(j), p


@pytest.mark.parametrize("run", RUNS)
def test_scenario_run_equals_the_reference(run):
    name, cfg, scn, g = RUNS[run]
    (js, jm, jv), (ps, pm, pv) = _run_pair(name, cfg, scn, g)
    assert_tree_equal(dict(js), ps, "state")
    assert_tree_equal(dict(jm), pm, "metrics")
    assert_tree_equal(jv, pv, "violations")
    assert int(pv) == 0 and int(pm["inscan_violations"]) == 0
    assert int(pm["committed_slots"]) > 0
    s = pscn.NAMED[scn]
    if s.zones is not None:
        assert int(pm["net_msgs_delayed"]) > 0
    if s.churn is not None or s.outages:
        assert int(pm["net_crash_steps"]) > 0
