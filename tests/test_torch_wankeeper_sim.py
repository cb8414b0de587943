"""The port's lane-major WanKeeper run (paxi_tpu_torch make_run on the CPU)
against paxi_tpu.sim.make_run on the same seed, bit for bit — every state
plane, every metric including the zone-latency split and the net_*
counters, the violations, the in-scan violations and the root log's
latency histogram — at bench_all.py's ``wankeeper_zones`` configuration
fault-free and under the hunt's DROP, DUP, PART and KILL schedules (KILL
takes the first root down for good at step 25: root failover), at its
9-replica ``wankeeper_wan3z_geo`` configuration under GEO3Z, and the
seeded ``wankeeper_nofloor`` twin at the hunt's BUG_DEMO shape.  Also the
per-group invariants, one step from a converted mid-run JAX carry, the
twin's witness captured by each package, and a JAX capture of the twin
replayed in the port to its capture's hash and counters."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import (assert_group_invariants_equal,  # noqa: E402
                           assert_one_step_from_mid_run_carry,
                           assert_tree_equal, capture_pair, run_pair)
from paxi_tpu_torch.metrics.simcount import COUNTER_NAMES  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402

G, T, SEED = 8, 40, 5
ZONES = dict(n_replicas=6, n_zones=2, n_objects=4, n_slots=16, locality=0.8)
GEO = dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16, locality=0.8)
# the hunt's seeded-bug demo (paxi_tpu/hunt/cases.py BUG_DEMO)
NOFLOOR = dict(n_replicas=6, n_zones=2, n_objects=2, n_slots=16,
               locality=0.1)
DROP = dict(p_drop=0.25, max_delay=2)
DUP = dict(p_dup=0.25, max_delay=3)
PART = dict(p_partition=0.3, p_crash=0.15, max_delay=2, window=8)
KILL = dict(p_drop=0.1, max_delay=2, perm_crash=0, perm_crash_at=25)
GEO3Z = dict(p_drop=0.05, scenario="wan3z")
# (protocol, config, schedule, groups, steps)
RUNS = {
    "fault_free": ("wankeeper", ZONES, {}, G, T),
    "drop": ("wankeeper", ZONES, DROP, G, T),
    "dup": ("wankeeper", ZONES, DUP, G, T),
    "part": ("wankeeper", ZONES, PART, G, T),
    "kill": ("wankeeper", ZONES, KILL, G, T),
    "geo3z": ("wankeeper", GEO, GEO3Z, G, T),
    "nofloor_drop": ("wankeeper_nofloor", NOFLOOR, DROP, 16, 80),
}
STATE_PLANES = tuple(sim_protocol("wankeeper").init_state(
    SimConfig(**ZONES), None, 1, device="cpu"))
METRICS = ("committed_slots", "transfers", "root_execute", "has_root",
           "commit_lat_local_sum", "commit_lat_local_n",
           "commit_lat_cross_sum", "commit_lat_cross_n", "commit_lat_sum",
           "commit_lat_n", "inscan_violations") \
    + tuple("net_" + c for c in COUNTER_NAMES)


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    return {name: run_pair(proto, cfg, fz, g, t, SEED)
            for name, (proto, cfg, fz, g, t) in RUNS.items()}


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("plane", STATE_PLANES)
def test_state_plane(runs, run, plane):
    j, p = runs[run]
    assert sorted(j.state) == sorted(p.state)
    assert_tree_equal(j.state[plane], p.state[plane], plane)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("metric", METRICS)
def test_metric(runs, run, metric):
    j, p = runs[run]
    assert sorted(j.metrics) == sorted(p.metrics)
    assert_tree_equal(j.metrics[metric], p.metrics[metric], metric)


@pytest.mark.parametrize("run", RUNS)
def test_violations_inscan_and_latency(runs, run):
    j, p = runs[run]
    assert_tree_equal(j.violations, p.violations, "violations")
    assert j.inscan_violations == p.inscan_violations
    assert_tree_equal(j.latency_hist, p.latency_hist, "latency_hist")
    assert j.latency_summary() == p.latency_summary()
    if run.startswith("nofloor"):
        assert int(p.violations) > 0
    else:
        assert int(p.violations) == 0 and p.inscan_violations == 0


def test_runs_write_transfer_and_split_latency(runs):
    """Every run writes; the zones move tokens; the geo run's split
    latency equals the reference's; KILL's root fails over."""
    from paxi_tpu.scenarios import latency_split as jsplit
    from paxi_tpu_torch.scenarios import latency_split
    for name in RUNS:
        assert int(runs[name][1].metrics["committed_slots"]) > 0, name
    m = runs["fault_free"][1].metrics
    assert int(m["transfers"]) > 0 and int(m["commit_lat_cross_n"]) > 0
    j, p = runs["geo3z"]
    split = latency_split({k: int(v) for k, v in p.metrics.items()})
    assert split == jsplit({k: int(v) for k, v in j.metrics.items()})
    assert split["commit_lat_local_n"] > 0 \
        and split["commit_lat_cross_n"] > 0
    kill = runs["kill"][1]
    assert int(kill.metrics["has_root"]) > 0
    assert int(torch.sum(kill.state["ballot"] % 64 != 0)) > 0


@pytest.mark.parametrize("name, cfg, fz", [
    ("wankeeper", ZONES, PART), ("wankeeper", GEO, GEO3Z),
    ("wankeeper_nofloor", NOFLOOR, DROP)])
def test_group_invariants_equal_the_reference(name, cfg, fz):
    assert_group_invariants_equal(name, cfg, fz, 4, 16)


def test_one_step_from_mid_run_carry():
    """Step 30 of a KILL run (the root failed over at step 25)."""
    assert_one_step_from_mid_run_carry("wankeeper", ZONES, KILL, G,
                                       SEED + 1, 30)


@pytest.fixture(scope="module")
def witnesses():
    """The nofloor twin's witness at the hunt's 16 groups x 80 steps
    (``tests/test_trace.py``'s case), captured by each package."""
    return capture_pair("wankeeper_nofloor", NOFLOOR, DROP, 16, 80, 0)


def test_twin_witness_equals_the_reference(witnesses):
    """The twin violates in the same group, with the same count and
    first step, and its recorded schedule is the reference's."""
    from paxi_tpu_torch import trace as ptr
    jt, pt = witnesses
    assert jt is not None and pt is not None
    for k in ("group", "group_violations", "first_violation_step",
              "capture_state_hash", "capture_counters", "schedule_hash"):
        assert pt.meta[k] == jt.meta[k], k
    assert pt.meta["group_violations"] > 0
    assert_tree_equal(jax.device_get(jt.sched), pt.sched, "sched")
    r = ptr.replay(pt, device="cpu")
    assert r.state_hash == pt.meta["capture_state_hash"]


def test_jax_twin_capture_replays_in_the_port(witnesses, tmp_path):
    """A JAX capture of the twin, saved and loaded by the port, replays to
    the capture's state hash, counters and histogram."""
    from paxi_tpu import trace as jtr
    from paxi_tpu_torch import trace as ptr
    jt, _ = witnesses
    loaded = ptr.load(jtr.save(str(tmp_path / "nofloor"), jt))
    r = ptr.check_determinism(loaded, device="cpu")
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.lat_hist == jt.meta.get("capture_lat_hist")
    assert r.violations == jt.meta["group_violations"]
    assert r.first_violation_step() == jt.meta["first_violation_step"]


def test_step_leaves_its_input_state_alone():
    """The runner's oracle reads the old state after the step, so the step
    must not write any input plane in place."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body
    proto, cfg, fuzz = (sim_protocol("wankeeper"), SimConfig(**ZONES),
                        FuzzConfig(**KILL))
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, G, tr.PRNGKey(SEED), "cpu")
        for t in range(28):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 28)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k


def test_config_bounds_raise():
    """The root command's field widths and the zone split are checked at
    init, as in the reference."""
    init = sim_protocol("wankeeper").init_state
    for bad in (dict(n_objects=129), dict(n_replicas=5)):
        with pytest.raises(AssertionError):
            init(SimConfig(**{**ZONES, **bad}), None, 1, device="cpu")
