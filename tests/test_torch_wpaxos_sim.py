"""The port's lane-major WPaxos run (paxi_tpu_torch make_run on the CPU)
against paxi_tpu.sim.make_run on the same seed, bit for bit — every
group-major state plane, every metric including the net_* counters, the
violations, the in-scan violations and the commit-latency histogram — at
bench_all.py's ``wpaxos_3x3_grid`` configuration under a fault-free, a
drop/delay and a drop/delay/partition/owner-crash schedule, at the
multi-chip dry run's configuration under drop/delay, and the seeded
``wpaxos_thinq1`` twin once.  Also one step from a converted mid-run JAX
carry."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import (assert_one_step_from_mid_run_carry,  # noqa: E402
                           assert_tree_equal, run_pair)
from paxi_tpu_torch.metrics.simcount import COUNTER_NAMES  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402

G, T, SEED = 8, 40, 7
GRID = dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
            steal_threshold=3, locality=0.8)
DRYRUN = dict(n_replicas=6, n_zones=2, n_objects=4, n_slots=16,
              steal_threshold=3)
DROP = dict(p_drop=0.15, max_delay=2)
CRASH = dict(p_drop=0.1, max_delay=3, p_partition=0.2, window=8,
             perm_crash=0, perm_crash_at=10)
RUNS = {
    "fault_free": ("wpaxos", GRID, dict()),
    "drop_delay": ("wpaxos", GRID, DROP),
    "crash": ("wpaxos", GRID, CRASH),
    "dryrun_drop_delay": ("wpaxos", DRYRUN, DROP),
    "thinq1_crash": ("wpaxos_thinq1", GRID, CRASH),
}
STATE_PLANES = tuple(sim_protocol("wpaxos").init_state(
    SimConfig(**GRID), None, 1, device="cpu"))
METRICS = ("committed_slots", "steals", "owned_objects",
           "commit_lat_local_sum", "commit_lat_local_n",
           "commit_lat_cross_sum", "commit_lat_cross_n", "commit_lat_sum",
           "commit_lat_n", "inscan_violations") \
    + tuple("net_" + c for c in COUNTER_NAMES)


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    return {name: run_pair(proto, cfg, fz, G, T, SEED)
            for name, (proto, cfg, fz) in RUNS.items()}


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
    if not run.startswith("thinq1"):
        assert int(p.violations) == 0 and p.inscan_violations == 0


def test_runs_commit_steal_and_split_latency(runs):
    for name in RUNS:
        assert int(runs[name][1].metrics["committed_slots"]) > 0, name
    m = runs["fault_free"][1].metrics
    assert int(m["steals"]) > 0
    assert int(m["commit_lat_local_n"]) > 0
    c = {k: int(v) for k, v in runs["crash"][1].counters.items()}
    assert c["msgs_dropped"] > 0 and c["msgs_delayed"] > 0


def test_workload_raises():
    """Workloads run on wpaxos (tests/test_torch_workload_wpaxos.py); a
    spec that does not fit the key space raises, and a valid one adds its
    planes to the state."""
    from paxi_tpu_torch.workload import (CLASSES, HOTRANGE, ZIPF99,
                                         apply_workload)
    with pytest.raises(ValueError, match="hot_keys"):
        apply_workload(SimConfig(**GRID).with_(n_keys=4), HOTRANGE)
    state = sim_protocol("wpaxos").init_state(
        apply_workload(SimConfig(**GRID), ZIPF99), None, 2, device="cpu")
    assert state["wl_gid"].tolist() == [0, 1]
    assert {f"m_wl_hist_{c}" for c in CLASSES} <= set(state)


def test_one_step_from_mid_run_carry():
    assert_one_step_from_mid_run_carry("wpaxos", GRID, CRASH, G, SEED + 1,
                                       20)


def test_step_leaves_its_input_state_alone():
    """The runner's oracle reads the old state after the step, so the step
    must not write any input plane in place."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body
    proto, cfg, fuzz = (sim_protocol("wpaxos"), SimConfig(**GRID),
                        FuzzConfig(**CRASH))
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, G, tr.PRNGKey(SEED), "cpu")
        for t in range(12):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 12)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k
