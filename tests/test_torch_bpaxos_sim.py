"""The port's lane-major BPaxos run (paxi_tpu_torch make_run on the CPU)
against paxi_tpu.sim.make_run on the same seed, bit for bit — every state
plane, every metric, the violations, the in-scan violations and the
latency histogram — at the hunt's 7-node shape (2 proxies, a 2 x 2
acceptor grid, 1 executor) fault-free and under DROP, DUP, PART, KILL
(proxy 0 down for good from step 25: the other proxy's takeover recovery
reads a grid column) and GEO2Z, at bench_all.py's ``bpaxos_grid`` (32
slots; its HT-Paxos batch sizes drawn from the seed), and the seeded
``bpaxos_noread`` twin at the hunt's shape (16 groups x 80 steps under
DROP).  Also the grid quorum counts, the per-group invariants, one step
from a converted mid-run JAX carry, and the twin's witness captured by
each package and replayed across them."""

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_parity import (assert_group_invariants_equal,  # noqa: E402
                           assert_one_step_from_mid_run_carry,
                           assert_tree_equal, capture_pair, run_pair)
from paxi_tpu_torch.metrics.simcount import COUNTER_NAMES  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402

G, T, SEED = 8, 40, 3
HUNT = dict(n_replicas=7, n_slots=16)
GRID = dict(n_replicas=7, n_slots=32)
DROP = dict(p_drop=0.25, max_delay=2)
DUP = dict(p_dup=0.25, max_delay=3)
PART = dict(p_partition=0.3, p_crash=0.15, max_delay=2, window=8)
KILL = dict(p_drop=0.1, max_delay=2, perm_crash=0, perm_crash_at=25)
GEO2Z = dict(p_drop=0.05, scenario="wan2z")
# (protocol, config, schedule, groups, steps)
RUNS = {
    "fault_free": ("bpaxos", HUNT, {}, G, T),
    "drop": ("bpaxos", HUNT, DROP, G, T),
    "dup": ("bpaxos", HUNT, DUP, G, T),
    "part": ("bpaxos", HUNT, PART, G, T),
    "kill": ("bpaxos", HUNT, KILL, G, 60),
    "geo2z": ("bpaxos", HUNT, GEO2Z, G, T),
    "grid_fault_free": ("bpaxos", GRID, {}, G, T),
    "noread_drop": ("bpaxos_noread", HUNT, DROP, 16, 80),
}
STATE_PLANES = tuple(sim_protocol("bpaxos").init_state(
    SimConfig(**HUNT), None, 1, device="cpu"))
METRICS = ("committed_slots", "committed_cmds", "min_execute", "recoveries",
           "commit_lat_sum", "commit_lat_n", "inscan_violations") \
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
    if run.startswith("noread"):
        assert int(p.violations) > 0
    else:
        assert int(p.violations) == 0 and p.inscan_violations == 0


def test_runs_commit_batches_and_recover(runs):
    """Every run commits; batches carry more commands than slots; KILL
    takes the dead proxy's stripe over."""
    for name in RUNS:
        assert int(runs[name][1].metrics["committed_slots"]) > 0, name
    m = runs["grid_fault_free"][1].metrics
    assert int(m["committed_cmds"]) > int(m["committed_slots"])
    assert int(runs["kill"][1].metrics["recoveries"]) > 0


def test_grid_quorums_equal_the_reference():
    """Row and column quorum counts of every 7-bit ack mask, and the
    geometry check."""
    from paxi_tpu.protocols.bpaxos import sim as jb
    from paxi_tpu.sim import SimConfig as JCfg
    from paxi_tpu_torch.protocols.bpaxos import sim as pb
    acks = np.arange(1 << 7, dtype=np.int32)
    for fn in ("_row_quorums", "_col_quorums"):
        want = getattr(jb, fn)(jnp.asarray(acks), JCfg(**HUNT))
        got = getattr(pb, fn)(torch.from_numpy(acks), SimConfig(**HUNT))
        assert_tree_equal(want, got, fn)
    with pytest.raises(ValueError, match="n_replicas"):
        pb._geometry(SimConfig(n_replicas=6))


@pytest.mark.parametrize("name, fz", [("bpaxos", KILL),
                                      ("bpaxos_noread", DROP)])
def test_group_invariants_equal_the_reference(name, fz):
    assert_group_invariants_equal(name, HUNT, fz, 4, 30)


def test_one_step_from_mid_run_carry():
    """Step 40 of a KILL run (proxy 0 down since step 25)."""
    assert_one_step_from_mid_run_carry("bpaxos", HUNT, KILL, G, SEED + 1,
                                       40)


@pytest.fixture(scope="module")
def witnesses():
    """The noread twin's witness at the hunt's 16 groups x 80 steps
    (``paxi_tpu/hunt/cases.py``), captured by each package."""
    return capture_pair("bpaxos_noread", HUNT, DROP, 16, 80, 0)


def test_twin_witness_equals_the_reference(witnesses):
    """The twin violates in the same group, with the same count and
    first step, and its recorded schedule is the reference's."""
    jt, pt = witnesses
    assert jt is not None and pt is not None
    for k in ("group", "group_violations", "first_violation_step",
              "capture_state_hash", "capture_counters", "schedule_hash"):
        assert pt.meta[k] == jt.meta[k], k
    assert pt.meta["group_violations"] > 0
    assert_tree_equal(jax.device_get(jt.sched), pt.sched, "sched")


def test_twin_witness_replays_across_the_runtimes(witnesses, tmp_path):
    """The JAX capture replays in the port, the port's in the reference,
    each to its capture's hash and counters."""
    from paxi_tpu import trace as jtr
    from paxi_tpu_torch import trace as ptr
    jt, pt = witnesses
    r = ptr.check_determinism(ptr.load(jtr.save(str(tmp_path / "j"), jt)),
                              device="cpu")
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.lat_hist == jt.meta.get("capture_lat_hist")
    assert r.first_violation_step() == jt.meta["first_violation_step"]
    r = jtr.replay(jtr.load(ptr.save(str(tmp_path / "p"), pt)))
    assert r.state_hash == pt.meta["capture_state_hash"]
    assert r.counters == pt.meta["capture_counters"]


def test_step_leaves_its_input_state_alone():
    """The runner's oracle reads the old state after the step, so the step
    must not write any input plane in place."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body
    proto, cfg, fuzz = (sim_protocol("bpaxos"), SimConfig(**HUNT),
                        FuzzConfig(**KILL))
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, G, tr.PRNGKey(SEED), "cpu")
        for t in range(40):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 40)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k
