"""The slice as a whole: the port's lane-major EPaxos run (paxi_tpu_torch
make_run on the CPU) against paxi_tpu.sim.make_run on the same seed, bit
for bit — every group-major state plane, every metric including
``recovered`` and the net_* counters, the violations, the in-scan
violations and the commit-latency histogram — fault-free at 4 keys, under
a drop/delay/leader-crash schedule that reaches recovery, and fault-free at
1 key (every command conflicts, so the closure sees large SCCs).  Also one
step from a converted mid-run JAX carry."""

import pytest

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import SimResult as JResult  # noqa: E402
from paxi_tpu.sim import make_run as jax_make_run  # noqa: E402
from paxi_tpu.sim.runner import continue_run, init_carry  # noqa: E402

from _torch_parity import assert_tree_equal  # noqa: E402
from paxi_tpu_torch import convert  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch.metrics.simcount import COUNTER_NAMES  # noqa: E402
from paxi_tpu_torch.ops import closure  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.protocols.epaxos import sim as pepaxos  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run  # noqa: E402
from paxi_tpu_torch.sim.runner import SimResult, make_scan_body  # noqa: E402
from paxi_tpu_torch.sim.runner import init_carry as port_init_carry  # noqa: E402

G, T, SEED = 8, 60, 3
# fault-free EPaxos draws nothing random: 74 instances a group commit and
# execute in 60 steps at 5 replicas, a 16-instance window and 4 keys
FAULT_FREE_EXECUTED_PER_GROUP = 74
RUNS = {
    "fault_free": (dict(n_replicas=5, n_slots=16, n_keys=4), dict()),
    "recovery": (dict(n_replicas=5, n_slots=16, n_keys=4),
                 dict(p_drop=0.15, max_delay=3, perm_crash=0,
                      perm_crash_at=10)),
    "one_key": (dict(n_replicas=5, n_slots=16, n_keys=1), dict()),
}
STATE_PLANES = tuple(pepaxos.init_state(SimConfig(n_replicas=5, n_slots=4),
                                        None, 1, device="cpu"))
METRICS = ("committed_slots", "executed", "recovered", "commit_lat_sum",
           "commit_lat_n", "inscan_violations") \
    + tuple("net_" + c for c in COUNTER_NAMES)


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    out = {}
    for name, (cfg, fz) in RUNS.items():
        js, jm, jv = jax_make_run(jax_protocol("epaxos"), JCfg(**cfg),
                                  JFuzz(**fz))(jr.PRNGKey(SEED), G, T)
        ps, pm, pv = make_run(sim_protocol("epaxos"), SimConfig(**cfg),
                              FuzzConfig(**fz), device="cpu")(
            tr.PRNGKey(SEED), G, T)
        out[name] = (JResult(state=js, metrics=jm, violations=jv, steps=T,
                             groups=G),
                     SimResult(state=ps, metrics=pm, violations=pv, steps=T,
                               groups=G))
    return out


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
def test_violations_and_inscan(runs, run):
    j, p = runs[run]
    assert_tree_equal(j.violations, p.violations, "violations")
    assert int(p.violations) == 0
    assert j.inscan_violations == p.inscan_violations == 0


@pytest.mark.parametrize("run", RUNS)
def test_latency(runs, run):
    j, p = runs[run]
    assert_tree_equal(j.latency_hist, p.latency_hist, "latency_hist")
    assert j.latency_summary() == p.latency_summary()
    assert sum(p.latency_hist) > 0


def test_fault_free_commits_and_executes_all(runs):
    m = runs["fault_free"][1].metrics
    want = FAULT_FREE_EXECUTED_PER_GROUP * G
    assert int(m["committed_slots"]) == int(m["executed"]) == want
    assert int(m["recovered"]) == 0


def test_recovery_schedule_recovers(runs):
    """The crash schedule reaches the Prepare/Accept recovery handlers."""
    p = runs["recovery"][1]
    assert int(p.metrics["recovered"]) > 0
    c = {k: int(v) for k, v in p.counters.items()}
    assert c["msgs_dropped"] > 0 and c["msgs_delayed"] > 0


def test_one_key_closure_sees_large_sccs(monkeypatch):
    """At one key every pair of commands conflicts: the graphs handed to
    the closure hold dependency cycles, so SCCs of several instances form
    and the (seq, id) order inside them decides execution."""
    largest = []
    real = pepaxos.transitive_closure

    def spy(adj):
        reach = real(adj)
        scc = reach & reach.transpose(-1, -2)
        largest.append(int(scc.sum(-1, dtype=torch.int32).max()))
        return reach

    monkeypatch.setattr(pepaxos, "transitive_closure", spy)
    cfg_kw, fz = RUNS["one_key"]
    make_run(sim_protocol("epaxos"), SimConfig(**cfg_kw), FuzzConfig(**fz),
             device="cpu")(tr.PRNGKey(SEED), G, 30)
    assert len(largest) == 30 and max(largest) >= 3


def test_one_step_from_mid_run_carry():
    """Step 20 of the recovery schedule's JAX run, taken as a carry,
    converted, and advanced one step by each package: the same carry,
    violations and counters come out."""
    cfg_kw, fz = RUNS["recovery"]
    proto, cfg, fuzz = jax_protocol("epaxos"), JCfg(**cfg_kw), JFuzz(**fz)
    carry = init_carry(proto, cfg, fuzz, G, jr.PRNGKey(SEED + 1))
    t0 = 20
    for t in range(t0):
        _, carry = continue_run(proto, cfg, carry, t, 1, fuzz)
    np_carry = jax.device_get(carry)
    res, new_carry = continue_run(proto, cfg, carry, t0, 1, fuzz)

    body = make_scan_body(sim_protocol("epaxos"), SimConfig(**cfg_kw),
                          FuzzConfig(**fz))
    closure.reset_launches()
    with torch.inference_mode():
        p_carry, (viol, counts) = body(
            convert.carry_from_numpy(np_carry, "cpu"), t0)
    assert closure.transitive_closure.launches == 0    # plain on the CPU
    assert_tree_equal(jax.device_get(new_carry),
                      convert.carry_to_numpy(p_carry), "carry")
    assert_tree_equal(res.violations, viol, "violations")
    for k, v in counts.items():
        assert_tree_equal(res.metrics[k], v, k)


def test_step_leaves_its_input_state_alone():
    """The runner's oracle reads the old state after the step, so the step
    must not write any input plane in place."""
    cfg_kw, fz = RUNS["recovery"]
    body = make_scan_body(sim_protocol("epaxos"), SimConfig(**cfg_kw),
                          FuzzConfig(**fz))
    with torch.inference_mode():
        carry = port_init_carry(sim_protocol("epaxos"), SimConfig(**cfg_kw),
                                FuzzConfig(**fz), G, tr.PRNGKey(SEED), "cpu")
        for t in range(12):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 12)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k
