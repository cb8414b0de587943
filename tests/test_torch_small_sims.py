"""The port's small lane-major kernels — chain, kpaxos, abd, dynamo and
blockchain — against paxi_tpu.sim.make_run on the same seed, bit for bit:
every state plane, every metric including the net_* counters, the
violations, the in-scan violations and the latency histogram (where the
kernel keeps them), each at its hunt configuration
(``paxi_tpu/hunt/cases.py``) fault-free and under the hunt's DROP, DUP and
PART schedules, and at its ``bench_all.py`` row (chain's 64-slot pipeline,
blockchain under bench_all's FUZZ).  Also the per-group invariants, one
step from a converted mid-run JAX carry, and each step leaving its input
state alone."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import (assert_group_invariants_equal,  # noqa: E402
                           assert_one_step_from_mid_run_carry,
                           assert_tree_equal, run_pair)
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402

G, T, SEED = 8, 40, 4
DROP = dict(p_drop=0.25, max_delay=2)
DUP = dict(p_dup=0.25, max_delay=3)
PART = dict(p_partition=0.3, p_crash=0.15, max_delay=2, window=8)
FUZZ = dict(p_drop=0.1, p_dup=0.05, max_delay=2, p_partition=0.1, window=16)
HUNT = {"chain": dict(n_replicas=3, n_slots=32),
        "kpaxos": dict(n_replicas=3, n_slots=32),
        "abd": dict(n_replicas=5, n_keys=16),
        "dynamo": dict(n_replicas=5, n_keys=8, n_slots=40),
        "blockchain": dict(n_replicas=5, n_slots=32, steal_threshold=4)}
SCHEDULES = {"fault_free": {}, "drop": DROP, "dup": DUP, "part": PART}
# run id -> (protocol, config, schedule)
RUNS = {f"{p}_{s}": (p, cfg, fz) for p, cfg in HUNT.items()
        for s, fz in SCHEDULES.items()}
RUNS["chain_pipeline"] = ("chain", dict(n_replicas=3, n_slots=64), {})
RUNS["blockchain_forks"] = ("blockchain", HUNT["blockchain"], FUZZ)


def _planes_and_metrics():
    """(run, state plane) and (run, metric) pairs, from each kernel's
    initial state and its metrics of it."""
    planes, metrics = [], []
    for run, (name, cfg, _) in RUNS.items():
        proto, c = sim_protocol(name), SimConfig(**cfg)
        state = proto.init_state(c, None, 1, device="cpu")
        planes += [(run, k) for k in state]
        metrics += [(run, k) for k in proto.metrics(state, c)]
    return planes, metrics


PLANES, METRICS = _planes_and_metrics()


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    return {run: run_pair(name, cfg, fz, G, T, SEED)
            for run, (name, cfg, fz) in RUNS.items()}


@pytest.mark.parametrize("run, plane", PLANES)
def test_state_plane(runs, run, plane):
    j, p = runs[run]
    assert sorted(j.state) == sorted(p.state)
    assert_tree_equal(j.state[plane], p.state[plane], plane)


@pytest.mark.parametrize("run, metric", METRICS)
def test_metric(runs, run, metric):
    j, p = runs[run]
    assert sorted(j.metrics) == sorted(p.metrics)
    assert_tree_equal(j.metrics[metric], p.metrics[metric], metric)


@pytest.mark.parametrize("run", RUNS)
def test_violations_counters_inscan_and_latency(runs, run):
    j, p = runs[run]
    assert_tree_equal(j.violations, p.violations, "violations")
    assert int(p.violations) == 0
    assert j.inscan_violations == p.inscan_violations
    assert p.inscan_violations in (None, 0)
    assert_tree_equal(j.counters, p.counters, "counters")
    assert_tree_equal(j.latency_hist, p.latency_hist, "latency_hist")
    assert j.latency_summary() == p.latency_summary()
    assert int(p.metrics["committed_slots"]) > 0


def test_fault_free_counts_have_closed_forms(runs):
    """Fault-free, these kernels draw nothing that changes their count
    (dynamo's keys aside), so every group does the same work: chain commits
    steps - 4 slots, kpaxos steps - 2 a partition, abd completes an op a
    replica every 4 steps after the first, dynamo writes R a step inside
    its n_slots write window."""
    per_group = {"chain_fault_free": T - 4, "kpaxos_fault_free": 3 * (T - 2),
                 "abd_fault_free": 5 * ((T - 1) // 4),
                 "dynamo_fault_free": 5 * min(T, 40),
                 "chain_pipeline": T - 4}
    for run, n in per_group.items():
        assert int(runs[run][1].metrics["committed_slots"]) == n * G, run


@pytest.mark.parametrize("name", HUNT)
def test_group_invariants_equal_the_reference(name):
    assert_group_invariants_equal(name, HUNT[name], PART, 4, 20)


@pytest.mark.parametrize("name", HUNT)
def test_one_step_from_mid_run_carry(name):
    assert_one_step_from_mid_run_carry(name, HUNT[name], DROP, G, SEED + 1,
                                       20)


@pytest.mark.parametrize("name", HUNT)
def test_step_leaves_its_input_state_alone(name):
    """The runner's oracle reads the old state after the step, so the step
    must not write any input plane in place."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import init_carry, make_scan_body
    proto, cfg, fuzz = (sim_protocol(name), SimConfig(**HUNT[name]),
                        FuzzConfig(**PART))
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, G, tr.PRNGKey(SEED), "cpu")
        for t in range(12):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 12)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k


def test_chain_ack_is_one_plane_for_every_group():
    """Chain's ack validity is ``(src, dst, 1)``, as in the reference: its
    faults are drawn once for all groups, and ``full_edges`` gives it and
    its fault planes the full edge shape, groups at stride 1."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim import mailbox as mb
    from paxi_tpu_torch.sim.runner import init_carry
    from paxi_tpu_torch.sim.types import StepCtx
    proto, cfg, fuzz = (sim_protocol("chain"), SimConfig(**HUNT["chain"]),
                        FuzzConfig(**DROP))
    state, wheel, fs, rng = init_carry(proto, cfg, fuzz, G,
                                       tr.PRNGKey(SEED), "cpu")
    inbox, _ = mb.wheel_deliver(wheel)
    _, outbox = proto.step(state, inbox, StepCtx(rng, 0, cfg))
    assert outbox["ack"]["valid"].shape == (3, 3, 1)
    faults = mb.draw_edge_faults(rng, outbox, fuzz)
    assert faults["ack"]["drop"].shape == (3, 3, 1)
    full, ffull = mb.full_edges(outbox, faults, G)
    assert full["prop"] is outbox["prop"]
    for x in [full["ack"]["valid"]] + list(ffull["ack"].values()):
        assert x.shape == (3, 3, G) and x.stride()[-1] == 1
        assert torch.equal(x, x[..., :1].expand(3, 3, G))
