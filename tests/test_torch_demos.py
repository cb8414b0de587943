"""The port's per-group demo kernels against the JAX package, exactly:
``fragile_counter`` (the trace engine's drop-sensitive lab rat) under the
hunt's DROP, and ``relay_churn`` (the scenario engine's churn-sensitive
twin) under CHURN and WAN3Z_CHURN, at the hunt's DEMO_CASES shapes
(``paxi_tpu/hunt/cases.py``).  Every state plane, metric, ``net_*``
counter and violation count; each twin's witness captured by both
packages alike; a JAX capture replayed in the port to its hash; one step
from a converted mid-run JAX carry in the per-group layout; and the
registry resolving every sim name the JAX package registers."""

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from _torch_parity import (assert_one_step_from_mid_run_carry,  # noqa: E402
                           assert_tree_equal, capture_pair, run_pair)
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402

SEED = 5
CFG = dict(n_replicas=3)
DROP = dict(p_drop=0.25, max_delay=2)
CHURN = dict(scenario="churn")
WAN3Z_CHURN = dict(scenario="wan3z_churn")
# (protocol, schedule, groups, steps): DEMO_CASES
RUNS = {
    "fragile_drop": ("fragile_counter", DROP, 8, 30),
    "fragile_fault_free": ("fragile_counter", {}, 8, 30),
    "relay_churn": ("relay_churn", CHURN, 8, 60),
    "relay_wan3z_churn": ("relay_churn", WAN3Z_CHURN, 8, 60),
    "relay_fault_free": ("relay_churn", {}, 8, 60),
}


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    return {name: run_pair(proto, CFG, fz, g, t, SEED)
            for name, (proto, fz, g, t) in RUNS.items()}


@pytest.mark.parametrize("run", RUNS)
def test_run_equals_the_reference(runs, run):
    """Every state plane (group axis leading in both), metric, counter
    and the violations."""
    j, p = runs[run]
    assert_tree_equal(j.state, p.state, "state")
    assert_tree_equal(j.metrics, p.metrics, "metrics")
    assert_tree_equal(j.violations, p.violations, "violations")
    assert p.state["last"].shape == (RUNS[run][2], CFG["n_replicas"])


@pytest.mark.parametrize("run", RUNS)
def test_violates_only_under_faults(runs, run):
    """The demos' violations are their output: every faulted schedule
    violates, a fault-free run does not."""
    p = runs[run][1]
    if run.endswith("fault_free"):
        assert int(p.violations) == 0
    else:
        assert int(p.violations) > 0
    assert int(p.metrics["delivered"]) > 0


@pytest.fixture(scope="module")
def witnesses():
    return {"fragile_counter": capture_pair("fragile_counter", CFG, DROP, 8,
                                            30, 0),
            "relay_churn": capture_pair("relay_churn", CFG, WAN3Z_CHURN, 8,
                                        60, 0)}


@pytest.mark.parametrize("name", ["fragile_counter", "relay_churn"])
def test_witness_equals_the_reference(witnesses, name):
    from paxi_tpu_torch import trace as ptr
    jt, pt = witnesses[name]
    assert jt is not None and pt is not None
    for k in ("group", "group_violations", "first_violation_step",
              "capture_state_hash", "capture_counters", "schedule_hash"):
        assert pt.meta[k] == jt.meta[k], k
    assert_tree_equal(jax.device_get(jt.sched), pt.sched, "sched")
    assert ptr.replay(pt, device="cpu").state_hash \
        == pt.meta["capture_state_hash"]


@pytest.mark.parametrize("name", ["fragile_counter", "relay_churn"])
def test_jax_capture_replays_in_the_port(witnesses, name, tmp_path):
    from paxi_tpu import trace as jtr
    from paxi_tpu_torch import trace as ptr
    jt, _ = witnesses[name]
    loaded = ptr.load(jtr.save(str(tmp_path / name), jt))
    r = ptr.check_determinism(loaded, device="cpu")
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.violations == jt.meta["group_violations"]
    assert r.first_violation_step() == jt.meta["first_violation_step"]


@pytest.mark.parametrize("name, fz, t0", [("fragile_counter", DROP, 12),
                                          ("relay_churn", CHURN, 25)])
def test_one_step_from_mid_run_carry(name, fz, t0):
    assert_one_step_from_mid_run_carry(name, CFG, fz, 8, SEED + 1, t0)


def test_every_jax_sim_name_resolves():
    """``sim_protocol`` resolves every key of the JAX registry, to a kernel
    of the same name and layout."""
    from paxi_tpu.protocols import sim_protocol as jax_protocol
    from paxi_tpu.protocols import sim_protocols
    for name in sim_protocols():
        p, j = sim_protocol(name), jax_protocol(name)
        assert (p.name, p.batched) == (j.name, j.batched), name
    with pytest.raises(KeyError):
        sim_protocol("no_such_protocol")


def test_init_state_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("fragile_counter", "relay_churn", "switchpaxos"):
        with pytest.raises(RuntimeError, match="CUDA"):
            sim_protocol(name).init_state(SimConfig(**CFG), None, 4)
        state = sim_protocol(name).init_state(SimConfig(**CFG), None, 4,
                                              device="cpu")
        assert all(v.device.type == "cpu" for v in state.values())
