"""The slice as a whole: the port's lane-major paxos run
(paxi_tpu_torch make_run on the CPU) against paxi_tpu.sim.make_run (dense
exchange) on the same seed, bit for bit — every group-major state plane,
every metric including the eight net_* counters, the violations, the
in-scan violations and the commit-latency histogram — under a fault-free,
a drop/delay and a partition/crash schedule.  Also one step from a
converted mid-run JAX carry, and the entry points' device rule."""

import numpy as np
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
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run, simulate  # noqa: E402
from paxi_tpu_torch.sim.runner import SimResult, make_scan_body  # noqa: E402

G, T, SEED = 8, 40, 3
CFG = dict(n_replicas=5, n_slots=16)
SCHEDULES = {
    "fault_free": dict(),
    "drop_delay": dict(p_drop=0.1, max_delay=3),
    "partition_crash": dict(p_partition=0.3, p_crash=0.2, window=8),
}
STATE_PLANES = ("ballot", "active", "p1_acks", "base", "log_bal", "log_cmd",
                "log_commit", "log_acks", "proposed", "next_slot",
                "execute", "kv", "timer", "stuck", "m_prop_t",
                "m_commit_dt", "m_lat_hist", "m_lat_sum", "m_inscan_viol")
METRICS = ("committed_slots", "min_execute", "has_leader", "commit_lat_sum",
           "commit_lat_n", "inscan_violations") \
    + tuple("net_" + c for c in COUNTER_NAMES)


@pytest.fixture(scope="module")
def runs():
    """{schedule: (JAX SimResult, port SimResult)}."""
    out = {}
    for name, fz in SCHEDULES.items():
        js, jm, jv = jax_make_run(jax_protocol("paxos"), JCfg(**CFG),
                                  JFuzz(**fz))(jr.PRNGKey(SEED), G, T)
        ps, pm, pv = make_run(sim_protocol("paxos"), SimConfig(**CFG),
                              FuzzConfig(**fz), device="cpu")(
            tr.PRNGKey(SEED), G, T)
        out[name] = (JResult(state=js, metrics=jm, violations=jv, steps=T,
                             groups=G),
                     SimResult(state=ps, metrics=pm, violations=pv, steps=T,
                               groups=G))
    return out


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("plane", STATE_PLANES)
def test_state_plane(runs, schedule, plane):
    j, p = runs[schedule]
    assert sorted(j.state) == sorted(p.state)
    assert_tree_equal(j.state[plane], p.state[plane], plane)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("metric", METRICS)
def test_metric(runs, schedule, metric):
    j, p = runs[schedule]
    assert sorted(j.metrics) == sorted(p.metrics)
    assert_tree_equal(j.metrics[metric], p.metrics[metric], metric)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_violations_and_inscan(runs, schedule):
    j, p = runs[schedule]
    assert_tree_equal(j.violations, p.violations, "violations")
    assert int(p.violations) == 0
    assert j.inscan_violations == p.inscan_violations == 0


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_latency(runs, schedule):
    j, p = runs[schedule]
    assert_tree_equal(j.latency_hist, p.latency_hist, "latency_hist")
    assert j.latency_summary() == p.latency_summary()
    assert sum(p.latency_hist) > 0


def test_schedules_do_differ(runs):
    """The fuzzed schedules really fault: drops, delays, collisions,
    crashes and cut edges all occur somewhere."""
    c = {k: int(v) for k, v in runs["drop_delay"][1].counters.items()}
    assert c["msgs_dropped"] > 0 and c["msgs_delayed"] > 0
    assert c["delay_collisions"] > 0
    c = {k: int(v) for k, v in runs["partition_crash"][1].counters.items()}
    assert c["crash_steps"] > 0 and c["cut_edge_steps"] > 0


def test_one_step_from_mid_run_carry():
    """Step 20 of a fuzzed JAX run, taken as a carry, converted, and
    advanced one step by each package: the same carry, violations and
    counters come out."""
    proto, cfg = jax_protocol("paxos"), JCfg(**CFG)
    fuzz = JFuzz(**SCHEDULES["drop_delay"])
    carry = init_carry(proto, cfg, fuzz, G, jr.PRNGKey(SEED + 1))
    t0 = 20
    for t in range(t0):
        _, carry = continue_run(proto, cfg, carry, t, 1, fuzz)
    np_carry = jax.device_get(carry)
    res, new_carry = continue_run(proto, cfg, carry, t0, 1, fuzz)

    body = make_scan_body(sim_protocol("paxos"), SimConfig(**CFG),
                          FuzzConfig(**SCHEDULES["drop_delay"]))
    with torch.inference_mode():
        p_carry, (viol, counts) = body(
            convert.carry_from_numpy(np_carry, "cpu"), t0)
    assert_tree_equal(jax.device_get(new_carry),
                      convert.carry_to_numpy(p_carry), "carry")
    assert_tree_equal(res.violations, viol, "violations")
    for k, v in counts.items():
        assert_tree_equal(res.metrics[k], v, k)


def test_convert_round_trip():
    """carry_from_numpy then carry_to_numpy gives the JAX carry back,
    dtypes included."""
    proto, cfg = jax_protocol("paxos"), JCfg(**CFG)
    fuzz = JFuzz(**SCHEDULES["drop_delay"])
    np_carry = jax.device_get(init_carry(proto, cfg, fuzz, G,
                                         jr.PRNGKey(SEED)))
    back = convert.carry_to_numpy(convert.carry_from_numpy(np_carry, "cpu"))
    assert_tree_equal(np_carry, back, "carry")
    assert back[3].dtype == np.uint32


def test_entry_points_need_a_device(monkeypatch):
    """Without CUDA and without an explicit device, the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proto, cfg = sim_protocol("paxos"), SimConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_run(proto, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(proto, cfg, G, 2)


def test_unported_options_raise():
    """Workloads, scenarios and the sharded replay are ported
    (tests/test_torch_workload.py, test_torch_scenarios.py,
    test_torch_parallel.py), and every registered protocol
    (tests/test_torch_demos.py); what is left raises: a name no registry
    has, a workload that does not fit the key space, and a sharded replay
    of a lane-major kernel (which the reference refuses too)."""
    from paxi_tpu_torch.parallel import make_sharded_pinned_run
    from paxi_tpu_torch.workload import HOTRANGE, ZIPF99, apply_workload
    with pytest.raises(KeyError):
        sim_protocol("no_such_protocol")
    with pytest.raises(ValueError, match="hot_keys"):
        apply_workload(SimConfig(**CFG).with_(n_keys=4), HOTRANGE)
    with pytest.raises(NotImplementedError, match="lane-major"):
        make_sharded_pinned_run(sim_protocol("paxos"), SimConfig(**CFG),
                                FuzzConfig(), 0, mesh=object())
    res = simulate(sim_protocol("paxos"),
                   apply_workload(SimConfig(**CFG), ZIPF99), G, 4,
                   device="cpu")
    assert int(res.violations) == 0 and "wl_hot_n" in res.metrics


@pytest.mark.parametrize("name", ["paxos", "epaxos", "sdpaxos", "wpaxos",
                                  "paxos_pg"])
def test_init_state_needs_a_device(monkeypatch, name):
    """A public function that builds state, called without a device,
    runs on the card, so without CUDA it raises instead of building on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim_protocol(name).init_state(SimConfig(**CFG), tr.PRNGKey(0), 4)
    state = sim_protocol(name).init_state(SimConfig(**CFG), tr.PRNGKey(0),
                                          4, device="cpu")
    assert all(v.device.type == "cpu" for v in state.values())


def test_carry_planes_need_a_device(monkeypatch):
    from paxi_tpu_torch.metrics import lathist
    from paxi_tpu_torch.protocols.paxos.sim import mailbox_spec
    from paxi_tpu_torch.sim import lanes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: lathist.empty_hist(G, **kw),
                  lambda **kw: lanes.fault_state_init(5, G, **kw),
                  lambda **kw: lanes.empty_wheel(
                      mailbox_spec(SimConfig(**CFG)), 5, G, FuzzConfig(),
                      **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        build(device="cpu")
