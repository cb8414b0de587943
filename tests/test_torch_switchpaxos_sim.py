"""The port's switchpaxos against the JAX package, exactly.

Units: ``ring.shift_row``, the sliding-window half of ``sim/ballot_ring.py``
and every function of ``switchnet/plane.py`` on seeded random states
(numpy in between), and ``down_t``/``session_t`` over steps -5..200 for a
one-shot and a periodic sequencer churn.  Whole runs (the port's make_run
on the CPU against paxi_tpu.sim.make_run, same seed): every state plane,
metric (fast commits, gap events and register overflows among them) and
``net_*`` counter, the violations, the in-scan violations and the latency
histogram, fault-free, under bench_all.py's wan3z pair (switchpaxos beside
paxos at the same geometry) and under the hunt's DROP, PART, KILL and
seqchurn-under-DROP schedules.  The seeded ``switchpaxos_nogap`` twin: its
witness captured by both packages alike, and a JAX capture replayed in the
port to its hash.  Also the per-group invariants and one step from a
converted mid-run JAX carry (switch planes included).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.sim import ballot_ring as jbr  # noqa: E402
from paxi_tpu.sim import ring as jring  # noqa: E402
from paxi_tpu.sim.types import SimConfig as JCfg  # noqa: E402
from paxi_tpu.switchnet import plane as jsw  # noqa: E402

from _torch_parity import (assert_group_invariants_equal,  # noqa: E402
                           assert_one_step_from_mid_run_carry,
                           assert_tree_equal, capture_pair, run_pair, to_np,
                           to_torch)
from paxi_tpu_torch.metrics.simcount import COUNTER_NAMES  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import SimConfig  # noqa: E402
from paxi_tpu_torch.sim import ballot_ring as pbr  # noqa: E402
from paxi_tpu_torch.sim import ring as pring  # noqa: E402
from paxi_tpu_torch.switchnet import plane as psw  # noqa: E402

R, S, W, K, G = 5, 16, 8, 8, 12
SEEDS = [0, 1, 2]

# ---- units on seeded random states ----------------------------------------


def _jx(tree):
    """numpy leaves -> JAX arrays (numbers stay Python numbers)."""
    if isinstance(tree, dict):
        return {k: _jx(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jx(v) for v in tree)
    return jnp.asarray(tree) if isinstance(tree, np.ndarray) else tree


def _state(rng):
    """A random ballot-ring state with windows in reach of each other."""
    base = rng.integers(0, 12, (R, G)).astype(np.int32)
    execute = base + rng.integers(0, S, (R, G)).astype(np.int32)
    ballot = rng.integers(0, 40, (R, G)).astype(np.int32)
    return dict(
        ballot=ballot,
        active=rng.random((R, G)) < 0.5,
        p1_acks=rng.integers(0, 2 ** R, (R, G)).astype(np.int32),
        base=base,
        log_bal=rng.integers(0, 40, (R, S, G)).astype(np.int32),
        log_cmd=rng.integers(-2, 60, (R, S, G)).astype(np.int32),
        log_commit=rng.random((R, S, G)) < 0.4,
        log_acks=rng.integers(0, 2 ** R, (R, S, G)).astype(np.int32),
        proposed=rng.random((R, S, G)) < 0.5,
        next_slot=execute + rng.integers(0, S // 2, (R, G)).astype(np.int32),
        execute=execute,
        timer=rng.integers(-3, 9, (R, G)).astype(np.int32),
        stuck=rng.integers(0, 8, (R, G)).astype(np.int32),
    )


def _mail(rng, fields, lo=0, hi=30):
    """A random ``(src, dst, G)`` message box (slot-like fields near the
    states' windows)."""
    box = {"valid": rng.random((R, R, G)) < 0.5}
    for f in fields:
        box[f] = rng.integers(lo, hi, (R, R, G)).astype(np.int32)
    return box


def _sw(rng):
    return dict(
        sw_bal=rng.integers(0, 40, (G,)).astype(np.int32),
        sw_base=rng.integers(0, 14, (G,)).astype(np.int32),
        sw_vbal=rng.integers(0, 40, (W, G)).astype(np.int32),
        sw_vcmd=rng.integers(-1, 60, (W, G)).astype(np.int32),
        sw_reg_seq=rng.integers(-1, 20, (W, G)).astype(np.int32),
        sw_seq=rng.integers(0, 20, (G,)).astype(np.int32),
    )


def _bcast(x):
    """A per-src ``(R, G)`` value sent to every dst (``propose_write``'s
    frames)."""
    return np.broadcast_to(x[:, None, :], (R, R, G)).copy()


def _inputs(name, rng):
    """(args, kwargs) of a unit, as numpy."""
    st = _state(rng)
    if name == "shift_row":
        return (rng.integers(-9, 9, (S, G)).astype(np.int32),
                rng.integers(-S - 2, 2 * S, (R, G)).astype(np.int32), -7), {}
    amask = rng.random((R, R, G)) < 0.6
    p1_win = rng.random((R, G)) < 0.5
    kv = {"kv": rng.integers(0, 99, (R, K, G)).astype(np.int32)}
    new_exec = st["execute"] + rng.integers(0, 4, (R, G)).astype(np.int32)
    is_leader = rng.random((R, G)) < 0.5
    return {
        "adopt_best_acker": ((st, amask, p1_win, kv), {}),
        "merge_acker_logs": ((st, amask, p1_win), {}),
        "accept_p2a": ((st, _mail(rng, ("bal", "slot", "cmd"))), {}),
        "tally_p2b": ((st, _mail(rng, ("bal", "slot")), 3, 8), {}),
        "apply_p3": ((st, _mail(rng, ("bal", "slot", "cmd", "upto")), kv),
                     {}),
        "repropose_target": ((st,), {}),
        "p3_out": ((st, rng.random((R, S, G)) < 0.2, new_exec, is_leader,
                    13), {}),
        "retry_stuck": ((st, new_exec, is_leader, 3), {}),
        "slide_window": ((st, new_exec, 8), {}),
    }[name]


RING_UNITS = ("shift_row", "adopt_best_acker", "merge_acker_logs",
              "accept_p2a", "tally_p2b", "apply_p3", "repropose_target",
              "p3_out", "retry_stuck", "slide_window")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", RING_UNITS)
def test_ring_unit(name, seed):
    args, kw = _inputs(name, np.random.default_rng(seed))
    jmod, pmod = (jring, pring) if name == "shift_row" else (jbr, pbr)
    want = getattr(jmod, name)(*_jx(args), **kw)
    got = getattr(pmod, name)(*to_torch(args), **kw)
    assert_tree_equal(to_np(want), to_np(got), name)


CHURN = {"never": dict(),
         "one_shot": dict(sw_down_start=40, sw_down_period=0,
                          sw_down_for=20),
         "periodic": dict(sw_down_start=20, sw_down_period=40,
                          sw_down_for=12)}


@pytest.mark.parametrize("churn", CHURN)
def test_down_and_session_over_steps(churn):
    """The churn schedule at every step from -5 to 200, on the knobs
    ``apply_switch`` compiles from SwitchChurn."""
    jcfg, pcfg = JCfg(**CHURN[churn]), SimConfig(**CHURN[churn])
    for t in range(-5, 201):
        assert psw.down_t(pcfg, t) == bool(jsw.down_t(jcfg, jnp.int32(t))), t
        assert psw.session_t(pcfg, t) == int(jsw.session_t(jcfg,
                                                           jnp.int32(t))), t
    if churn != "never":
        assert any(psw.down_t(pcfg, t) for t in range(200))
        assert psw.session_t(pcfg, 200) >= 1


def _plane_inputs(name, rng, cfg_kw):
    st = _state(rng)
    sw = _sw(rng)
    jcfg, pcfg = JCfg(n_replicas=R, n_slots=S, sw_window=W, **cfg_kw), \
        SimConfig(n_replicas=R, n_slots=S, sw_window=W, **cfg_kw)
    is_leader = rng.random((R, G)) < 0.5
    p1_win = rng.random((R, G)) < 0.5
    # a proposer's frames, uniform over dst; slots near the file
    p2a = {"valid": _bcast(rng.random((R, G)) < 0.6),
           "bal": _bcast(rng.integers(0, 45, (R, G)).astype(np.int32)),
           "slot": _bcast(sw["sw_base"][None] + rng.integers(
               -2, W + 2, (R, G)).astype(np.int32)),
           "cmd": _bcast(rng.integers(0, 60, (R, G)).astype(np.int32))}
    sidx = np.arange(S, dtype=np.int32)
    if name == "align_to_ring":
        return (sw["sw_vbal"], sw["sw_base"], st["base"], S, -3), None
    if name == "observe_p1a":
        return (sw, _mail(rng, ("bal",), 0, 50)), None
    if name == "observe_p2a":
        return (sw, p2a), (jcfg, pcfg)
    if name in ("fast_commit_mask", "apply_fast_commits"):
        return (sw, st, is_leader, S), None
    if name == "gap_reopen":
        return (st, rng.random((R, S, G)) < 0.3), None
    if name == "noop_commit_holes":
        return (st, rng.random((R, G)) < 0.5,
                st["base"] + rng.integers(0, S, (R, G)).astype(np.int32),
                sidx), None
    if name == "recovery_fold":
        return (sw, st, p1_win, S), None
    if name == "evict":
        return (sw, sw["sw_base"][None] + rng.integers(
            -2, W + 3, (R, G)).astype(np.int32)), None
    raise KeyError(name)


PLANE_UNITS = ("align_to_ring", "observe_p1a", "observe_p2a",
               "fast_commit_mask", "apply_fast_commits", "gap_reopen",
               "noop_commit_holes", "recovery_fold", "evict")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", PLANE_UNITS)
def test_plane_unit(name, seed):
    """Each plane function; ``observe_p2a`` at steps inside and outside a
    down window of the periodic churn and of none."""
    rng = np.random.default_rng(seed)
    for cfg_kw, t in (({}, 7), (CHURN["periodic"], 25),
                      (CHURN["periodic"], 70), (CHURN["one_shot"], 90)):
        args, cfgs = _plane_inputs(name, rng, cfg_kw)
        if cfgs is None:
            want = getattr(jsw, name)(*_jx(args))
            got = getattr(psw, name)(*to_torch(args))
        else:
            want = getattr(jsw, name)(*_jx(args), cfgs[0], jnp.int32(t))
            got = getattr(psw, name)(*to_torch(args), cfgs[1], t)
        assert_tree_equal(to_np(want), to_np(got), f"{name} t={t}")


def test_init_planes():
    cfg = dict(n_replicas=R, n_slots=S, sw_window=W)
    assert_tree_equal(jsw.init_planes(JCfg(**cfg), G),
                      psw.init_planes(SimConfig(**cfg), G, device="cpu"))
    with pytest.raises(ValueError, match="sw_window"):
        psw.init_planes(SimConfig(n_slots=8, sw_window=16), G, device="cpu")


# ---- whole runs ----------------------------------------------------------

T, SEED = 40, 5
HUNT = dict(n_replicas=5, n_slots=32)          # paxi_tpu/hunt/cases.py
PAIR = dict(n_replicas=3, n_slots=32)          # bench_all.py's wan3z pair
SEQCHURN = dict(HUNT, sw_down_start=20, sw_down_period=40, sw_down_for=12)
DROP = dict(p_drop=0.25, max_delay=2)
PART = dict(p_partition=0.3, p_crash=0.15, max_delay=2, window=8)
KILL = dict(p_drop=0.1, max_delay=2, perm_crash=0, perm_crash_at=25)
WAN3Z = dict(scenario="wan3z")
# (protocol, config, schedule, groups, steps)
RUNS = {
    "fault_free": ("switchpaxos", HUNT, {}, 8, T),
    "switch_wan3z": ("switchpaxos", PAIR, WAN3Z, 8, 60),
    "paxos_wan3z": ("paxos", PAIR, WAN3Z, 8, 60),
    "drop": ("switchpaxos", HUNT, DROP, 8, T),
    "part": ("switchpaxos", HUNT, PART, 8, T),
    "kill": ("switchpaxos", HUNT, KILL, 8, T),
    "seqchurn_drop": ("switchpaxos", SEQCHURN, DROP, 8, 70),
}
STATE_PLANES = tuple(sim_protocol("switchpaxos").init_state(
    SimConfig(**HUNT), None, 1, device="cpu"))
METRICS = ("committed_slots", "min_execute", "has_leader", "fast_commits",
           "gap_events", "sw_overflows", "commit_lat_sum", "commit_lat_n",
           "inscan_violations") + tuple("net_" + c for c in COUNTER_NAMES)


@pytest.fixture(scope="module")
def runs():
    """{run: (JAX SimResult, port SimResult)}."""
    return {name: run_pair(proto, cfg, fz, g, t, SEED)
            for name, (proto, cfg, fz, g, t) in RUNS.items()}


@pytest.mark.parametrize("run", [r for r in RUNS if r != "paxos_wan3z"])
@pytest.mark.parametrize("plane", STATE_PLANES)
def test_state_plane(runs, run, plane):
    j, p = runs[run]
    assert sorted(j.state) == sorted(p.state)
    assert_tree_equal(j.state[plane], p.state[plane], plane)


@pytest.mark.parametrize("run", RUNS)
def test_metrics(runs, run):
    j, p = runs[run]
    assert sorted(j.metrics) == sorted(p.metrics)
    assert_tree_equal(j.metrics, p.metrics, run)
    if RUNS[run][0] == "switchpaxos":
        assert set(METRICS) <= set(p.metrics)


@pytest.mark.parametrize("run", RUNS)
def test_violations_inscan_and_latency(runs, run):
    j, p = runs[run]
    assert_tree_equal(j.violations, p.violations, "violations")
    assert j.inscan_violations == p.inscan_violations
    assert_tree_equal(j.latency_hist, p.latency_hist, "latency_hist")
    assert j.latency_summary() == p.latency_summary()
    assert int(p.violations) == 0 and p.inscan_violations == 0
    assert int(p.metrics["committed_slots"]) > 0


def test_the_switch_takes_the_fast_path_and_heals_gaps(runs):
    """Fault-free, the switch votes every commit; drops open stamp gaps;
    the churn schedule bumps the session; under wan3z the switch commits
    at least a round sooner than paxos at the median (bench_all's pair,
    the reference's ``verify.sh --bench`` check)."""
    m = runs["fault_free"][1].metrics
    assert int(m["fast_commits"]) > 0 and int(m["gap_events"]) == 0
    assert int(runs["drop"][1].metrics["gap_events"]) > 0
    assert int(torch.max(runs["seqchurn_drop"][1].state["r_sess"])) >= 1
    sw = runs["switch_wan3z"][1].latency_summary()["p50_rounds"]
    px = runs["paxos_wan3z"][1].latency_summary()["p50_rounds"]
    assert sw + 1 <= px, (sw, px)


@pytest.mark.parametrize("name, cfg, fz", [
    ("switchpaxos", HUNT, PART), ("switchpaxos", SEQCHURN, DROP),
    ("switchpaxos_nogap", HUNT, DROP)])
def test_group_invariants_equal_the_reference(name, cfg, fz):
    assert_group_invariants_equal(name, cfg, fz, 4, 16)


def test_one_step_from_mid_run_carry():
    """Step 30 of a seqchurn-under-DROP run (inside the second down
    window's reach; the session bumped at step 32), switch planes and
    all."""
    assert_one_step_from_mid_run_carry("switchpaxos", SEQCHURN, DROP, 8,
                                       SEED + 1, 30)


@pytest.fixture(scope="module")
def witnesses():
    """The nogap twin's witness at the hunt's 16 groups x 80 steps
    (DEMO_CASES), captured by each package."""
    return capture_pair("switchpaxos_nogap", HUNT, DROP, 16, 80, 0)


def test_twin_witness_equals_the_reference(witnesses):
    """The twin violates in the same group, with the same count and first
    step, and its recorded schedule is the reference's."""
    from paxi_tpu_torch import trace as ptr
    jt, pt = witnesses
    assert jt is not None and pt is not None
    for k in ("group", "group_violations", "first_violation_step",
              "capture_state_hash", "capture_counters", "schedule_hash"):
        assert pt.meta[k] == jt.meta[k], k
    assert pt.meta["group_violations"] > 0
    assert_tree_equal(jax.device_get(jt.sched), pt.sched, "sched")
    assert ptr.replay(pt, device="cpu").state_hash \
        == pt.meta["capture_state_hash"]


def test_jax_twin_capture_replays_in_the_port(witnesses, tmp_path):
    """A JAX capture of the twin, saved and loaded by the port, replays to
    the capture's state hash, counters and histogram."""
    from paxi_tpu import trace as jtr
    from paxi_tpu_torch import trace as ptr
    jt, _ = witnesses
    loaded = ptr.load(jtr.save(str(tmp_path / "nogap"), jt))
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
    proto, cfg, fuzz = (sim_protocol("switchpaxos"), SimConfig(**SEQCHURN),
                        FuzzConfig(**DROP))
    body = make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = init_carry(proto, cfg, fuzz, 8, tr.PRNGKey(SEED), "cpu")
        for t in range(24):
            carry, _ = body(carry, t)
        before = {k: v.clone() for k, v in carry[0].items()}
        body(carry, 24)
    for k, v in before.items():
        assert torch.equal(v, carry[0][k]), k
    # the state's planes are real: no stride-0 (expanded) plane
    for k, v in carry[0].items():
        assert 0 not in v.stride() or v.numel() <= 1, k
