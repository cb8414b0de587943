"""The port's sim building blocks against the JAX package, function by
function, on reachable states.

Carries are harvested from a fuzzed JAX run (``FuzzConfig(p_drop=0.1,
max_delay=3)``) at several steps; at each, the JAX kernel's step is
replayed call by call (the sequence of ``protocols/paxos/sim.py`` step),
recording every consensus-core call's inputs and outputs.  Each recorded
call then runs through the port's twin on the same inputs (numpy in
between) and must give exactly the same planes, dtype included.
"""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.metrics import lathist as jlat  # noqa: E402
from paxi_tpu.metrics import simcount as jsc  # noqa: E402
from paxi_tpu.ops.hashing import fib_key as jfib  # noqa: E402
from paxi_tpu.protocols.paxos import sim as jpaxos  # noqa: E402
from paxi_tpu.sim import cell as jcell  # noqa: E402
from paxi_tpu.sim import cell_ring as jbr  # noqa: E402
from paxi_tpu.sim import inscan as jinscan  # noqa: E402
from paxi_tpu.sim import lanes as jlanes  # noqa: E402
from paxi_tpu.sim import mailbox as jmb  # noqa: E402
from paxi_tpu.sim import ring as jring  # noqa: E402
from paxi_tpu.sim.runner import continue_run, init_carry  # noqa: E402
from paxi_tpu.sim.types import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim.types import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim.types import StepCtx as JCtx  # noqa: E402

from _torch_parity import (assert_tree_equal, key_to_torch, to_np,  # noqa: E402
                           to_torch)
from paxi_tpu_torch.metrics import lathist as plat  # noqa: E402
from paxi_tpu_torch.metrics import simcount as psc  # noqa: E402
from paxi_tpu_torch.ops.hashing import fib_key as pfib  # noqa: E402
from paxi_tpu_torch.protocols.paxos import sim as ppaxos  # noqa: E402
from paxi_tpu_torch.sim import ballot_ring as pballot  # noqa: E402
from paxi_tpu_torch.sim import cell as pcell  # noqa: E402
from paxi_tpu_torch.sim import cell_ring as pbr  # noqa: E402
from paxi_tpu_torch.sim import inscan as pinscan  # noqa: E402
from paxi_tpu_torch.sim import lanes as planes  # noqa: E402
from paxi_tpu_torch.sim import mailbox as pmb  # noqa: E402
from paxi_tpu_torch.sim import ring as pring  # noqa: E402
from paxi_tpu_torch.sim.types import FuzzConfig as PFuzz  # noqa: E402
from paxi_tpu_torch.sim.types import SimConfig as PCfg  # noqa: E402
from paxi_tpu_torch.sim.types import StepCtx as PCtx  # noqa: E402

G = 8
SEG = 8
HARVEST = (8, 16, 32)
FUZZ = dict(p_drop=0.1, max_delay=3)
FAULT_DRAW = dict(p_partition=0.5, p_crash=0.3, window=1)
CONFIGS = {"r5": dict(n_replicas=5, n_slots=16),
           "r3": dict(n_replicas=3, n_slots=16)}
CARRIES = [(c, h) for c in CONFIGS for h in HARVEST]
T = to_torch


def _pcfg(jcfg):
    return PCfg(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def harvested():
    """{(config, step): (jax cfg, numpy carry)} from fuzzed JAX runs."""
    out = {}
    fuzz = JFuzz(**FUZZ)
    for cname, kw in CONFIGS.items():
        cfg = JCfg(**kw)
        carry = init_carry(jpaxos.PROTOCOL, cfg, fuzz, G, jr.PRNGKey(11))
        t = 0
        for h in HARVEST:
            while t < h:
                _, carry = continue_run(jpaxos.PROTOCOL, cfg, carry, t, SEG,
                                        fuzz)
                t += SEG
            out[(cname, h)] = (cfg, jax.device_get(carry))
    return out


def _record(cfg, carry, t):
    """Replay one JAX paxos step call by call; {name: (args, outputs)}
    with numpy leaves."""
    state, wheel, fs, key = carry
    calls = {}

    def call(name, fn, *args):
        out = fn(*args)
        calls[name] = (to_np(args), to_np(out))
        return out

    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    _, k_step, k_fault, k_ins = jr.split(jnp.asarray(key), 4)
    inbox, rolled = call("wheel_deliver", jmb.wheel_deliver, wheel)
    st = {k: jnp.asarray(state[k]) for k in jbr.KEYS}
    kv = jnp.asarray(state["kv"])
    st, _, promote = call("promise_p1a", jbr.promise_p1a, st, inbox["p1a"])
    st, p1_win, amask = call("tally_p1b", jbr.tally_p1b, st, inbox["p1b"],
                             MAJ, STRIDE)
    rng = np.random.default_rng(t + R)
    forced_amask = jnp.asarray(rng.random((R, R, G)) < 0.6)
    forced_win = jnp.ones((R, G), bool)
    call("adopt_forced", jbr.adopt_best_acker, st, forced_amask, forced_win,
         {"kv": kv})
    call("merge_forced", jbr.merge_acker_logs, st, forced_amask, forced_win)
    st, ex = call("adopt_best_acker", jbr.adopt_best_acker, st, amask,
                  p1_win, {"kv": kv})
    st = call("merge_acker_logs", jbr.merge_acker_logs, st, amask, p1_win)
    st, _, acc_ok, _ = call("accept_p2a", jbr.accept_p2a, st, inbox["p2a"])
    st, newly = call("tally_p2b", jbr.tally_p2b, st, inbox["p2b"], MAJ,
                     STRIDE)
    dt = jnp.clip(t - jnp.asarray(state["m_prop_t"]), 0, None)
    call("hist_update", jlat.hist_update, jnp.asarray(state["m_lat_hist"]),
         dt, newly)
    st, ex, c_has, c_bal = call("apply_p3", jbr.apply_p3, st, inbox["p3"],
                                {"kv": ex["kv"]})
    is_leader = call("own_bal_mask", jbr.own_bal_mask, st, STRIDE) \
        & st["active"]
    has_re, can_new, _, prop_slot, oh_p, re_cmd = call(
        "repropose_target", jbr.repropose_target, st)
    is_new = ~has_re & can_new
    prop_cmd = jnp.where(is_new, jpaxos.encode_cmd(st["ballot"], prop_slot),
                         re_cmd)
    do = is_leader & (has_re | can_new)
    st, _ = call("propose_write", jbr.propose_write, st, do, is_new,
                 prop_cmd, prop_slot, oh_p)
    new_execute = st["execute"] + jnp.asarray(rng.integers(0, 3, (R, G)),
                                              jnp.int32)
    call("p3_out", jbr.p3_out, st, newly, new_execute, is_leader, t)
    st = call("retry_stuck", jbr.retry_stuck, st, new_execute, is_leader,
              cfg.retry_timeout)
    heard = promote | acc_ok | (c_has & (c_bal >= st["ballot"]))
    st, _ = call("election_tick", jbr.election_tick, st, heard, k_step, cfg)
    call("slide_window", jbr.slide_window, st, new_execute, max(S // 2, 1))
    call("depose", jbr.depose, st, heard, st["ballot"] + 64)
    call("advance_clear", jcell.advance_clear,
         jnp.asarray(state["m_prop_t"]), jnp.asarray(state["base"]),
         st["base"], 0)

    new_state, outbox = call("paxos_step", jpaxos.step, state, inbox,
                             JCtx(k_step, t, cfg))
    call("invariants", jpaxos.invariants, state, new_state, cfg)
    call("spot_check", functools.partial(jinscan.spot_check, lane_major=True),
         state["execute"], new_state["execute"], state["base"],
         new_state["base"], jcell.cell_abs(jnp.asarray(state["base"]), S),
         jcell.cell_abs(new_state["base"], S), state["log_cmd"],
         new_state["log_cmd"], state["log_commit"], new_state["log_commit"],
         new_state["kv"])
    call("flush_pending", jlat.flush_pending, new_state)
    fuzz = JFuzz(**FUZZ)
    faults = call("draw_edge_faults", jmb.draw_edge_faults, k_ins, outbox,
                  fuzz)
    fs2 = call("fault_state_refresh", jlanes.fault_state_refresh, fs,
               k_fault, t, JFuzz(**FAULT_DRAW), R)
    call("step_counts", jsc.step_counts, inbox, outbox, faults, fs2, R,
         rolled)
    call("metrics", jpaxos.metrics, new_state, cfg)
    return calls


@pytest.fixture(scope="module")
def recorded(harvested):
    return {k: _record(cfg, carry, k[1])
            for k, (cfg, carry) in harvested.items()}


def _spot(a):
    return pinscan.spot_check(*T(a[:10]), kv=T(a[10]))


def _wheel_deliver(a):
    wheel = {n: pmb.WheelBox(tuple(f for f in b if f != "valid"),
                             pmb.stack_box(T(b), tuple(f for f in b
                                                       if f != "valid")))
             for n, b in a[0].items()}
    inbox, rolled = pmb.wheel_deliver(wheel)
    return inbox, {n: pmb.unstack_box(b.planes, b.fields)
                   for n, b in rolled.items()}


# port twin of each recorded call, given the numpy arguments
PORT = {
    "wheel_deliver": _wheel_deliver,
    "promise_p1a": lambda a: pbr.promise_p1a(*T(a)),
    "tally_p1b": lambda a: pbr.tally_p1b(*T(a)),
    "adopt_forced": lambda a: pbr.adopt_best_acker(*T(a)),
    "merge_forced": lambda a: pbr.merge_acker_logs(*T(a)),
    "adopt_best_acker": lambda a: pbr.adopt_best_acker(*T(a)),
    "merge_acker_logs": lambda a: pbr.merge_acker_logs(*T(a)),
    "accept_p2a": lambda a: pbr.accept_p2a(*T(a)),
    "tally_p2b": lambda a: pbr.tally_p2b(*T(a)),
    "hist_update": lambda a: plat.hist_update(*T(a)),
    "apply_p3": lambda a: pbr.apply_p3(*T(a)),
    "own_bal_mask": lambda a: pbr.own_bal_mask(*T(a)),
    "repropose_target": lambda a: pbr.repropose_target(*T(a)),
    "propose_write": lambda a: pbr.propose_write(*T(a)),
    "p3_out": lambda a: pbr.p3_out(*T(a)),
    "retry_stuck": lambda a: pbr.retry_stuck(*T(a)),
    "election_tick": lambda a: pbr.election_tick(
        T(a[0]), T(a[1]), key_to_torch(a[2]), _pcfg(a[3])),
    "slide_window": lambda a: pbr.slide_window(*T(a)),
    "depose": lambda a: pbr.depose(*T(a)),
    "advance_clear": lambda a: pcell.advance_clear(*T(a)),
    "paxos_step": lambda a: ppaxos.step(
        T(a[0]), T(a[1]), PCtx(key_to_torch(a[2][0]), a[2][1],
                               _pcfg(a[2][2]))),
    "invariants": lambda a: ppaxos.invariants(T(a[0]), T(a[1]),
                                              _pcfg(a[2])),
    "spot_check": _spot,
    "flush_pending": lambda a: plat.flush_pending(T(a[0])),
    "draw_edge_faults": lambda a: pmb.draw_edge_faults(
        key_to_torch(a[0]), T(a[1]), PFuzz(**FUZZ)),
    "fault_state_refresh": lambda a: planes.fault_state_refresh(
        T(a[0]), key_to_torch(a[1]), a[2], PFuzz(**FAULT_DRAW), a[4]),
    "step_counts": lambda a: psc.step_counts(
        *T(a[:5]), wheel_valid={n: T(b["valid"]) for n, b in a[5].items()}),
    "metrics": lambda a: ppaxos.metrics(T(a[0]), _pcfg(a[1])),
}


@pytest.mark.parametrize("carry", CARRIES, ids=[f"{c}-t{h}"
                                                for c, h in CARRIES])
@pytest.mark.parametrize("name", sorted(PORT))
def test_call_matches_jax(recorded, carry, name):
    args, want = recorded[carry][name]
    with torch.inference_mode():
        got = PORT[name](args)
    assert_tree_equal(want, got, name)


def test_recorded_calls_do_work(recorded):
    """The harvested carries reach the branches that matter: commits at
    the tally, and forced phase-1 wins that rewrite the log."""
    commits = sum(int(np.sum(rec["tally_p2b"][1][1]))
                  for rec in recorded.values())
    assert commits > 0
    rewrites = sum(
        int(np.sum(rec["merge_forced"][1]["log_cmd"]
                   != rec["merge_forced"][0][0]["log_cmd"]))
        for rec in recorded.values())
    assert rewrites > 0


# ---- elementwise primitives on random inputs ----------------------------

RNG_SEEDS = [0, 1, 2]


@pytest.mark.parametrize("seed", RNG_SEEDS)
@pytest.mark.parametrize("n_keys", [16, 7])
def test_fib_key(seed, n_keys):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2 ** 31, 2 ** 31, (64,), dtype=np.int64)
    x = np.concatenate([x, [-2 ** 31, 2 ** 31 - 1, 0, -1]]).astype(np.int32)
    assert_tree_equal(jfib(jnp.asarray(x), n_keys),
                      pfib(torch.from_numpy(x), n_keys))


@pytest.mark.parametrize("seed", RNG_SEEDS)
@pytest.mark.parametrize("nbits", [3, 5, 31])
def test_popcount(seed, nbits):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** nbits, (5, 8), dtype=np.int64).astype(np.int32)
    assert_tree_equal(jax.lax.population_count(jnp.asarray(x)),
                      pballot.popcount(torch.from_numpy(x), nbits))


@pytest.mark.parametrize("seed", RNG_SEEDS)
def test_cell_helpers(seed):
    rng = np.random.default_rng(seed)
    S = 16
    base = rng.integers(0, 200, (5, G)).astype(np.int32)
    slot = (base + rng.integers(-4, 20, (5, G))).astype(np.int32)
    new_base = (base + rng.integers(0, 20, (5, G))).astype(np.int32)
    plane = rng.integers(0, 99, (5, S, G)).astype(np.int32)
    J, P = jnp.asarray, torch.from_numpy
    assert_tree_equal(jcell.cell_abs(J(base), S), pcell.cell_abs(P(base), S))
    assert_tree_equal(jcell.cell_onehot(J(slot), S),
                      pcell.cell_onehot(P(slot), S))
    assert_tree_equal(jcell.in_window(J(slot), J(base), S),
                      pcell.in_window(P(slot), P(base), S))
    assert_tree_equal(
        jcell.advance_clear(J(plane), J(base), J(new_base), 0),
        pcell.advance_clear(P(plane), P(base), P(new_base), 0))


@pytest.mark.parametrize("seed", RNG_SEEDS)
def test_ring_helpers(seed):
    rng = np.random.default_rng(seed)
    R, S = 5, 16
    field = rng.integers(-50, 50, (R, R, G)).astype(np.int32)
    idx = rng.integers(0, R, (R, G)).astype(np.int32)
    x3 = rng.integers(-50, 50, (R, S, G)).astype(np.int32)
    xb = rng.random((R, S, G)) < 0.5
    J, P = jnp.asarray, torch.from_numpy
    assert_tree_equal(jring.pick_src(J(field), J(idx)),
                      pring.pick_src(P(field), P(idx)))
    for x in (x3, xb, field[0]):
        assert_tree_equal(jring.take_replica(J(x), J(idx)),
                          pring.take_replica(P(x), P(idx)))


def test_require_packable():
    pring.require_packable(31)
    with pytest.raises(ValueError):
        pring.require_packable(32)
