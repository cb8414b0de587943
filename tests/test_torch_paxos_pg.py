"""The per-group layout against the JAX package's, exactly:

- the port's ``random`` calls over a batch of keys against ``jax.vmap`` of
  the JAX calls (split, fold_in, bits, randint, bernoulli, uniform; scalar
  and shaped draws);
- ``sim/mailbox_pg.py`` (wheel, delivery, fault state, edge faults, live
  mask, insert) against ``jax.vmap`` of ``paxi_tpu/sim/mailbox.py``'s
  per-group functions on numpy-seeded planes and keys;
- ``paxos_pg`` runs against JAX ``make_run`` of ``paxos_pg`` (every state
  plane, metric and violation count): fault-free, under drops, delays,
  partitions and crashes, under the wan3z scenario, and under zipf99 and
  flash fuzzed (16 groups x 48 steps);
- the record and pinned runs of ``paxos_pg`` against the reference's, a
  JAX capture replayed by the port to its hash and counters,
  ``continue_run`` split mid-run equal to the straight run, and a JAX
  checkpoint of a per-group carry resumed in the port."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_tree_equal, key_to_torch  # noqa: E402
from paxi_tpu import scenarios as jscn  # noqa: E402
from paxi_tpu import trace as jtr  # noqa: E402
from paxi_tpu.metrics import lathist as jlathist  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import mailbox as jmb  # noqa: E402
from paxi_tpu.sim import runner as jrun  # noqa: E402
from paxi_tpu.workload import compile as jwlc  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch import scenarios as pscn  # noqa: E402
from paxi_tpu_torch import trace as ptr  # noqa: E402
from paxi_tpu_torch.metrics import lathist  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, runner  # noqa: E402
from paxi_tpu_torch.sim import mailbox_pg as mbpg  # noqa: E402
from paxi_tpu_torch.trace.format import schedule_hash  # noqa: E402
from paxi_tpu_torch.workload import compile as pwlc  # noqa: E402

PAXOS = dict(n_replicas=3, n_slots=16, n_keys=64)
MIXED = dict(p_drop=0.15, max_delay=3, p_dup=0.05, p_partition=0.2,
             p_crash=0.1, window=8)
FUZZ = dict(p_drop=0.1, max_delay=3)
G, T = 16, 48


def _keys(seed: int, n: int):
    jk = jr.split(jr.PRNGKey(seed), n)
    return jk, key_to_torch(jk)


def _eq(want, got, what):
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if a.dtype == np.uint32:
        a, b = a.astype(np.int64), b.astype(np.int64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# ---- batched keys ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(), (1,), (3,), (4, 5)])
def test_batched_draws_equal_vmap(shape):
    jk, pk = _keys(11, 7)
    _eq(jax.vmap(lambda k: jr.bits(k, shape))(jk),
        tr.random_bits(pk, shape), "bits")
    _eq(jax.vmap(lambda k: jr.randint(k, shape, 0, 9))(jk),
        tr.randint(pk, shape, 0, 9), "randint")
    _eq(jax.vmap(lambda k: jr.randint(k, shape, 1, 4))(jk),
        tr.randint(pk, shape, 1, 4), "randint 1..3")
    for p in (0.0, 0.1, 0.5, 1.0):
        _eq(jax.vmap(lambda k: jr.bernoulli(k, p, shape))(jk),
            tr.bernoulli(pk, p, shape), f"bernoulli {p}")
    _eq(jax.vmap(lambda k: jr.uniform(k, shape))(jk),
        tr.uniform(pk, shape), "uniform")


def test_batched_keys_equal_vmap():
    jk, pk = _keys(3, 5)
    for n in (1, 2, 4, 9):
        _eq(jax.vmap(lambda k: jr.split(k, n))(jk), tr.split(pk, n),
            f"split {n}")
    for d in (0, 1, 17, 0x9AD, 2 ** 31 - 1):
        _eq(jax.vmap(lambda k: jr.fold_in(k, d))(jk), tr.fold_in(pk, d),
            f"fold_in {d}")
    # a batch of batches, and the single key unchanged
    jk2 = jax.vmap(lambda k: jr.split(k, 3))(jk)
    _eq(jax.vmap(jax.vmap(lambda k: jr.randint(k, (2,), 0, 5)))(jk2),
        tr.randint(key_to_torch(jk2), (2,), 0, 5), "nested randint")
    _eq(jr.split(jk[0], 3), tr.split(pk[0], 3), "single split")
    _eq(jr.fold_in(jk[0], 5), tr.fold_in(pk[0], 5), "single fold_in")


# ---- the per-group mailbox ---------------------------------------------------

SPEC = {"p1a": ("bal",), "p2a": ("bal", "slot", "cmd")}
N = 5


def _outbox(seed: int, g: int):
    rng = np.random.default_rng(seed)
    out = {}
    for name, fields in SPEC.items():
        box = {"valid": rng.random((g, N, N)) < 0.6}
        for f in fields:
            box[f] = rng.integers(-9, 99, (g, N, N)).astype(np.int32)
        out[name] = box
    return out


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


FUZZES = {
    "fault_free": {},
    "mixed": MIXED,
    "perm": dict(p_drop=0.2, max_delay=2, perm_crash=1, perm_crash_at=3),
    "wan3z": dict(p_drop=0.05, scenario="wan3z"),
}


def _fz(kw, jax_side: bool):
    kw = dict(kw)
    scn = kw.pop("scenario", None)
    if jax_side:
        return JFuzz(**kw, scenario=None if scn is None else jscn.NAMED[scn])
    return FuzzConfig(**kw,
                      scenario=None if scn is None else pscn.NAMED[scn])


@pytest.mark.parametrize("label", FUZZES)
def test_mailbox_steps_equal_vmapped_reference(label):
    g = 6
    n = 9 if label == "wan3z" else N
    jf, pf = _fz(FUZZES[label], True), _fz(FUZZES[label], False)
    jw = jax.vmap(lambda _: jmb.empty_wheel(SPEC, n, jf))(np.arange(g))
    pw = mbpg.empty_wheel(SPEC, n, g, pf, device="cpu")
    assert_tree_equal(jw, pw, "empty wheel")
    jfs = jax.vmap(lambda _: jmb.fault_state_init(n))(np.arange(g))
    pfs = mbpg.fault_state_init(n, g, device="cpu")
    assert_tree_equal(jfs, pfs, "fault state")
    rng = np.random.default_rng(len(label))
    # the window-8 refreshes at 0 and 8, and the steps around them
    for t in (0, 1, 2, 7, 8, 9):
        ob = _outbox(100 * len(label) + t, g) if n == N else {
            name: {k: np.resize(v, (g, n, n)) for k, v in box.items()}
            for name, box in _outbox(t, g).items()}
        jk, pk = _keys(int(rng.integers(0, 2 ** 31)), g)
        jkf, pkf = _keys(int(rng.integers(0, 2 ** 31)), g)
        jinb, jw = jax.vmap(jmb.wheel_deliver)(jw)
        pinb, pw = mbpg.wheel_deliver(pw)
        assert_tree_equal(jinb, pinb, f"inbox t={t}")
        jfs = jax.vmap(lambda f, k: jmb.fault_state_refresh(
            f, k, t, jf, n))(jfs, jkf)
        pfs = mbpg.fault_state_refresh(pfs, pkf, t, pf, n)
        assert_tree_equal(jfs, pfs, f"fault state t={t}")
        jfaults = jax.vmap(lambda k, o: jmb.draw_edge_faults(k, o, jf))(
            jk, ob)
        pob = _torch_tree(ob)
        pfaults = mbpg.draw_edge_faults(pk, pob, pf)
        assert_tree_equal(jfaults, pfaults, f"faults t={t}")
        _eq(jax.vmap(lambda f: jmb.live_mask(f, 2, n))(jfs),
            mbpg.live_mask(pfs, n), f"live t={t}")
        jw = jax.vmap(lambda w, o, f, fa: jmb.wheel_insert(
            w, o, f, jf, fa))(jw, ob, jfs, jfaults)
        pw = mbpg.wheel_insert(pw, pob, pfs, pf, pfaults)
        assert_tree_equal(jw, pw, f"wheel t={t}")


def test_flush_pending_equals_vmapped_reference():
    rng = np.random.default_rng(4)
    st = {"m_commit_dt": rng.integers(0, 3000, (7, 3, 16)).astype(np.int32),
          "m_lat_hist": rng.integers(0, 9, (7, lathist.N_BUCKETS))
          .astype(np.int32)}
    st["m_commit_dt"][rng.random((7, 3, 16)) < 0.5] = 0
    want = jax.vmap(jlathist.flush_pending)(st)
    assert_tree_equal(want, lathist.flush_pending_pg(_torch_tree(st)),
                      "flush")


# ---- paxos_pg runs against the reference -------------------------------------

PG_RUNS = {
    "fault_free": ({}, None),
    "mixed": (MIXED, None),
    "wan3z": (dict(p_drop=0.05, scenario="wan3z"), None),
    "zipf99_fuzzed": (FUZZ, "zipf99"),
    "flash_fuzzed": (FUZZ, "flash"),
}


def _cfgs(wl):
    j, p = JCfg(**PAXOS), SimConfig(**PAXOS)
    if wl is not None:
        j = j.with_(workload=jwlc.named_workload(wl))
        p = p.with_(workload=pwlc.named_workload(wl))
    return j, p


@pytest.mark.parametrize("label", PG_RUNS)
def test_paxos_pg_run_equals_jax(label):
    fz, wl = PG_RUNS[label]
    jc, pc = _cfgs(wl)
    want = jrun.make_run(jax_protocol("paxos_pg"), jc, _fz(fz, True))(
        jr.PRNGKey(5), G, T)
    got = runner.make_run(sim_protocol("paxos_pg"), pc, _fz(fz, False),
                          device="cpu")(tr.PRNGKey(5), G, T)
    assert_tree_equal(jax.device_get(want), got, label)
    state, metrics, viol = got
    assert int(viol) == 0 and int(metrics["inscan_violations"]) == 0
    assert int(metrics["committed_slots"]) > 0
    assert state["execute"].shape == (G, PAXOS["n_replicas"])


def test_per_group_metrics_sum_to_the_run_metrics():
    proto, cfg = sim_protocol("paxos_pg"), _cfgs("zipf99")[1]
    state, metrics, _ = runner.make_run(proto, cfg, FuzzConfig(**FUZZ),
                                        device="cpu")(tr.PRNGKey(2), 6, 30)
    per_group = proto.metrics(state, cfg)
    for k, v in per_group.items():
        assert v.shape == (6,) and v.dtype == torch.int32, k
        assert int(v.sum()) == int(metrics[k]), k
    assert lathist.total_hist({k: v.numpy() for k, v in state.items()}) \
        .sum() == int(metrics["commit_lat_n"])


def test_record_and_pinned_runs_equal_the_reference():
    jc, pc = _cfgs("zipf99")
    jf, pf = JFuzz(**MIXED), FuzzConfig(**MIXED)
    want = jrun.make_recorded_run(jax_protocol("paxos_pg"), jc, jf)(
        jr.PRNGKey(8), 8, 30)
    got = runner.make_recorded_run(sim_protocol("paxos_pg"), pc, pf,
                                   device="cpu")(tr.PRNGKey(8), 8, 30)
    assert_tree_equal(jax.device_get(want), got, "record")
    sched = jax.tree.map(lambda x: np.asarray(x[:, 3]), jax.device_get(
        want[4]))
    jp = jrun.make_pinned_run(jax_protocol("paxos_pg"), jc, jf, 3)(
        jr.PRNGKey(8), 8, jax.tree.map(np.asarray, sched))
    pp = runner.make_pinned_run(sim_protocol("paxos_pg"), pc, pf, 3,
                                device="cpu")(tr.PRNGKey(8), 8, sched)
    assert_tree_equal(jax.device_get(jp), pp, "pinned")
    # an unedited record pins to the plain run
    assert_tree_equal(got[:3], pp[:3], "pinned == recorded")


def test_jax_capture_replays_in_the_port(tmp_path):
    jc, pc = _cfgs("flash")
    jt = jtr.capture(jax_protocol("paxos_pg"), jc, JFuzz(**MIXED), seed=6,
                     n_groups=6, n_steps=30, group=4, proto_name="paxos_pg")
    path = jtr.save(str(tmp_path / "pg"), jt)
    pt = ptr.load(path)
    cfg = pt.sim_config()
    assert cfg == pc and hash(cfg) == hash(pc)
    r = ptr.replay(pt, device="cpu")
    assert r.state_hash == jt.meta["capture_state_hash"]
    assert r.counters == jt.meta["capture_counters"]
    assert r.lat_hist == jt.meta["capture_lat_hist"]
    mine = ptr.capture(sim_protocol("paxos_pg"), pc, FuzzConfig(**MIXED),
                       seed=6, n_groups=6, n_steps=30, group=4,
                       device="cpu")
    assert schedule_hash(mine) == jt.meta["schedule_hash"]
    assert mine.meta["capture_state_hash"] == jt.meta["capture_state_hash"]


def test_continue_run_equals_the_straight_run():
    proto, cfg = sim_protocol("paxos_pg"), _cfgs("migrate")[1]
    fz = FuzzConfig(**MIXED)
    straight = runner.make_run(proto, cfg, fz, device="cpu")(
        tr.PRNGKey(9), 5, 50)
    carry = runner.init_carry(proto, cfg, fz, 5, tr.PRNGKey(9), "cpu")
    first, carry = runner.continue_run(proto, cfg, carry, 0, 20, fz)
    second, carry = runner.continue_run(proto, cfg, carry, 20, 30, fz)
    assert second.groups == 5
    assert_tree_equal(straight[0], second.state, "state")
    for k in ("committed_slots", "commit_lat_n", "wl_hot_n"):
        assert int(straight[1][k]) == int(second.metrics[k]), k
    for k in runner.COUNTER_NAMES:
        k = "net_" + k
        assert int(straight[1][k]) == int(first.metrics[k]) \
            + int(second.metrics[k]), k


def test_jax_checkpoint_of_paxos_pg_resumes_in_the_port(tmp_path):
    """A per-group carry crosses runtimes: a JAX paxos_pg checkpoint at
    step 20 loads into the port and resumes to the JAX run's carry and
    result; the port's own checkpoint round-trips."""
    from paxi_tpu.sim import save_carry as jax_save_carry
    from paxi_tpu_torch import convert
    from paxi_tpu_torch.sim import load_carry, save_carry
    jc, pc = _cfgs("zipf99")
    jf, pf = JFuzz(**MIXED), FuzzConfig(**MIXED)
    jproto, pproto = jax_protocol("paxos_pg"), sim_protocol("paxos_pg")
    carry = jrun.init_carry(jproto, jc, jf, 6, jr.PRNGKey(4))
    _, carry = jrun.continue_run(jproto, jc, carry, 0, 20, jf)
    path = str(tmp_path / "pg")
    jax_save_carry(path, carry, {"step": 20})
    want, want_carry = jrun.continue_run(jproto, jc, carry, 20, 15, jf)
    like = runner.init_carry(pproto, pc, pf, 6, tr.PRNGKey(0), "cpu")
    got_carry, meta = load_carry(path, like)
    assert meta["step"] == 20
    got, got_carry = runner.continue_run(pproto, pc, got_carry, 20, 15, pf)
    assert_tree_equal(jax.device_get(want_carry),
                      convert.carry_to_numpy(got_carry), "carry")
    assert_tree_equal(jax.device_get(want.metrics), got.metrics, "metrics")
    save_carry(str(tmp_path / "mine"), got_carry, {"step": 35})
    again, _ = load_carry(str(tmp_path / "mine"), like)
    assert_tree_equal(convert.carry_to_numpy(got_carry),
                      convert.carry_to_numpy(again), "round trip")
