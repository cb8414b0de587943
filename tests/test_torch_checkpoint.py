"""The port's checkpoints (paxi_tpu_torch.sim.checkpoint) and
``continue_run`` against the JAX package's, exactly: a carry saved by
either package loads in the other under the same archive keys, and
resuming it there equals resuming it in the saver (carry, state, metrics,
violations); a run split at any step equals the straight run; the carry
advances in place; bad files are refused."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_tree_equal, to_np  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import checkpoint as jck  # noqa: E402
from paxi_tpu.sim import runner as jrun  # noqa: E402
from paxi_tpu_torch import convert  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import (FuzzConfig, SimConfig,  # noqa: E402
                                continue_run, load_carry, make_run,
                                save_carry)
from paxi_tpu_torch.sim import checkpoint as pck  # noqa: E402
from paxi_tpu_torch.sim.runner import init_carry  # noqa: E402

CASES = {
    "paxos": (dict(n_replicas=5, n_slots=16), 8),
    "wpaxos": (dict(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
                    steal_threshold=2, locality=0.3), 4),
}
FUZZ = dict(p_drop=0.1, max_delay=3)
SEED, T0, MORE = 2, 13, 10


def _port(name):
    cfg_kw, g = CASES[name]
    return sim_protocol(name), SimConfig(**cfg_kw), FuzzConfig(**FUZZ), g


def _jax(name):
    cfg_kw, g = CASES[name]
    return jax_protocol(name), JCfg(**cfg_kw), JFuzz(**FUZZ), g


def _jax_carry_at(name, t0):
    proto, cfg, fuzz, g = _jax(name)
    carry = jrun.init_carry(proto, cfg, fuzz, g, jr.PRNGKey(SEED))
    _, carry = jrun.continue_run(proto, cfg, carry, 0, t0, fuzz)
    return carry


def _compare(jres, jcarry, pres, pcarry):
    assert_tree_equal(jax.device_get(jcarry), convert.carry_to_numpy(pcarry),
                      "carry")
    assert_tree_equal(to_np(dict(jres.state)), pres.state, "state")
    assert_tree_equal(to_np(dict(jres.metrics)), pres.metrics, "metrics")
    assert_tree_equal(jres.violations, pres.violations, "violations")


@pytest.mark.parametrize("name", CASES)
def test_reference_checkpoint_resumes_in_the_port(name, tmp_path):
    jproto, jcfg, jfuzz, g = _jax(name)
    proto, cfg, fuzz, _ = _port(name)
    jcarry = _jax_carry_at(name, T0)
    jck.save_carry(str(tmp_path / "j"), jcarry, {"step": T0})
    like = init_carry(proto, cfg, fuzz, g, tr.PRNGKey(0), "cpu")
    pcarry, meta = load_carry(str(tmp_path / "j"), like)
    assert meta == {"step": T0, "layout_version": pck.LAYOUT_VERSION}
    pres, pcarry = continue_run(proto, cfg, pcarry, T0, MORE, fuzz)
    jres, jcarry = jrun.continue_run(jproto, jcfg, jcarry, T0, MORE, jfuzz)
    _compare(jres, jcarry, pres, pcarry)


@pytest.mark.parametrize("name", CASES)
def test_port_checkpoint_resumes_in_the_reference(name, tmp_path):
    jproto, jcfg, jfuzz, g = _jax(name)
    proto, cfg, fuzz, _ = _port(name)
    pcarry = init_carry(proto, cfg, fuzz, g, tr.PRNGKey(SEED), "cpu")
    _, pcarry = continue_run(proto, cfg, pcarry, 0, T0, fuzz)
    save_carry(str(tmp_path / "p.npz"), pcarry, {"step": T0})
    like = jrun.init_carry(jproto, jcfg, jfuzz, g, jr.PRNGKey(0))
    jcarry, meta = jck.load_carry(str(tmp_path / "p.npz"), like)
    assert meta["step"] == T0
    # the same archive keys as the reference writes for the same carry
    jck.save_carry(str(tmp_path / "j"), jcarry)
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != pck._META_KEY:
                assert_tree_equal(b[k], a[k], k)
    jres, jcarry = jrun.continue_run(jproto, jcfg, jcarry, T0, MORE, jfuzz)
    pres, pcarry = continue_run(proto, cfg, pcarry, T0, MORE, fuzz)
    _compare(jres, jcarry, pres, pcarry)


@pytest.fixture(scope="module")
def straight():
    proto, cfg, fuzz, g = _port("paxos")
    return make_run(proto, cfg, fuzz, device="cpu")(tr.PRNGKey(SEED), g, 24)


@pytest.mark.parametrize("split", [0, 1, 7, 16, 23, 24])
def test_split_run_equals_the_straight_run(straight, split, tmp_path):
    proto, cfg, fuzz, g = _port("paxos")
    carry = init_carry(proto, cfg, fuzz, g, tr.PRNGKey(SEED), "cpu")
    first, carry = continue_run(proto, cfg, carry, 0, split, fuzz)
    save_carry(str(tmp_path / "c"), carry)
    carry, _ = load_carry(str(tmp_path / "c"),
                          init_carry(proto, cfg, fuzz, g, tr.PRNGKey(9),
                                     "cpu"))
    res, _ = continue_run(proto, cfg, carry, split, 24 - split, fuzz)
    state, metrics, viols = straight
    assert_tree_equal(state, res.state, "state")
    for k, v in metrics.items():
        want = int(v)
        if k.startswith("net_"):       # flow counters are per segment
            want -= int(first.metrics[k])
        assert int(res.metrics[k]) == want, k
    assert int(res.violations) + int(first.violations) == int(viols)


def test_continue_run_advances_the_carry_in_place():
    proto, cfg, fuzz, g = _port("paxos")
    carry = init_carry(proto, cfg, fuzz, g, tr.PRNGKey(SEED), "cpu")
    planes = [carry[0]["ballot"], carry[1]["p2a"].planes, carry[3]]
    ptrs = [p.data_ptr() for p in planes]
    res, out = continue_run(proto, cfg, carry, 0, 5, fuzz)
    assert out is carry
    assert [p.data_ptr() for p in planes] == ptrs
    want = make_run(proto, cfg, fuzz, device="cpu")(tr.PRNGKey(SEED), g, 5)
    assert_tree_equal(want[0]["ballot"], torch.movedim(carry[0]["ballot"],
                                                       -1, 0), "ballot")
    # the result's state is a copy: advancing the carry leaves it alone
    before = res.state["ballot"].clone()
    continue_run(proto, cfg, carry, 5, 5, fuzz)
    assert torch.equal(before, res.state["ballot"])


def test_load_refuses_bad_files(tmp_path):
    proto, cfg, fuzz, g = _port("paxos")
    carry = init_carry(proto, cfg, fuzz, g, tr.PRNGKey(SEED), "cpu")
    save_carry(str(tmp_path / "old"), carry, {"layout_version": 1})
    with pytest.raises(ValueError, match="incompatible"):
        load_carry(str(tmp_path / "old"), carry)
    save_carry(str(tmp_path / "c"), carry)
    wide = init_carry(proto, cfg, fuzz, g + 1, tr.PRNGKey(SEED), "cpu")
    with pytest.raises(ValueError, match="shape"):
        load_carry(str(tmp_path / "c"), wide)
    other = init_carry(sim_protocol("sdpaxos"),
                       SimConfig(n_replicas=5, n_slots=16), fuzz, g,
                       tr.PRNGKey(SEED), "cpu")
    with pytest.raises(KeyError, match="missing"):
        load_carry(str(tmp_path / "c"), other)
