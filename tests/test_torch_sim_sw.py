"""The port's frozen sliding-window kernels (``protocols/*/sim_sw.py``).

- Against JAX: each twin's run on the CPU equals the JAX package's
  ``sim_sw`` run bit for bit, at ``tests/test_fixed_cell_equiv.py``'s
  shapes (6 groups x 80 steps, seed 11, drops and delays): every state
  plane, every metric including the ``net_*`` counters, the violations,
  the in-scan violations and the state hash; and each twin's per-group
  invariants on a mid-run pair of states (forwards, and backwards, where
  ballots fall and commits vanish) equal the reference's.
- Inside the port: each fixed-cell kernel (``sim.py``) equals its twin
  after ``cell.canonical_state_np``: the port's own fixed-cell proof, with
  the reference's one exception, ``commit_lat_n`` of the deferred-flush
  kernels (paxos, sdpaxos), which the fixed cells can only raise.  The
  partition/crash and long-horizon pairs are ``slow``, as in the
  reference.
- Units: ``window_view_np`` and ``canonical_state_np`` against the
  reference's.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from _torch_parity import assert_tree_equal, to_np  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import make_run as jax_make_run  # noqa: E402
from paxi_tpu.sim import runner as jrun  # noqa: E402
from paxi_tpu.sim import cell as jcell  # noqa: E402
from paxi_tpu.trace.replay import state_hash as jax_state_hash  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch.profiling import SW_TWINS, resolve_kernel  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run  # noqa: E402
from paxi_tpu_torch.sim import cell, runner  # noqa: E402
from paxi_tpu_torch.trace.replay import state_hash  # noqa: E402

# test_fixed_cell_equiv.py's shapes: small, and the ring still recycles
CFG = {
    "paxos": dict(n_replicas=3, n_slots=16),
    "sdpaxos": dict(n_replicas=3, n_slots=16),
    "wankeeper": dict(n_replicas=6, n_zones=3, n_slots=16),
    "wpaxos": dict(n_replicas=6, n_zones=3, n_slots=8, n_objects=4),
    "bpaxos": dict(n_replicas=7, n_slots=16),
}
KERNELS = sorted(CFG)
# the deferred-flush kernels whose pending-plane sample count may differ
PENDING_PLANE = {"paxos", "sdpaxos"}
DROP = dict(p_drop=0.2, max_delay=2)
HEAVY = dict(p_partition=0.3, p_crash=0.2, max_delay=2, window=12)
G, T, SEED = 6, 80, 11


def _jax_sw(name):
    return importlib.import_module(f"paxi_tpu.protocols.{name}.sim_sw") \
        .PROTOCOL


def _planes(name):
    return tuple(resolve_kernel(name + "_sw").init_state(
        SimConfig(**CFG[name]), None, 1, device="cpu"))


_CACHE = {}


def _runs_cache():
    """{kernel: (JAX (state, metrics, violations), port's)} at the
    reference's DROP pair, the port's on the CPU; built once."""
    if not _CACHE:
        for name in KERNELS:
            js, jm, jv = jax_make_run(_jax_sw(name), JCfg(**CFG[name]),
                                      JFuzz(**DROP))(jr.PRNGKey(SEED), G, T)
            ps, pm, pv = make_run(resolve_kernel(name + "_sw"),
                                  SimConfig(**CFG[name]), FuzzConfig(**DROP),
                                  device="cpu")(tr.PRNGKey(SEED), G, T)
            _CACHE[name] = (to_np((dict(js), dict(jm), jv)),
                            to_np((ps, pm, pv)))
    return _CACHE


@pytest.fixture(scope="module")
def runs():
    return _runs_cache()


# ---- against JAX ------------------------------------------------------------

def test_twins_named_and_unregistered():
    assert sorted(SW_TWINS) == KERNELS
    for name in KERNELS:
        proto = resolve_kernel(name + "_sw")
        assert proto.name == _jax_sw(name).name == name + "_sw"
        assert proto.batched
        with pytest.raises(KeyError):
            sim_protocol(name + "_sw")
        # the same exchange as the fixed-cell kernel
        cfg = SimConfig(**CFG[name])
        assert proto.mailbox_spec(cfg) == sim_protocol(name).mailbox_spec(cfg)
    with pytest.raises(KeyError):
        resolve_kernel("epaxos_sw")


@pytest.mark.parametrize("name,plane", [(n, p) for n in KERNELS
                                        for p in _planes(n)])
def test_state_plane_equals_jax(runs, name, plane):
    j, p = runs[name]
    assert sorted(j[0]) == sorted(p[0])
    assert_tree_equal(j[0][plane], p[0][plane], f"{name}.{plane}")


@pytest.mark.parametrize("name", KERNELS)
def test_metrics_equal_jax(runs, name):
    j, p = runs[name]
    assert sorted(j[1]) == sorted(p[1])
    assert any(k.startswith("net_") for k in p[1])
    for k in j[1]:
        assert_tree_equal(j[1][k], p[1][k], f"{name}.{k}")
    assert int(p[1]["committed_slots"]) > 0


@pytest.mark.parametrize("name", KERNELS)
def test_violations_and_hash_equal_jax(runs, name):
    j, p = runs[name]
    assert_tree_equal(j[2], p[2], "violations")
    assert int(p[2]) == 0
    assert int(j[1]["inscan_violations"]) == int(p[1]["inscan_violations"]) \
        == 0
    assert jax_state_hash(j[0]) == state_hash(p[0])


@pytest.mark.parametrize("name", KERNELS)
def test_group_invariants_equal_jax(name):
    """The port's per-group invariants on its carries before and after a
    mid-run step, and backwards, against the reference's
    ``per_group_invariants`` over the JAX ``sim_sw``; their sum is the
    port's ``invariants``."""
    proto, cfg = resolve_kernel(name + "_sw"), SimConfig(**CFG[name])
    fuzz = FuzzConfig(**DROP)
    body = runner.make_scan_body(proto, cfg, fuzz)
    with torch.inference_mode():
        carry = runner.init_carry(proto, cfg, fuzz, G, tr.PRNGKey(1), "cpu")
        for t in range(30):
            carry, _ = body(carry, t)
        new, _ = body(carry, 30)
    old, new = carry[0], new[0]
    for a, b in ((old, new), (new, old)):
        got = proto.group_invariants(a, b, cfg)
        want = jrun.per_group_invariants(
            _jax_sw(name), JCfg(**CFG[name]),
            {k: jnp.asarray(v.numpy()) for k, v in a.items()},
            {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        assert got.shape == (G,)
        assert_tree_equal(want, got, name)
        assert int(torch.sum(got)) == int(proto.invariants(a, b, cfg))
    assert int(torch.sum(proto.group_invariants(new, old, cfg))) > 0


# ---- inside the port: the fixed-cell kernel against its twin ----------------

def assert_port_equivalent(name, fuzz_kw, steps=T, seed=SEED):
    cfg = SimConfig(**CFG[name])
    fuzz = FuzzConfig(**fuzz_kw)
    sw = make_run(resolve_kernel(name + "_sw"), cfg, fuzz, device="cpu")(
        tr.PRNGKey(seed), G, steps)
    fc = make_run(sim_protocol(name), cfg, fuzz, device="cpu")(
        tr.PRNGKey(seed), G, steps)
    assert int(sw[2]) == int(fc[2]) == 0
    c_sw = {k: v.numpy() for k, v in sw[0].items() if not k.startswith("m_")}
    c_fc = cell.canonical_state_np(name, fc[0])
    assert sorted(c_sw) == sorted(c_fc)
    for k in c_sw:
        assert np.array_equal(c_sw[k], c_fc[k]), f"{name}: plane {k}"
    assert state_hash(c_sw) == state_hash(c_fc)
    assert sorted(sw[1]) == sorted(fc[1])
    for k in sw[1]:
        if k == "commit_lat_n" and name in PENDING_PLANE:
            assert int(fc[1][k]) >= int(sw[1][k])
            continue
        assert int(sw[1][k]) == int(fc[1][k]), f"{name}: metric {k}"
    assert int(fc[1]["committed_slots"]) > 0


@pytest.mark.parametrize("name", KERNELS)
def test_port_fixed_cell_equals_sw_drop(name):
    assert_port_equivalent(name, DROP)


@pytest.mark.slow
@pytest.mark.parametrize("name", KERNELS)
def test_port_fixed_cell_equals_sw_partition_crash(name):
    assert_port_equivalent(name, HEAVY, steps=120, seed=7)


@pytest.mark.slow
@pytest.mark.parametrize("name", KERNELS)
def test_port_fixed_cell_equals_sw_long_horizon(name):
    assert_port_equivalent(name, {}, steps=200, seed=3)


# ---- units -----------------------------------------------------------------

@pytest.mark.parametrize("lead", [(3, 2), (2, 3, 4)])
def test_window_view_matches_reference(lead):
    rng = np.random.default_rng(len(lead))
    S = 8
    base = rng.integers(0, 100, size=lead).astype(np.int32)
    plane = rng.integers(-5, 1000, size=lead + (S,)).astype(np.int32)
    want = jcell.window_view_np(plane, base)
    got = cell.window_view_np(torch.from_numpy(plane), torch.from_numpy(base))
    np.testing.assert_array_equal(want, got)
    assert got.dtype == want.dtype
    # a permutation: scattering the window back gives the plane
    back = np.zeros_like(plane)
    for i in np.ndindex(*lead):
        for j in range(S):
            back[i][(base[i] + j) % S] = got[i][j]
    np.testing.assert_array_equal(back, plane)


def test_ring_planes_match_reference():
    assert cell.RING_PLANES == jcell.RING_PLANES


@pytest.mark.parametrize("name", KERNELS)
def test_canonical_state_matches_reference(name):
    """The port's canonicalizer on a fixed-cell run's state equals the
    reference's on the same (numpy) state."""
    ps, _, _ = make_run(sim_protocol(name), SimConfig(**CFG[name]),
                        FuzzConfig(**DROP), device="cpu")(
        tr.PRNGKey(SEED), G, 40)
    got = cell.canonical_state_np(name, ps)
    want = jcell.canonical_state_np(name, to_np(ps))
    assert sorted(got) == sorted(want)
    assert not any(k.startswith("m_") for k in got)
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
