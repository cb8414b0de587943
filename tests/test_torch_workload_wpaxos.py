"""Workload runs of the port's lane-major wpaxos kernel against JAX
``make_run``, exactly (every state plane, metric and violation count):
the five named specs fault-free and zipf99 and flash fuzzed, at 8 groups
x 48 steps (flash's first surge starts at 30, migrate's epoch at 40), on
the reference's small workload grid (6 replicas in 2 zones, 8 objects over
16 keys); the seeded wpaxos_thinq1 twin under zipf99; the per-class split;
and the reference's skew contrast on the bench_all.py grid (9 replicas, 16
objects over 32 keys): zipf99 steals at least 10 more objects than its
uniform control."""

import pytest

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402

from _torch_parity import assert_tree_equal  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.sim import make_run as jax_make_run  # noqa: E402
from paxi_tpu.workload import compile as jwlc  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch import workload as pwl  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, make_run  # noqa: E402
from paxi_tpu_torch.sim import simulate  # noqa: E402
from paxi_tpu_torch.workload import compile as pwlc  # noqa: E402

SMALL = dict(n_replicas=6, n_zones=2, n_slots=8, n_keys=16, n_objects=8,
             steal_threshold=3, locality=0.8)
# bench_all.py's wpaxos_grid cell
GRID = dict(n_replicas=9, n_zones=3, n_slots=16, n_keys=32, n_objects=16,
            steal_threshold=4, locality=0.8)
FUZZ = dict(p_drop=0.1, max_delay=3)
G, T, SEED = 8, 48, 0
RUNS = [(name, False) for name in jwlc.NAMED] + [("zipf99", True),
                                                   ("flash", True)]


def _runs(proto, name, fuzzed):
    fz = FUZZ if fuzzed else {}
    j = jax_make_run(jax_protocol(proto),
                     JCfg(**SMALL).with_(workload=jwlc.named_workload(name)),
                     JFuzz(**fz))(jr.PRNGKey(SEED), G, T)
    p = make_run(sim_protocol(proto),
                 SimConfig(**SMALL).with_(workload=pwlc.named_workload(name)),
                 FuzzConfig(**fz), device="cpu")(tr.PRNGKey(SEED), G, T)
    return jax.device_get(j), p


@pytest.mark.parametrize("name,fuzzed", RUNS)
def test_wpaxos_workload_run_equals_jax(name, fuzzed):
    j, p = _runs("wpaxos", name, fuzzed)
    assert_tree_equal(j, p, f"wpaxos {name}")
    state, metrics, viol = p
    assert int(viol) == 0 and int(metrics["inscan_violations"]) == 0
    assert int(metrics["committed_slots"]) > 0
    assert sum(int(metrics[f"wl_{c}_n"]) for c in pwl.CLASSES) \
        == int(metrics["commit_lat_n"])
    split = pwl.class_split(state)
    assert int(metrics["wl_hot_n"]) == split["hot"]["n"]


def test_thinq1_workload_run_equals_jax():
    j, p = _runs("wpaxos_thinq1", "zipf99", True)
    assert_tree_equal(j, p, "wpaxos_thinq1 zipf99")


def test_skew_drives_object_stealing():
    steals = {}
    for wl in ("uniform", "zipf99"):
        cfg = pwl.apply_workload(SimConfig(**GRID), pwlc.named_workload(wl))
        r = simulate(sim_protocol("wpaxos"), cfg, 8, 120, seed=0,
                     device="cpu")
        assert int(r.violations) == 0, wl
        steals[wl] = int(r.metrics["steals"])
    assert steals["zipf99"] >= steals["uniform"] + 10, steals
