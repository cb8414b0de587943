"""The port's exchange (paxi_tpu_torch/ops/exchange.py on CPU tensors,
i.e. the plain versions of the two CUDA kernels) against both JAX
exchanges: the Pallas kernels of paxi_tpu/ops/exchange.py, run in
interpret mode off-TPU as tests/test_ops_exchange.py runs them, and the
dense paxi_tpu/sim/mailbox.py pair.  Inputs are seeded numpy planes at the
paxos mailbox spec, wheel depth 1 and 3; the depth-3 case includes puts
that collide with in-flight messages."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.ops import exchange as jx  # noqa: E402
from paxi_tpu.sim import mailbox as jmb  # noqa: E402
from paxi_tpu.sim.types import FuzzConfig as JFuzz  # noqa: E402

from _torch_parity import assert_tree_equal, to_torch  # noqa: E402
from paxi_tpu_torch.ops import exchange as px  # noqa: E402
from paxi_tpu_torch.protocols.paxos.sim import mailbox_spec  # noqa: E402
from paxi_tpu_torch.sim import mailbox as pmb  # noqa: E402
from paxi_tpu_torch.sim.types import SimConfig  # noqa: E402

R, G = 5, 8
SPEC = mailbox_spec(SimConfig(n_replicas=R))
DEPTHS = [1, 3]


def _planes(rng, shape):
    out = {}
    for name, fields in SPEC.items():
        box = {"valid": rng.random(shape) < 0.5}
        for f in fields:
            box[f] = rng.integers(-1000, 1000, shape).astype(np.int32)
        out[name] = box
    return out


def _inputs(d, seed):
    """A wheel, an outbox, a fault state and fault planes (numpy)."""
    rng = np.random.default_rng(seed)
    wheel = _planes(rng, (d, R, R, G))
    outbox = _planes(rng, (R, R, G))
    fs = {"conn": rng.random((R, R, G)) < 0.8,
          "crashed": rng.random((R, G)) < 0.2}
    faults = {name: {"drop": rng.random((R, R, G)) < 0.2,
                     "delay": rng.integers(1, d + 1, (R, R, G))
                     .astype(np.int32),
                     "dup": rng.random((R, R, G)) < 0.3}
              for name in SPEC}
    return wheel, outbox, fs, faults


def _port_wheel(wheel):
    return {name: pmb.WheelBox(SPEC[name],
                               pmb.stack_box(to_torch(box), SPEC[name]))
            for name, box in wheel.items()}


def _as_planes(wheel):
    return {name: pmb.unstack_box(box.planes, box.fields)
            for name, box in wheel.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_deliver_matches_pallas_and_dense(d, seed):
    wheel, *_ = _inputs(d, seed)
    inbox, rolled = px.wheel_deliver(_port_wheel(wheel))
    got = (inbox, _as_planes(rolled))
    assert_tree_equal(jx.wheel_deliver(_jax(wheel)), got, "pallas")
    assert_tree_equal(jmb.wheel_deliver(_jax(wheel)), got, "dense")


@pytest.mark.parametrize("d", DEPTHS)
@pytest.mark.parametrize("seed", [0, 1])
def test_insert_matches_pallas_and_dense(d, seed):
    wheel, outbox, fs, faults = _inputs(d, seed)
    fuzz = JFuzz(max_delay=d)
    got = _as_planes(px.wheel_insert(_port_wheel(wheel), to_torch(outbox),
                                     to_torch(fs), to_torch(faults)))
    args = (_jax(wheel), _jax(outbox), _jax(fs), fuzz, _jax(faults))
    assert_tree_equal(jx.wheel_insert(*args), got, "pallas")
    assert_tree_equal(jmb.wheel_insert(*args), got, "dense")


@pytest.mark.parametrize("seed", [0, 1])
def test_insert_collisions_are_exercised(seed):
    """At depth 3 some puts land on occupied cells and overwrite them."""
    d = 3
    wheel, outbox, fs, faults = _inputs(d, seed)
    live = jmb.live_mask(_jax(fs), 3, R)
    hits = 0
    for name in SPEC:
        f = faults[name]
        eff = np.asarray(outbox[name]["valid"] & live) & ~f["drop"]
        for s in range(d):
            put = eff & ((f["delay"] == s + 1)
                         | (f["dup"] & (np.minimum(f["delay"] + 1, d)
                                        == s + 1)))
            hits += int(np.sum(put & wheel[name]["valid"][s]))
    assert hits > 0


@pytest.mark.parametrize("d", DEPTHS)
def test_plain_block_functions(d):
    """deliver_planes / insert_planes on one stacked block, the exact
    arguments the CUDA kernels take."""
    wheel, outbox, fs, faults = _inputs(d, 7)
    fields = SPEC["p3"]
    w = pmb.stack_box(to_torch(wheel["p3"]), fields)
    inbox, rolled = pmb.deliver_planes(w)
    assert inbox.dtype == rolled.dtype == torch.int32
    assert torch.equal(inbox, w[0])
    assert torch.equal(rolled[:d - 1], w[1:])
    assert int(rolled[d - 1].abs().sum()) == 0
    ob = pmb.stack_box(to_torch(outbox["p3"]), fields)
    f = to_torch(faults["p3"])
    eff = ob[0] != 0
    new = pmb.insert_planes(w, ob, eff, f["delay"], f["dup"])
    assert new.shape == w.shape and new.dtype == torch.int32
    assert set(torch.unique(new[:, 0]).tolist()) <= {0, 1}


def test_cpu_path_launches_no_kernel():
    wheel, outbox, fs, faults = _inputs(3, 3)
    before = (px.wheel_deliver.launches, px.wheel_insert.launches)
    w = _port_wheel(wheel)
    px.wheel_deliver(w)
    px.wheel_insert(w, to_torch(outbox), to_torch(fs), to_torch(faults))
    assert (px.wheel_deliver.launches, px.wheel_insert.launches) == before


def test_other_devices_raise():
    """A tensor that is neither on the CPU nor on a card has no path."""
    w = torch.zeros((1, 2, R, R, G), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        px.wheel_deliver({"p1a": pmb.WheelBox(("bal",), w)})
