"""The port's sliding-window ring helpers (paxi_tpu_torch/sim/ring.py)
against the JAX package's sim/ring.py on seeded numpy planes, exactly:
``shift_window`` and ``shift_deps`` with advances inside, at the end of
and past the window (and negative ones), ``diag2`` and ``dst_major``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.sim import ring as jring  # noqa: E402

from _torch_parity import assert_tree_equal  # noqa: E402
from paxi_tpu_torch.sim import ring as pring  # noqa: E402

R, S, G = 5, 16, 8
SEEDS = [0, 1, 2]
# advance ranges: inside the window, up to and past its end, negative
ADVANCES = {"inside": (0, S // 2), "past_end": (S - 2, 2 * S + 3),
            "negative": (-S - 2, 3)}
J, P = jnp.asarray, torch.from_numpy


def _planes(rng):
    return {
        "int32": rng.integers(-99, 99, (R, R, S, G)).astype(np.int32),
        "bool": rng.random((R, R, S, G)) < 0.5,
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("advance", ADVANCES)
def test_shift_window(seed, advance):
    rng = np.random.default_rng(seed)
    lo, hi = ADVANCES[advance]
    adv = rng.integers(lo, hi, (R, R, G)).astype(np.int32)
    for kind, plane in _planes(rng).items():
        fill = False if kind == "bool" else -7
        assert_tree_equal(jring.shift_window(J(plane), J(adv), fill),
                          pring.shift_window(P(plane), P(adv), fill), kind)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("advance", ADVANCES)
def test_shift_deps(seed, advance):
    rng = np.random.default_rng(seed)
    lo, hi = ADVANCES[advance]
    adv = rng.integers(lo, hi, (R, R, G)).astype(np.int32)
    deps = rng.integers(-1, 200, (R, R, S, R, G)).astype(np.int32)
    assert_tree_equal(jring.shift_deps(J(deps), J(adv)),
                      pring.shift_deps(P(deps), P(adv)))
    assert_tree_equal(jring.shift_deps(J(deps), J(adv), 5),
                      pring.shift_deps(P(deps), P(adv), 5))


@pytest.mark.parametrize("seed", SEEDS)
def test_shift_window_one_advance_per_plane(seed):
    """An advance plane with fewer lead axes than the shifted plane
    broadcasts over the missing ones, as ``take_along_axis`` does."""
    rng = np.random.default_rng(seed)
    adv = rng.integers(0, S + 2, (R, G)).astype(np.int32)
    plane = rng.integers(-9, 9, (R, S, G)).astype(np.int32)
    assert_tree_equal(jring.shift_window(J(plane), J(adv), 0),
                      pring.shift_window(P(plane), P(adv), 0))


@pytest.mark.parametrize("seed", SEEDS)
def test_diag2_and_dst_major(seed):
    rng = np.random.default_rng(seed)
    for shape in ((R, R, G), (R, R, S, G), (R, R, S, R, G)):
        x = rng.integers(-99, 99, shape).astype(np.int32)
        assert_tree_equal(jring.diag2(J(x)), pring.diag2(P(x)), str(shape))
    x = rng.random((R, R, G)) < 0.5
    assert_tree_equal(jring.diag2(J(x)), pring.diag2(P(x)), "bool")
    assert_tree_equal(jring.dst_major(J(x)), pring.dst_major(P(x)))


def test_diag2_is_a_copy():
    """diag2 returns a fresh tensor: writing it leaves the state plane
    alone."""
    x = torch.zeros((R, R, G), dtype=torch.int32)
    d = pring.diag2(x)
    d += 1
    assert int(x.abs().sum()) == 0
