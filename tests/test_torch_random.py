"""The port's PRNG (paxi_tpu_torch/random.py) against jax.random, bit for
bit, on the calls and shapes the sim path makes."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.random as jr  # noqa: E402

from paxi_tpu_torch import random as tr  # noqa: E402

SEEDS = [0, 1, 7, 2 ** 31 - 1]
R, G = 5, 8
SHAPES = [(R, G), (R, R, G), (G,)]


def _pair(seed):
    k = jr.PRNGKey(seed)
    tk = tr.PRNGKey(seed)
    return k, tk


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    k, tk = _pair(seed)
    np.testing.assert_array_equal(np.asarray(k).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [2, 3, 4, 15])
def test_split(seed, n):
    k, tk = _pair(seed)
    np.testing.assert_array_equal(np.asarray(jr.split(k, n)).astype(np.int64),
                                  tr.split(tk, n).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    k, tk = _pair(seed)
    np.testing.assert_array_equal(
        np.asarray(jr.fold_in(k, 17)).astype(np.int64),
        tr.fold_in(tk, 17).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain(seed):
    """Keys several splits deep, as the runner's per-step chain makes."""
    k, tk = _pair(seed)
    for _ in range(5):
        k = jr.split(k, 4)[0]
        tk = tr.split(tk, 4)[0]
    np.testing.assert_array_equal(np.asarray(k).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("lo,hi", [(0, 9), (1, 2), (1, 4)])
def test_randint(seed, shape, lo, hi):
    """[0, backoff + 1) for election jitter, [1, d + 1) for delays."""
    k, tk = _pair(seed)
    _eq(jr.randint(k, shape, lo, hi), tr.randint(tk, shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_bernoulli(seed, shape, p):
    k, tk = _pair(seed)
    _eq(jr.bernoulli(k, p, shape), tr.bernoulli(tk, p, shape))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed):
    k, tk = _pair(seed)
    _eq(jr.uniform(k, (R, R, G)), tr.uniform(tk, (R, R, G)))


def test_seed_outside_int32_raises():
    with pytest.raises(ValueError):
        tr.PRNGKey(2 ** 31)
