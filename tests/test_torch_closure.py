"""The port's transitive closure (paxi_tpu_torch/ops/closure.py) against
the JAX package's ``closure_xla`` and its Pallas kernel ``closure_pallas``
run in interpret mode (as tests/test_closure.py runs it), exactly, on
seeded numpy graphs.  On the CPU ``transitive_closure`` takes the plain
version and launches nothing; the CUDA kernel itself is held against the
plain version in tests/test_torch_kernels_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.ops import closure as jclosure  # noqa: E402

from _torch_parity import assert_tree_equal  # noqa: E402
from paxi_tpu_torch.ops import closure as pclosure  # noqa: E402

SIZES = [5, 23, 80, 130]
DENSITIES = [0.02, 0.1]


def _graphs(seed, b, n, p):
    return np.random.default_rng(seed).random((b, n, n)) < p


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("p", DENSITIES)
def test_plain_matches_closure_xla(n, p):
    a = _graphs(n, 6, n, p)
    assert_tree_equal(jclosure.closure_xla(jnp.asarray(a)),
                      pclosure.closure_plain(torch.from_numpy(a)))


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_pallas_interpret(n):
    a = _graphs(100 + n, 3, n, 0.1)
    want = np.asarray(jclosure.closure_pallas(jnp.asarray(a),
                                              interpret=True))
    assert_tree_equal(want, pclosure.closure_plain(torch.from_numpy(a)))


@pytest.mark.parametrize("n", [1, 2, 3, 64, 128, 129, 256])
def test_n_iter_formula(n):
    assert pclosure._n_iter(n) == jclosure._n_iter(n)
    assert 2 ** pclosure._n_iter(n) >= n     # every path length reached


def test_chain_and_cycle():
    """0->1->2->3 chain plus a 2-cycle {4, 5}: reach follows the chain one
    way only, and only cycle members reach themselves."""
    a = np.zeros((1, 6, 6), bool)
    for i in range(3):
        a[0, i, i + 1] = True
    a[0, 4, 5] = a[0, 5, 4] = True
    got = pclosure.transitive_closure(torch.from_numpy(a))[0].numpy()
    assert got[0, 3] and got[1, 3] and not got[3, 0]
    assert got[4, 4] and got[5, 5]
    assert not np.diagonal(got)[:4].any()
    assert_tree_equal(jclosure.closure_xla(jnp.asarray(a))[0], got)


def test_padding_neutral_at_130():
    """N = 130 is no multiple of 128 (the Pallas kernel pads to 256): the
    port pads nothing and both agree."""
    a = np.zeros((2, 130, 130), bool)
    a[:, 0, 129] = True
    a[:, 129, 64] = True
    got = pclosure.transitive_closure(torch.from_numpy(a)).numpy()
    assert got[:, 0, 64].all() and not got[:, 64, :].any()
    want = np.asarray(jclosure.closure_pallas(jnp.asarray(a),
                                              interpret=True))
    assert_tree_equal(want, got)


def test_lead_axes_and_cpu_dispatch():
    """bool[..., N, N] with two lead axes (the EPaxos (R, G) batch) goes
    through the plain version on the CPU and launches no kernel."""
    a = _graphs(7, 6, 17, 0.1).reshape(2, 3, 17, 17)
    pclosure.reset_launches()
    got = pclosure.transitive_closure(torch.from_numpy(a))
    assert pclosure.transitive_closure.launches == 0
    assert got.shape == (2, 3, 17, 17) and got.dtype == torch.bool
    assert_tree_equal(jclosure.closure_xla(jnp.asarray(a)), got)


def test_launch_rejects_cpu_and_bad_arguments():
    a = torch.zeros((2, 5, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        pclosure.closure_launch(a)
    with pytest.raises(ValueError):
        pclosure.closure_launch(torch.zeros((2, 5, 4), dtype=torch.bool))
    assert pclosure.transitive_closure.launches == 0
