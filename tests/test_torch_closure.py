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


# ---- a numpy model of the CUDA kernel's algorithm (csrc/closure.cu) -------

def _stage_bytes(n):
    return (32 * n + 32 + 15) & ~15


def _nib_of(words):
    """Bytes 0/1 of each uint32 as four bits (the kernel's multiply)."""
    return ((words.astype(np.uint64) * 0x01020408) & 0xFFFFFFFF) >> 24


def _bytes_of(nibs):
    """Four bits as four bytes 0/1 of a uint32 (the kernel's multiply)."""
    return ((nibs.astype(np.uint64) & 0xF) * 0x00204081) & 0x01010101


def _kernel_model(flat, base, b, n, out_base):
    """The kernel on ``b`` graphs of ``n`` nodes whose bytes start at byte
    ``base`` of the uint8 buffer ``flat``; returns the output bytes, laid
    out from byte ``out_base`` of a fresh buffer.  Mirrors the kernel step
    by step: a slot s holds rows 32s + lane; each chunk (a slot's rows) is
    staged as the 16-byte aligned window around it and read at its offset,
    a word a ballot over 32 consecutive bytes (general), or, for N = 16
    mod 32 at aligned offsets, a lane turning its own row's 16-byte pieces
    into bits by multiplies (row vectors); Warshall broadcasts row k from
    lane k % 32, slot k // 32, and every row with bit k ORs it in; the
    bytes go back through a buffer at the output's offset modulo 16."""
    w = -(-n // 32)
    nn, chunk = n * n, 32 * n
    row_vec = n % 32 == 16 and base % 16 == 0 and out_base % 16 == 0
    if row_vec:   # 8 lanes' 16-byte accesses a row apart: distinct banks
        assert len({(lane * n) % 128 for lane in range(8)}) == 8
    lanes = np.arange(32)
    lane_bit = np.left_shift(np.uint32(1), lanes.astype(np.uint32))
    out = np.zeros(out_base + b * nn + 16, np.uint8)
    for g in range(b):
        rows = np.zeros((w, 32, w), np.uint32)          # [slot, lane, word]
        for s in range(w):
            src = base + g * nn + s * chunk
            nrows = min(32, n - 32 * s)
            stage = np.zeros(_stage_bytes(n), np.uint8)
            a0, a1 = src & ~15, (src + nrows * n + 15) & ~15
            assert a1 - a0 <= _stage_bytes(n) and (a1 - a0) % 16 == 0
            stage[:a1 - a0] = flat[a0:a1]
            buf = stage[src & 15:]
            if row_vec:
                for lane_l in range(nrows):
                    row = buf[lane_l * n:(lane_l + 1) * n]
                    nibs = _nib_of(row.view("<u4"))
                    for j in range(n // 16):
                        bits = (nibs[4 * j] | nibs[4 * j + 1] << 4
                                | nibs[4 * j + 2] << 8 | nibs[4 * j + 3] << 12)
                        rows[s, lane_l, j >> 1] |= np.uint32(
                            int(bits) << (16 * (j & 1)))
                continue
            for lane_l in range(nrows):
                for v in range(w):
                    col = v * 32 + lanes
                    pred = (col < n) & (buf[lane_l * n
                                            + np.minimum(col, n - 1)] != 0)
                    rows[s, lane_l, v] = np.bitwise_or.reduce(
                        np.where(pred, lane_bit, np.uint32(0)))
        for s in range(w):
            for lane_l in range(min(32, n - 32 * s)):
                rk = rows[s, lane_l].copy()       # w shuffles from lane k % 32
                has_k = (rows[:, :, s] >> np.uint32(lane_l)) & np.uint32(1)
                rows |= np.where(has_k[..., None] == 1, rk, np.uint32(0))
        for s in range(w):
            dst = out_base + g * nn + s * chunk
            nrows = min(32, n - 32 * s)
            length, off = nrows * n, dst & 15
            ob = np.zeros(_stage_bytes(n), np.uint8)
            assert off + length <= ob.size
            for lane_l in range(nrows):
                if row_vec:
                    halves = [(rows[s, lane_l, j >> 1] >> np.uint32(
                        16 * (j & 1))) for j in range(n // 16)]
                    words = np.array([_bytes_of(np.uint64(h) >> np.uint64(q))
                                      for h in halves for q in (0, 4, 8, 12)],
                                     dtype="<u4")
                    ob[off + lane_l * n:off + (lane_l + 1) * n] = \
                        words.view(np.uint8)
                    continue
                for v in range(w):
                    col = v * 32 + lanes
                    bits = (rows[s, lane_l, v] >> lanes.astype(np.uint32)) & 1
                    keep = col < n
                    ob[off + lane_l * n + col[keep]] = bits[keep]
            head = min((16 - off) & 15, length)
            nvec = (length - head) >> 4
            assert (dst + head) % 16 == 0 or nvec == 0
            assert (off + head) % 16 == 0 or nvec == 0
            out[dst:dst + length] = ob[off:off + length]
    return out[out_base:out_base + b * nn].reshape(b, n, n).astype(bool)


MODEL_SIZES = [1, 2, 16, 31, 32, 33, 48, 80, 130, 256]


def _model_equals_plain(a, base=0, out_base=0):
    b, n, _ = a.shape
    flat = np.zeros(base + a.size + 16, np.uint8)
    flat[base:base + a.size] = a.reshape(-1)
    got = _kernel_model(flat, base, b, n, out_base)
    want = pclosure.closure_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", MODEL_SIZES)
@pytest.mark.parametrize("p", [0.02, 0.3])
def test_kernel_model_equals_plain_on_random_graphs(n, p, aligned):
    """At aligned offsets N = 16 mod 32 takes the row vectors, at odd ones
    (and every other N) the general path."""
    a = _graphs(1000 + n, 3 if n < 200 else 2, n, p)
    _model_equals_plain(a, base=0 if aligned else 1 + (n * 7) % 15,
                        out_base=0 if aligned else (n * 3) % 16)


def test_bit_byte_multiplies_on_every_nibble():
    """The kernel's two multiplies are exact on every 4-bit value."""
    nib = np.arange(16, dtype=np.uint64)
    as_bytes = _bytes_of(nib)
    want = sum(((nib >> i) & 1) << (8 * i) for i in range(4))
    np.testing.assert_array_equal(as_bytes, want)
    np.testing.assert_array_equal(_nib_of(as_bytes), nib)


@pytest.mark.parametrize("n", MODEL_SIZES)
def test_kernel_model_on_empty_full_loops_and_cycles(n):
    empty = np.zeros((1, n, n), bool)
    full = np.ones((1, n, n), bool)
    loops = np.eye(n, dtype=bool)[None]
    ring = np.roll(np.eye(n, dtype=bool), 1, axis=1)[None]   # i -> i + 1
    a = np.concatenate([empty, full, loops, ring])
    got = _model_equals_plain(a, base=1, out_base=5)
    np.testing.assert_array_equal(_model_equals_plain(a), got)
    assert not got[0].any() and got[1].all()
    np.testing.assert_array_equal(got[2], loops[0])      # only self-loops
    assert got[3].all()                                  # one cycle: all


@pytest.mark.parametrize("n", [33, 80])
def test_kernel_model_equals_pallas_interpret(n):
    a = _graphs(300 + n, 2, n, 0.05)
    want = np.asarray(jclosure.closure_pallas(jnp.asarray(a),
                                              interpret=True))
    np.testing.assert_array_equal(_model_equals_plain(a, base=3), want)


def test_kernel_model_at_an_odd_offset():
    """``adj_big[1:]`` for N = 5 starts 25 bytes into its storage."""
    big = _graphs(5, 9, 5, 0.3)
    flat = np.zeros(big.size + 16, np.uint8)
    flat[:big.size] = big.reshape(-1)
    got = _kernel_model(flat, 25, 8, 5, 0)
    np.testing.assert_array_equal(
        got, pclosure.closure_plain(torch.from_numpy(big[1:])).numpy())
