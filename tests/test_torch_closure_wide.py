"""The closure at every width the JAX package takes, on the CPU.

The port's ``closure_plain`` against the JAX package's ``closure_xla`` and
its Pallas kernel ``closure_pallas`` (interpret mode, as
tests/test_closure.py runs it) above the warp kernel's 256 nodes, exactly;
``closure_route`` for every N from 1 to 4,096; a numpy model of the block
kernel (csrc/closure.cu ``closure_block_kernel``: bit rows, 32-node panels
closed in registers, rows ORing in the closed panel) against the plain
version; and the EPaxos path at the CLI's own widths: ``sim -algorithm
epaxos`` at its defaults (3 replicas x 128 instances, N = 384) printing
the JAX package's line, and the state at ``profile``'s 5 x 64 (N = 320)
plane for plane.  The CUDA kernel itself is held against the plain version
in tests/test_torch_kernels_gpu.py and chip_smoke.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.ops import closure as jclosure  # noqa: E402

from _torch_parity import assert_tree_equal, run_pair  # noqa: E402
from paxi_tpu_torch.ops import closure as pclosure  # noqa: E402

WIDE = [257, 288, 320, 384, 513]
DENSITIES = [0.005, 0.02]


def _graphs(seed, b, n, p):
    return np.random.default_rng(seed).random((b, n, n)) < p


@pytest.mark.parametrize("n", WIDE)
@pytest.mark.parametrize("p", DENSITIES)
def test_plain_matches_closure_xla_wide(n, p):
    a = _graphs(n, 2, n, p)
    assert_tree_equal(jclosure.closure_xla(jnp.asarray(a)),
                      pclosure.closure_plain(torch.from_numpy(a)))


@pytest.mark.parametrize("n", [320, 384])
def test_plain_matches_pallas_interpret_wide(n):
    a = _graphs(200 + n, 2, n, 0.01)
    want = np.asarray(jclosure.closure_pallas(jnp.asarray(a),
                                              interpret=True))
    assert_tree_equal(want, pclosure.closure_plain(torch.from_numpy(a)))


# ---- routing -------------------------------------------------------------

def test_route_every_width_to_4096():
    """Every N from 1 to 4,096 has a variant whose parameters the C entry
    takes (its own checks, restated), at aligned and odd offsets."""
    seen = set()
    for n in range(1, 4097):
        w = -(-n // 32)
        for offs in ((0, 0), (1, 0), (0, 5)):
            r = pclosure.closure_route(n, *offs)
            seen.add(r.variant)
            assert r.variant in pclosure.VARIANTS
            block_small = (n >= pclosure.BLOCK_FROM_N and n % 32 == 0
                           and offs == (0, 0))
            if r.variant == "warp":
                assert n <= pclosure.WARP_MAX_N and not block_small
                assert r.shmem <= pclosure.SMEM_LIMIT
                assert not r.vec or (n % 32 == 16 and offs == (0, 0))
                continue
            assert n > pclosure.WARP_MAX_N or block_small
            assert r.wp % 4 == 0 and r.wp >= 4 * -(-w // 4)
            assert 32 <= r.threads <= pclosure.BLOCK_MAX_THREADS
            assert -(-n // r.threads) <= max(3, -(-n // 512))
            assert r.threads % 32 == 0
            assert not r.vec or (n % 16 == 0 and offs == (0, 0))
            assert r.shmem <= pclosure.SMEM_LIMIT
            rows = 32 * w + pclosure.BLOCK_TABLE_ROWS    # bit rows, tables
            if r.variant == "block_smem":
                assert r.shmem >= rows * r.wp * 4
                assert (r.wp // 4) % 2 == 1      # conflict-free stride
                assert r.scratch_words == 0
            else:
                assert r.shmem == 0
                assert r.scratch_words == rows * r.wp
                assert rows * pclosure.smem_row_words(w) * 4 \
                    > pclosure.SMEM_LIMIT
    assert seen == set(pclosure.VARIANTS)


def test_route_at_the_cli_widths():
    """The sim and profile defaults (3 x 128, 5 x 64) take the block
    kernel in shared memory with the 16-byte conversion; the EPaxos
    path's 80 nodes keep the warp kernel's row vectors."""
    for n in (384, 320):
        r = pclosure.closure_route(n)
        assert (r.variant, r.vec) == ("block_smem", True)
        assert -(-n // r.threads) == 3 and r.threads == 128
    assert pclosure.closure_route(80) == pclosure.closure_route(80, 0, 0)
    assert pclosure.closure_route(80).variant == "warp"
    assert pclosure.closure_route(80).vec
    assert pclosure.closure_route(2048).variant == "block_global"
    # 224 and 256 nodes: the block kernel where it converts 16 bytes at a
    # time, else the warp kernel's general path; 240 keeps the warp
    # kernel's row vectors
    for n in (224, 256):
        assert pclosure.closure_route(n).variant == "block_smem"
        assert pclosure.closure_route(n, 1, 0).variant == "warp"
    assert pclosure.closure_route(240) == pclosure.closure_route(240, 0, 0)
    assert pclosure.closure_route(240).variant == "warp"
    assert pclosure.closure_route(240).vec
    with pytest.raises(ValueError):
        pclosure.closure_route(0)


# ---- a numpy model of the block kernel (csrc/closure.cu) -----------------

def _nib_of(words):
    return ((words.astype(np.uint64) * 0x01020408) & 0xFFFFFFFF) >> 24


def _bytes_of(nibs):
    return ((nibs.astype(np.uint64) & 0xF) * 0x00204081) & 0x01010101


def _masks(words):
    """(..., 32) uint32 masks: all ones where bit b of the word is set."""
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.where(bits == 1, np.uint32(0xFFFFFFFF), np.uint32(0))


def _chunks(w):
    """(offset, words) of the chunks a row is taken in: 4 words at a time,
    a tail of 3 as 4, of 1 or 2 as 2."""
    full = w & ~3
    out = [(off, 4) for off in range(0, full, 4)]
    if w & 3 == 3:
        out.append((full, 4))
    elif w & 3:
        out.append((full, 2))
    return out


def _block_model(flat, base, b, n, out_base):
    """The block kernel on ``b`` graphs of ``n`` nodes at byte ``base`` of
    the uint8 buffer ``flat``; the output laid out from byte ``out_base``.
    Mirrors the kernel: the route's stored rows (32 W, wp words, zero past
    the graph), the 16-byte or ballot conversion, then per panel kb D*
    (32 shuffle steps), the closed panel P from the panel's start written
    as the single-bit entries of 8 tables of 16, the tables' other entries
    (the OR of their bits' rows; entry 0 zero), every row ORing in the 8
    entries its word kb's nibbles pick (a warp whose 32 rows all have it
    zero skips), and the bytes back."""
    r = pclosure.closure_route(n, base % 16, out_base % 16)
    assert r.variant != "warp"
    w, wp, nn = -(-n // 32), r.wp, n * n
    rows = 32 * w
    assert wp >= 4 * -(-w // 4)
    for off, v in _chunks(w):
        assert off % v == 0 and off + v <= wp     # aligned, inside the row
    out = np.zeros(out_base + b * nn, np.uint8)
    lanes = np.arange(32)
    for g in range(b):
        a = flat[base + g * nn:base + (g + 1) * nn].reshape(n, n)
        bits = np.zeros((rows, wp), np.uint32)
        if r.vec:
            assert (base + g * nn) % 16 == 0
            seg = _nib_of(a.reshape(n, n // 16, 4, 4).copy()
                          .view("<u4")[..., 0])            # (n, nseg, 4)
            b16 = (seg[..., 0] | seg[..., 1] << 4 | seg[..., 2] << 8
                   | seg[..., 3] << 12).astype(np.uint32)
            if b16.shape[1] % 2:                           # lane 2m + 1 = 0
                b16 = np.concatenate([b16, np.zeros((n, 1), np.uint32)], 1)
            bits[:n, :b16.shape[1] // 2] = b16[:, 0::2] | b16[:, 1::2] << 16
        else:
            for v in range(wp):
                col = 32 * v + lanes
                ok = col < n
                pred = np.zeros((n, 32), bool)
                pred[:, ok] = a[:, col[ok]]
                bits[:n, v] = (pred.astype(np.uint64)
                               << lanes.astype(np.uint64)).sum(1)
        for kb in range(w):
            prow = bits[32 * kb:32 * kb + 32]
            d = prow[:, kb].copy()
            for L in range(32):                 # lanes update together
                dk = d[L]
                d |= np.where((d >> np.uint32(L)) & 1 == 1, dk,
                              np.uint32(0))
            m = _masks(d)                                   # (32, 32)
            tbl = np.zeros((8, 16, wp), np.uint32)   # entry 0 stays zero
            for off, v in _chunks(w):
                x = prow[:, off:off + v].copy()
                for bb in range(32):
                    x |= prow[bb, off:off + v][None] & m[:, bb, None]
                tbl[np.arange(32) // 4, 1 << (np.arange(32) % 4),
                    off:off + v] = x
            for e in range(16):
                if bin(e).count("1") < 2:
                    continue
                for off, v in _chunks(w):
                    tbl[:, e, off:off + v] = np.bitwise_or.reduce(
                        [tbl[:, 1 << j, off:off + v] for j in range(4)
                         if e >> j & 1])
            for i0 in range(0, n, 32):
                live = min(32, n - i0)
                word = bits[i0:i0 + live, kb].copy()
                if not word.any():
                    continue
                nib = (word[:, None] >> (4 * np.arange(8, dtype=np.uint32))
                       ) & 15                                # (live, 8)
                for off, v in _chunks(w):
                    x = bits[i0:i0 + live, off:off + v].copy()
                    for t in range(8):
                        x |= tbl[t, nib[:, t], off:off + v]
                    bits[i0:i0 + live, off:off + v] = x
        assert not bits[n:].any() and not bits[:, w:].any()
        o = out[out_base + g * nn:out_base + (g + 1) * nn]
        if r.vec:
            halves = (bits[:n, :, None] >> np.array([0, 16], np.uint32)) \
                & 0xFFFF                                    # (n, wp, 2)
            h = halves.reshape(n, -1)[:, :n // 16].astype(np.uint64)
            words = np.stack([_bytes_of(h >> np.uint64(q))
                              for q in (0, 4, 8, 12)], -1).astype("<u4")
            o[:] = words.reshape(n, -1).view(np.uint8).reshape(-1)
        else:
            col = np.arange(n)
            o[:] = ((bits[:n, col // 32] >> (col % 32).astype(np.uint32))
                    & 1).astype(np.uint8).reshape(-1)
    return out[out_base:].reshape(b, n, n).astype(bool)


def _model_equals_plain(a, base=0, out_base=0):
    b, n, _ = a.shape
    flat = np.zeros(base + a.size, np.uint8)
    flat[base:] = a.reshape(-1)
    got = _block_model(flat, base, b, n, out_base)
    want = pclosure.closure_plain(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(got, want)
    return got


MODEL_SIZES = [257, 288, 320, 384, 400, 450, 513]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", MODEL_SIZES)
@pytest.mark.parametrize("p", [0.004, 0.05])
def test_block_model_equals_plain_on_random_graphs(n, p, aligned):
    """Sparse graphs leave panels and whole warps' words empty; denser
    ones close into large SCCs.  At aligned offsets N = 0 mod 16 takes
    the 16-byte conversion, at odd ones (and every other N) the ballot."""
    a = _graphs(3000 + n, 2, n, p)
    _model_equals_plain(a, base=0 if aligned else 1 + (n * 7) % 15,
                        out_base=0 if aligned else (n * 3) % 16)


@pytest.mark.parametrize("p", [0.004, 0.05])
@pytest.mark.parametrize("n", [224, 256])
def test_block_model_at_224_and_256_aligned(n, p):
    """224 and 256 nodes at aligned offsets take the block kernel (the
    warp kernel's general path at odd ones)."""
    _model_equals_plain(_graphs(3000 + n, 2, n, p))


@pytest.mark.parametrize("n", [257, 320, 400])
def test_block_model_on_empty_full_loops_and_rings(n):
    eye = np.eye(n, dtype=bool)
    a = np.stack([np.zeros_like(eye), np.ones_like(eye), eye,
                  np.roll(eye, 1, axis=1),         # i -> i + 1: one cycle
                  np.roll(eye, -1, axis=1)])       # i -> i - 1: the reverse
    got = _model_equals_plain(a, base=3, out_base=7)
    assert not got[0].any() and got[1].all()
    np.testing.assert_array_equal(got[2], eye)
    assert got[3].all() and got[4].all()


def test_block_model_on_a_chain_against_the_panels():
    """A path n-1 -> n-2 -> ... -> 0 runs against the panel order: each
    step of it goes from a later panel to an earlier one, the order that
    needs every panel's closed rows."""
    n = 320
    a = np.zeros((1, n, n), bool)
    a[0, np.arange(1, n), np.arange(n - 1)] = True
    got = _model_equals_plain(a)
    np.testing.assert_array_equal(got[0], np.tril(np.ones((n, n), bool), -1))


def test_block_model_equals_pallas_interpret():
    a = _graphs(77, 2, 288, 0.01)
    want = np.asarray(jclosure.closure_pallas(jnp.asarray(a),
                                              interpret=True))
    np.testing.assert_array_equal(_model_equals_plain(a, base=5), want)


# ---- the EPaxos path at the CLI's widths ---------------------------------

@pytest.mark.parametrize("extra", [[], ["-p_drop", "0.1", "-max_delay", "3"]],
                         ids=["fault_free", "fuzzed"])
def test_sim_epaxos_at_cli_defaults(extra):
    """``sim -algorithm epaxos`` at the CLI's default replicas, window and
    keys (3 x 128 x 16: graphs of 384 nodes), 2 groups x 12 steps: the
    port's line is the JAX package's."""
    from test_torch_cli import assert_same
    (line,) = assert_same(["sim", "-algorithm", "epaxos", "-groups", "2",
                           "-steps", "12"] + extra)
    assert line["invariant_violations"] == 0
    assert line["replicas"] == 3 and line["committed_slots"] > 0


@pytest.fixture(scope="module")
def profile_width_run():
    return run_pair("epaxos", dict(n_replicas=5, n_slots=64), {}, 2, 10, 0)


def _planes():
    from paxi_tpu_torch.protocols.epaxos import sim as pepaxos
    from paxi_tpu_torch.sim import SimConfig
    return tuple(pepaxos.init_state(SimConfig(n_replicas=5, n_slots=4),
                                    None, 1, device="cpu"))


@pytest.mark.parametrize("plane", _planes())
def test_epaxos_state_at_profile_width(profile_width_run, plane):
    """The profile default's 5 replicas x 64 instances (graphs of 320
    nodes), 2 groups x 10 steps: every state plane equal."""
    j, p = profile_width_run
    assert sorted(j.state) == sorted(p.state)
    assert_tree_equal(j.state[plane], p.state[plane], plane)


def test_epaxos_metrics_at_profile_width(profile_width_run):
    j, p = profile_width_run
    assert sorted(j.metrics) == sorted(p.metrics)
    for k in j.metrics:
        assert_tree_equal(j.metrics[k], p.metrics[k], k)
    assert_tree_equal(j.violations, p.violations, "violations")
    assert int(p.violations) == 0 and int(p.metrics["executed"]) > 0
