"""The EPaxos execution block's wrappers (paxi_tpu_torch/ops/exec_graph.py)
on the CPU: CPU tensors take the plain versions and launch nothing, the
launch wrappers refuse bad arguments before any launch, the plain masks'
``needed`` equals the step's formula after its execution window, the
tilings stay inside a block's shared memory at every width, and a Python
model of both kernels' index arithmetic (csrc/exec_graph.cu: tiles of
consecutive groups, chunks from a 16-byte unit, word chunks of the bits)
equals the plain versions.  The kernels themselves are held against the
plain versions on the card in tests/test_torch_kernels_gpu.py."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from paxi_tpu_torch.ops import exec_graph as xg
from paxi_tpu_torch.ops.closure import closure_plain

CU = Path(xg.__file__).resolve().parent / "csrc" / "exec_graph.cu"
# simbench's readers match kernels by these substrings (trace.kernel_us,
# stages.NAMED): a new kernel holding one would be read as another
MATCHED = ("closure_kernel", "closure_block_kernel", "deliver_kernel",
           "insert_kernel")


def _inputs(seed, R, I, G, p_commit=0.7, p_exec=0.3):
    """Deps below, inside and above the window and absent, random masks."""
    rng = np.random.default_rng(seed)
    NN = R * I
    base = rng.integers(0, 50, (R, R, G)).astype(np.int32)
    rel = rng.integers(-3, I + 3, (R, NN, R, G))
    deps = (base[:, None, :, :] + rel).astype(np.int32)
    deps[rng.random(deps.shape) < 0.2] = -1
    committed = rng.random((R, NN, G)) < p_commit
    executed = committed & (rng.random((R, NN, G)) < p_exec)
    return (torch.from_numpy(deps), torch.from_numpy(base),
            torch.from_numpy(committed), torch.from_numpy(executed))


def _block(seed, R, I, G):
    deps, base, committed, executed = _inputs(seed, R, I, G)
    adj, fblock = xg.dep_graph_plain(deps, base, committed)
    return deps, base, committed, executed, adj, fblock, closure_plain(adj)


def test_cpu_tensors_take_the_plain_versions():
    deps, base, committed, executed, adj, fblock, reach = _block(1, 3, 4, 5)
    xg.reset_launches()
    a2, f2 = xg.dep_graph(deps, base, committed)
    ok, need = xg.exec_masks(reach, committed, fblock, executed)
    assert xg.dep_graph.launches == xg.exec_masks.launches == 0
    assert torch.equal(a2, adj) and torch.equal(f2, fblock)
    want = xg.exec_masks_plain(reach, committed, fblock, executed)
    assert torch.equal(ok, want[0]) and torch.equal(need, want[1])
    assert adj.shape == (3 * 5, 12, 12) and adj.is_contiguous()
    assert ok.shape == need.shape == (3, 12, 5)


@pytest.mark.parametrize("R, I, G", [(5, 4, 6), (3, 8, 4), (2, 2, 8)])
def test_needed_from_executed_equals_the_window_formula(R, I, G):
    """The step's ``any_i(committed & ~new_exec & reach[i, j]) &
    ~committed[j]`` for new executions drawn from ``exec_ok`` equals the
    plain masks' ``needed``, taken with ``executed``."""
    deps, base, committed, executed, adj, fblock, reach = _block(R * I, R,
                                                                 I, G)
    ok, need = xg.exec_masks_plain(reach, committed, fblock, executed)
    assert ok.any() and need.any()
    cube = torch.movedim(reach.reshape(R, G, R * I, R * I), 1, -1)
    gen = torch.Generator().manual_seed(G)
    for keep in (0.0, 0.5, 1.0):
        new_exec = executed | (ok & (torch.rand(ok.shape, generator=gen)
                                     < keep))
        src_live = committed & ~new_exec
        want = torch.any(src_live[:, :, None, :] & cube, dim=1) & ~committed
        assert torch.equal(need, want), keep


def test_launch_wrappers_refuse_bad_arguments():
    deps, base, committed, executed, adj, fblock, reach = _block(2, 3, 4, 5)
    xg.reset_launches()
    with pytest.raises(TypeError):
        xg.dep_graph_launch(deps.to(torch.int64), base, committed)
    with pytest.raises(TypeError):
        xg.dep_graph_launch(deps, base, committed.to(torch.uint8))
    with pytest.raises(ValueError, match="must be"):
        xg.dep_graph_launch(deps, base[:, :2], committed)
    with pytest.raises(ValueError, match="R, R\\*I, R, G"):
        xg.dep_graph_launch(deps[:, :11], base, committed)
    with pytest.raises(ValueError, match="contiguous"):
        xg.dep_graph_launch(deps, base.transpose(0, 1).contiguous()
                            .transpose(0, 1), committed)
    with pytest.raises(ValueError, match="CUDA"):
        xg.dep_graph_launch(deps, base, committed)
    with pytest.raises(TypeError):
        xg.exec_masks_launch(reach.to(torch.uint8), committed, fblock,
                             executed)
    with pytest.raises(ValueError, match="must be"):
        xg.exec_masks_launch(reach[1:], committed, fblock, executed)
    with pytest.raises(ValueError, match="contiguous"):
        xg.exec_masks_launch(reach, committed, fblock,
                             executed.transpose(1, 2).contiguous()
                             .transpose(1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        xg.exec_masks_launch(reach, committed, fblock, executed)
    assert xg.dep_graph.launches == xg.exec_masks.launches == 0


def test_kernel_names_avoid_the_matched_substrings():
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                       CU.read_text())
    assert sorted(names) == ["dep_graph_kernel", "exec_masks_kernel"]
    assert not [n for n in names for m in MATCHED if m in n]


@pytest.mark.parametrize("nn", [1, 16, 31, 33, 80, 130, 256, 320, 384,
                                385, 512, 1_000, 1_500, 2_048, 4_096])
def test_tilings_fit_shared_memory(nn):
    g = xg.graph_tiling(nn)
    assert g.chunk % 16 == 0 and 16 <= g.chunk <= xg.GRAPH_TILE
    assert g.groups & (g.groups - 1) == 0 and g.groups <= xg.TILE_MAX
    if g.groups > 1 or nn * nn + 16 <= g.chunk:     # a tile in one chunk
        assert g.groups * nn * nn + 16 <= g.chunk
    m = xg.mask_tiling(nn)
    w = -(-nn // 32)
    assert 1 <= m.words <= w and m.stride % 2 == 1 and m.stride >= m.words
    assert m.shmem == xg.mask_smem(nn, m.groups, m.staged, m.stride)
    assert m.shmem <= xg.SMEM_LIMIT
    assert m.groups == 1 or m.shmem <= xg.MASK_SMEM


def test_tilings_at_the_main_path_widths():
    """Tiles of 16 and 4 groups at 80 nodes; the CLI's 320 and 384 read
    where they lie, every word at once; 512 eleven words a chunk, 1,500
    three; 16,000 nodes at most (a 256 MB graph)."""
    assert xg.graph_tiling(80) == (16, 102_416)
    assert xg.mask_tiling(80) == (4, True, 3, 3, 35_360)
    assert xg.graph_tiling(384) == (1, xg.GRAPH_CHUNK)
    assert xg.mask_tiling(384)[:3] == (1, False, 12)
    assert xg.mask_tiling(320)[:3] == (1, False, 10)
    assert xg.mask_tiling(256)[:3] == (2, False, 8)
    assert xg.mask_tiling(512)[:3] == (1, False, 11)
    assert xg.mask_tiling(1_500)[:3] == (1, False, 3)
    assert xg.mask_tiling(16_000).words == 1
    with pytest.raises(ValueError, match="16,000|no tiling"):
        xg.mask_tiling(20_000)


# ---- a Python model of the kernels' index arithmetic -----------------------

def _wrap_sub(a, b):
    return int(np.int64(a) - np.int64(b) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _dep_graph_model(deps, base, committed, groups, chunk, offset):
    """dep_graph_kernel block by block on a byte buffer whose tensor starts
    ``offset`` bytes past a 16-byte unit: tiles, chunks from the tile's
    unit, the rows of a chunk group-fastest, fblock where a row starts;
    every byte the blocks leave unwritten stays 7."""
    deps, base, committed = deps.numpy(), base.numpy(), committed.numpy()
    R, NN, _, G = deps.shape
    I, nn2 = NN // R, NN * NN
    buf = np.full(offset + R * G * nn2 + 16, 7, np.uint8)
    fb = np.full((R, NN, G), 7, np.uint8)
    per_r = -(-G // groups)
    for blk in range(R * per_r):
        r, g0 = blk // per_r, (blk % per_r) * groups
        tg = min(groups, G - g0)
        t0 = offset + (r * G + g0) * nn2
        t1 = t0 + tg * nn2
        for c in range(t0 & ~15, t1, chunk):
            lo, hi = max(c, t0), min(c + chunk, t1)
            smem = np.zeros(chunk, np.uint8)
            row_lo, row_hi = (lo - t0) // NN, (hi - 1 - t0) // NN
            gl_lo, gl_hi = row_lo // NN, row_hi // NN
            one = gl_lo == gl_hi
            i_lo, i_hi = (row_lo % NN, row_hi % NN) if one else (0, NN - 1)
            ngl, ni = gl_hi - gl_lo + 1, i_hi - i_lo + 1
            for t in range(ngl * ni):
                gl, i = gl_lo + t % ngl, i_lo + t // ngl
                row = gl * NN + i
                if row < row_lo or row > row_hi:
                    continue
                g = g0 + gl
                row_at, f = t0 + row * NN, False
                for q in range(R):
                    tgt = int(deps[r, i, q, g])
                    if tgt < 0:
                        continue
                    rel = _wrap_sub(tgt, base[r, q, g])
                    if rel >= I:
                        f = True
                    elif rel >= 0 and committed[r, i, g]:
                        a = row_at + q * I + rel
                        if lo <= a < hi:
                            smem[a - c] = 1
                if row_at >= lo:
                    fb[r, i, g] = f
            buf[lo:hi] = smem[lo - c:hi - c]
    out = buf[offset:offset + R * G * nn2].reshape(R * G, NN, NN)
    return torch.from_numpy(out.copy()), torch.from_numpy(fb)


def _bits(b):
    """uint8 0/1 ``[..., n]`` as uint32 words ``[..., ceil(n/32)]``."""
    n = b.shape[-1]
    w = -(-n // 32)
    pad = np.zeros(b.shape[:-1] + (32 * w,), np.uint64)
    pad[..., :n] = b
    return (pad.reshape(b.shape[:-1] + (w, 32))
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


_KEEP = np.array([0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333,
                  0x55555555], np.uint32)


def _transpose32(x):
    """The kernel's transpose32 over a warp's 32 lanes (``x[lane]``)."""
    lanes = np.arange(32)
    for lvl in range(5):
        j, m = 16 >> lvl, _KEEP[lvl]
        y = x[lanes ^ j]
        x = np.where(lanes & j, (x & ~m) | ((y & ~m) >> j),
                     (x & m) | ((y & m) << j)).astype(np.uint32)
    return x


def _row_words4(src, w):
    """Row words from 4-byte loads: each byte pair of bits by the
    kernel's multiply, 8 loads a word."""
    n = src.shape[-1]
    out = np.zeros(src.shape[:-1] + (w,), np.uint32)
    quads = src.reshape(src.shape[:-1] + (n // 4, 4)).astype(np.uint64)
    x = (quads << (8 * np.arange(4, dtype=np.uint64))).sum(-1)
    nib = ((x * 0x01020408) & 0xFFFFFFFF) >> 24
    for q in range(n // 4):
        out[..., q // 8] |= (nib[..., q] << (4 * (q % 8))).astype(np.uint32)
    return out


def _exec_masks_model(reach, committed, fblock, executed, groups, words):
    """exec_masks_kernel block by block: a tile's plane bits, then each
    chunk of ``words`` words: row words (4-byte loads where rows lie on
    4-byte boundaries, else bits of 32 consecutive bytes), column words
    (32 x 32 blocks of row words transposed in a warp when the chunk holds
    every word, else 32 rows of a column), three ORs a node into its
    accumulators; the masks from the accumulators."""
    reach = reach.numpy()
    cm_all, fb_all, ex_all = (x.numpy().astype(np.uint8)
                              for x in (committed, fblock, executed))
    R, NN, G = cm_all.shape
    W = -(-NN // 32)
    ok = np.full((R, NN, G), 7, np.uint8)
    need = np.full((R, NN, G), 7, np.uint8)
    per_r = -(-G // groups)
    for blk in range(R * per_r):
        r, g0 = blk // per_r, (blk % per_r) * groups
        for g in range(g0, min(g0 + groups, G)):
            src = reach[r * G + g]
            cm, fb, ex = cm_all[r, :, g], fb_all[r, :, g], ex_all[r, :, g]
            vcm, vfb, vex = _bits(cm), _bits(fb), _bits(ex)
            acc = np.zeros((3, NN), bool)
            all_rows = _row_words4(src, W) if NN % 4 == 0 else _bits(src)
            for w0 in range(0, W, words):
                nw = min(words, W - w0)
                rows = all_rows[:, w0:w0 + nw]
                if nw == W:
                    pad = np.zeros((32 * W, W), np.uint32)
                    pad[:NN] = all_rows
                    cols = np.zeros((32 * W, W), np.uint32)
                    for wr in range(W):
                        for wb in range(W):
                            cols[32 * wb:32 * wb + 32, wr] = _transpose32(
                                pad[32 * wr:32 * wr + 32, wb])
                    cols = cols[:NN]
                else:
                    cols = _bits(np.ascontiguousarray(src.T))[:, w0:w0 + nw]
                sl = slice(w0, w0 + nw)
                acc[0] |= (rows & (~vcm[sl] | vfb[sl])).any(-1)
                acc[1] |= (rows & ~cols & ~vex[sl]).any(-1)
                acc[2] |= (cols & vcm[sl] & ~vex[sl]).any(-1)
            blocked = acc[0] | (fb != 0)
            ready = (cm != 0) & ~blocked & (ex == 0)
            ok[r, :, g] = ready & ~acc[1]
            need[r, :, g] = (cm == 0) & acc[2]
    return torch.from_numpy(ok.astype(bool)), torch.from_numpy(
        need.astype(bool))


@pytest.mark.parametrize("R, I, G, groups, chunk, offset", [
    (5, 4, 13, 4, 1_616, 0),          # 80-byte rows' peers, a ragged tile
    (3, 3, 7, 2, 176, 9),             # odd offset: tiles start mid-unit
    (2, 5, 5, 1, 48, 3),              # chunks of 48 bytes cut every graph
    (1, 7, 3, 8, 64, 15),             # one owner, a tile past G
    (3, 11, 2, 1, 32, 0),             # rows wider than a chunk
])
def test_dep_graph_model_equals_plain(R, I, G, groups, chunk, offset):
    deps, base, committed, _ = _inputs(R * 100 + I, R, I, G)
    want = xg.dep_graph_plain(deps, base, committed)
    got = _dep_graph_model(deps, base, committed, groups, chunk, offset)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("R, I, G, groups, words", [
    (5, 4, 13, 8, 1), (5, 16, 9, 4, 3), (3, 16, 5, 2, 2), (2, 33, 3, 1, 1),
    (1, 70, 2, 1, 3), (3, 11, 4, 2, 2),
])
def test_exec_masks_model_equals_plain(R, I, G, groups, words):
    deps, base, committed, executed, adj, fblock, reach = _block(
        R + I, R, I, G)
    want = xg.exec_masks_plain(reach, committed, fblock, executed)
    got = _exec_masks_model(reach, committed, fblock, executed, groups,
                            words)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert want[0].any() and want[1].any()
