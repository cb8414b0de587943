"""The EPaxos execution block around the closure (CUDA for Hopper).

Each round the EPaxos step (``protocols/epaxos/sim.py``) orders every
replica's committed window graph of every group in three passes:

1. ``dep_graph``: the adjacency ``A`` and ``fblock`` from the deps plane.
   A dep below the owner's window gives no edge, one inside it an edge from
   a committed source, one above it blocks the source (``fblock``).
2. ``transitive_closure(A)`` (``ops/closure.py``).
3. ``exec_masks``: ``exec_ok`` (committed, not executed, blocked by nothing
   it reaches and reaching nothing unexecuted outside its SCC) and
   ``needed`` (uncommitted and reached by committed unexecuted work: the
   recovery trigger's frontier blockers).

Layouts: deps ``(R, NN, R, G)`` int32 absolute ids (-1 none), base ``(R,
R, G)`` int32, the masks ``(R, NN, G)`` bool, and ``A`` and ``reach`` the
closure's own ``(R*G, NN, NN)`` bool, graph ``r*G + g``, so nothing is
transposed between the passes.

``dep_graph_plain`` and ``exec_masks_plain`` are the plain versions that
define the semantics.  ``dep_graph_launch`` and ``exec_masks_launch`` run
the hand-written kernels (``csrc/exec_graph.cu``), which read and write
each cube once; ``graph_tiling`` and ``mask_tiling`` pick a launch's tile
from ``NN``.  ``dep_graph`` and ``exec_masks`` dispatch by the tensor's
device and nothing else: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises.  Each counts its launches in
``dep_graph.launches`` / ``exec_masks.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from paxi_tpu_torch.ops import _build

_LIB = "exec_graph"
# consecutive groups a block takes at most (a power of two)
TILE_MAX = 32
# the graph kernel's buffer: a tile of several groups' graphs (16 at 80
# nodes: 3.06 ms at 100k groups against 3.76 at 8 and 4.81 at 32, on an
# H100 at 700 W), else chunks of a wide graph
GRAPH_TILE = 114_688
GRAPH_CHUNK = 65_536
# the masks kernel's shared memory: a tile of several groups staged (4 at
# 80 nodes: 2.16 ms at 100k groups against 2.55 at 8), else the bits of
# graphs read where they lie (384 nodes: 0.72 ms against 1.10 staged)
MASK_SMEM = 49_152
# dynamic shared memory a block may have on an H100 (227 KB)
SMEM_LIMIT = 232_448
Tensor = torch.Tensor


class GraphTiling(NamedTuple):
    """A ``dep_graph_launch``: groups a block, bytes of its buffer."""
    groups: int
    chunk: int


class MaskTiling(NamedTuple):
    """An ``exec_masks_launch``: groups a block, the graphs' bytes staged
    in shared memory or read where they lie, bit words a chunk and their
    stride (odd: lanes on consecutive nodes meet distinct banks), shared
    memory bytes."""
    groups: int
    staged: bool
    words: int
    stride: int
    shmem: int


def graph_tiling(nn: int) -> GraphTiling:
    """The most consecutive groups whose graphs of ``nn`` nodes fit
    ``GRAPH_TILE`` with a 16-byte unit to spare (their run may start
    mid-unit); a graph wider than a chunk, one group in chunks."""
    if nn < 1:
        raise ValueError(f"graphs need NN >= 1, got {nn}")
    per = nn * nn
    if per + 16 > GRAPH_CHUNK:
        return GraphTiling(1, GRAPH_CHUNK)
    tg = 1
    while tg < TILE_MAX and 2 * tg * per + 16 <= GRAPH_TILE:
        tg *= 2
    return GraphTiling(tg, (tg * per + 16 + 15) & ~15)


def mask_smem(nn: int, groups: int, staged: bool, stride: int) -> int:
    """Shared memory of the masks kernel (csrc/exec_graph.cu's layout)."""
    w = -(-nn // 32)
    stage = 16 * (-(-groups * nn * nn // 16) + 1) if staged else 0
    return stage + 8 * groups * nn * stride + 12 * groups * w \
        + 6 * groups * nn


def _odd(words: int) -> int:
    return words if words % 2 else words + 1


def mask_tiling(nn: int) -> MaskTiling:
    """Graphs of ``nn`` nodes staged while one fits ``MASK_SMEM`` with
    every word of its bits, else read where they lie, their bits as many
    words a chunk as fit; as many consecutive groups a block as fit."""
    if nn < 1:
        raise ValueError(f"graphs need NN >= 1, got {nn}")
    w = -(-nn // 32)
    staged = mask_smem(nn, 1, True, _odd(w)) <= MASK_SMEM
    wc = w
    while wc > 1 and mask_smem(nn, 1, staged, _odd(wc)) > MASK_SMEM:
        wc -= 1
    tg = 1
    while tg < TILE_MAX \
            and mask_smem(nn, 2 * tg, staged, _odd(wc)) <= MASK_SMEM:
        tg *= 2
    shmem = mask_smem(nn, tg, staged, _odd(wc))
    if shmem > SMEM_LIMIT:
        raise ValueError(f"no tiling of the masks kernel holds a word of "
                         f"bits of {nn} nodes in shared memory")
    return MaskTiling(tg, staged, wc, _odd(wc), shmem)


def dep_graph_plain(deps: Tensor, base: Tensor,
                    committed: Tensor) -> Tuple[Tensor, Tensor]:
    """``(A, fblock)`` of ``deps (R, NN, R, G)``, ``base (R, R, G)`` and
    ``committed (R, NN, G)``; ``A`` is ``(R*G, NN, NN)``."""
    R, NN, _, G = deps.shape
    I = NN // R
    dev = deps.device
    iidx = torch.arange(I, dtype=torch.int32, device=dev)
    # deps hold absolute ids: below my window -> executed here already,
    # no edge; in-window -> an edge; above -> block the source.  Owner q's
    # targets all fall in columns [q*I, (q+1)*I), so the graph is built
    # one column block per owner; only committed sources constrain.
    blocks = []
    fblock = torch.zeros((R, NN, G), dtype=torch.bool, device=dev)
    for q in range(R):
        tgt = deps[:, :, q, :]                           # (R, NN, G) abs
        rel_q = tgt - base[:, q, None, :]
        inw_q = (tgt >= 0) & (rel_q >= 0) & (rel_q < I) & committed
        fblock = fblock | ((tgt >= 0) & (rel_q >= I))
        blocks.append(inw_q[:, :, None, :]
                      & (iidx[None, None, :, None]
                         == torch.clamp(rel_q, 0, I - 1)[:, :, None, :]))
    A = torch.cat(blocks, dim=2)                         # (R, NN, NN, G)
    del blocks
    # the closure takes contiguous (batch, N, N) matrices: the group axis
    # moves next to the replica axis
    return torch.movedim(A, -1, 1).contiguous().reshape(R * G, NN, NN), \
        fblock


def exec_masks_plain(reach: Tensor, committed: Tensor, fblock: Tensor,
                     executed: Tensor) -> Tuple[Tensor, Tensor]:
    """``(exec_ok, needed)``, each ``(R, NN, G)``, of the closed graphs
    ``reach (R*G, NN, NN)`` and the ``(R, NN, G)`` masks.

    ``needed`` is the step's ``any_i(committed & ~new_exec & reach[i, j])
    & ~committed[j]``, with ``executed`` in place of ``new_exec``: an
    instance that reaches an uncommitted one is blocked, so not in
    ``exec_ok``, so the step's execution window leaves it as ``executed``
    had it; the two give the same bits."""
    R, NN, G = committed.shape
    reach = torch.movedim(reach.reshape(R, G, NN, NN), 1, -1)
    # an above-window dep blocks every instance that can reach it, not
    # just its direct source
    blocked = torch.any(reach & (~committed | fblock)[:, None, :, :],
                        dim=2) | fblock
    ready = committed & ~blocked & ~executed
    # cross-SCC reach: reach & ~(reach & reach^T) == reach & ~reach^T
    exec_ok = ready & ~torch.any(reach & ~reach.transpose(1, 2)
                                 & ~executed[:, None, :, :], dim=2)
    # a cell is "needed" when committed-unexecuted work reaches it and it
    # is not committed: exactly the frontier blockers
    src_live = committed & ~executed
    needed = torch.any(src_live[:, :, None, :] & reach, dim=1) & ~committed
    return exec_ok, needed


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.paxi_dep_graph.argtypes = [p, p, p, p, p, i32, i32, i64, i32, i32, p]
    lib.paxi_dep_graph.restype = i32
    lib.paxi_exec_masks.argtypes = [p, p, p, p, p, p, i32, i32, i64, i32,
                                    i32, i32, i32, i32, p]
    lib.paxi_exec_masks.restype = i32
    return lib


def _check(args, dev: torch.device) -> None:
    """Each ``(name, tensor, shape, dtype)`` of ``args``: its shape, dtype
    and layout, then that every tensor lies on the CUDA device ``dev``."""
    for name, x, shape, dtype in args:
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    for name, x, _, _ in args:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} needs a CUDA tensor on {dev}, got "
                             f"{x.device}")


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def dep_graph_launch(deps: Tensor, base: Tensor,
                     committed: Tensor) -> Tuple[Tensor, Tensor]:
    """The graph kernel on contiguous CUDA tensors (as ``dep_graph_plain``)."""
    if deps.ndim != 4 or deps.shape[1] % max(deps.shape[0], 1) != 0:
        raise ValueError(f"deps must be (R, R*I, R, G), got "
                         f"{tuple(deps.shape)}")
    R, NN, _, G = deps.shape
    _check((("deps", deps, (R, NN, R, G), torch.int32),
            ("base", base, (R, R, G), torch.int32),
            ("committed", committed, (R, NN, G), torch.bool)), deps.device)
    adj = torch.empty((R * G, NN, NN), dtype=torch.bool, device=deps.device)
    fblock = torch.empty((R, NN, G), dtype=torch.bool, device=deps.device)
    if adj.numel() == 0:
        return adj, fblock
    t = graph_tiling(NN)
    err = _lib().paxi_dep_graph(
        deps.data_ptr(), base.data_ptr(), committed.data_ptr(),
        adj.data_ptr(), fblock.data_ptr(), R, NN // R, G, t.groups, t.chunk,
        _stream(deps))
    if err != 0:
        raise RuntimeError(f"dep_graph kernel launch failed (NN={NN}, "
                           f"G={G}): CUDA error {err}")
    dep_graph.launches += 1
    return adj, fblock


def exec_masks_launch(reach: Tensor, committed: Tensor, fblock: Tensor,
                      executed: Tensor) -> Tuple[Tensor, Tensor]:
    """The masks kernel on contiguous CUDA tensors (as
    ``exec_masks_plain``)."""
    if committed.ndim != 3:
        raise ValueError(f"committed must be (R, NN, G), got "
                         f"{tuple(committed.shape)}")
    R, NN, G = committed.shape
    _check((("reach", reach, (R * G, NN, NN), torch.bool),
            ("committed", committed, (R, NN, G), torch.bool),
            ("fblock", fblock, (R, NN, G), torch.bool),
            ("executed", executed, (R, NN, G), torch.bool)), reach.device)
    out = torch.empty((2, R, NN, G), dtype=torch.bool, device=reach.device)
    exec_ok, needed = out[0], out[1]
    if reach.numel() == 0:
        return exec_ok, needed
    t = mask_tiling(NN)
    err = _lib().paxi_exec_masks(
        reach.data_ptr(), committed.data_ptr(), fblock.data_ptr(),
        executed.data_ptr(), exec_ok.data_ptr(), needed.data_ptr(), R, NN, G,
        t.groups, int(t.staged), t.words, t.stride, t.shmem, _stream(reach))
    if err != 0:
        raise RuntimeError(f"exec_masks kernel launch failed (NN={NN}, "
                           f"G={G}, {t}): CUDA error {err}")
    exec_masks.launches += 1
    return exec_ok, needed


def _dispatch(x: Tensor, plain, launch, args):
    if x.device.type == "cpu":
        return plain(*args)
    if x.device.type == "cuda":
        return launch(*args)
    raise ValueError(f"no execution-block kernel for device {x.device}")


def dep_graph(deps: Tensor, base: Tensor,
              committed: Tensor) -> Tuple[Tensor, Tensor]:
    """``(A (R*G, NN, NN), fblock (R, NN, G))`` of the window graphs."""
    return _dispatch(deps, dep_graph_plain, dep_graph_launch,
                     (deps, base, committed))


def exec_masks(reach: Tensor, committed: Tensor, fblock: Tensor,
               executed: Tensor) -> Tuple[Tensor, Tensor]:
    """``(exec_ok, needed)``, each ``(R, NN, G)``, of the closed graphs."""
    return _dispatch(reach, exec_masks_plain, exec_masks_launch,
                     (reach, committed, fblock, executed))


dep_graph.launches = 0
exec_masks.launches = 0


def reset_launches() -> None:
    dep_graph.launches = 0
    exec_masks.launches = 0
