"""Boolean transitive closure of a batch of graphs (CUDA for Hopper).

The EPaxos execution step (``protocols/epaxos/sim.py``) orders its
committed dependency graph with ``reach = transitive_closure(A)``: SCCs are
``reach & reach^T``.  The reachability relation is what ``_n_iter(N)``
squarings ``r <- r | r.r`` give; self-reach appears only through a cycle.

``closure_launch`` runs the hand-written kernel (``csrc/closure.cu``),
which replaces the JAX package's Pallas kernel ``closure_pallas`` in
``paxi_tpu/ops/closure.py``, at every width N >= 1.  ``closure_route``
picks the kernel's variant for a launch (a warp a graph up to 256 nodes,
a block a graph above, and at 224 and 256 where it is faster, its bit
rows in shared memory while they fit and in a global scratch buffer
beyond) with its threads, row stride and shared memory; the C entry takes
them as they are.  ``closure_plain`` is the plain version, the float32 matrix squaring
of ``closure_xla`` there.  ``transitive_closure`` dispatches by the
tensor's device and nothing else: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.  The wrapper counts its
launches in ``transitive_closure.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from paxi_tpu_torch.ops import _build

_LIB = "closure"
# the warp kernel keeps a lane's rows, ceil(N/32) 32-bit words each, in
# registers; this is the widest graph it takes (csrc/closure.cu)
WARP_MAX_N = 256
# from this width on the block kernel also takes the graphs the warp
# kernel would take on its general path and the block kernel converts 16
# bytes at a time (N = 0 mod 32, aligned): on an H100 (700 W,
# scripts/torch_closure_routes.py) it ran 20k x 256 in 1.614 ms against
# the warp kernel's 2.138 and 30k x 224 in 2.016 against 2.319, and lost
# at 50k x 160 (2.097 against 1.629) and 50k x 130 (4.676 against 1.312)
BLOCK_FROM_N = 224
# the block kernel's threads at most (its __launch_bounds__)
BLOCK_MAX_THREADS = 512
# its tables: 8 of 16 entries, each a bit row (csrc/closure.cu)
BLOCK_TABLE_ROWS = 128
# dynamic shared memory a block may have on an H100 (227 KB)
SMEM_LIMIT = 232_448
# the warp kernel's shared memory: its mbarriers, then two staged chunks
# and an output buffer for each of its four warps
_WARP_BAR_BYTES, _WARP_WARPS, _WARP_STAGES = 128, 4, 2
VARIANTS = ("warp", "block_smem", "block_global")


class Route(NamedTuple):
    """One launch's variant and its parameters (see ``closure_route``)."""
    variant: str        # one of VARIANTS
    vec: bool           # bytes <-> bits 16 bytes a lane, else a ballot a word
    threads: int        # threads a block
    wp: int             # 32-bit words a stored bit row (block variants)
    shmem: int          # dynamic shared memory bytes a block
    scratch_words: int  # global bit-row words a block (block_global)


def _stage_bytes(n: int) -> int:
    return (32 * n + 32 + 15) & ~15


def block_threads(n: int) -> int:
    """Threads of the block kernel for graphs of ``n`` nodes: about three
    rows a thread (thread t takes rows t, t + T, ...), at most 512.  On an
    H100 (700 W, scripts/torch_closure_routes.py) three rows a thread ran
    3,072 x 384 in 0.593 ms against 0.644 at four and 0.672 at two, 10,240
    x 320 in 1.250 against 1.342 and 1.359 (128 threads, the fastest of 64
    to 256 at both) and 4,000 x 512 in 1.386 (192, the fastest)."""
    return min(BLOCK_MAX_THREADS, 32 * -(-n // 96))


def smem_row_words(w: int) -> int:
    """The row stride in shared memory: a multiple of 4 words whose count
    of 16-byte units is odd, so the 8 lanes of one phase of a 16-byte
    access to 8 consecutive rows fall in distinct banks."""
    q = -(-w // 4)
    return 4 * (q if q % 2 else q + 1)


def closure_route(n: int, adj_off: int = 0, out_off: int = 0) -> Route:
    """The variant that takes graphs of ``n`` nodes whose input and output
    start ``adj_off`` and ``out_off`` bytes past a 16-byte boundary."""
    if n < 1:
        raise ValueError(f"graphs need N >= 1, got {n}")
    aligned = adj_off % 16 == 0 and out_off % 16 == 0
    vec = n % 16 == 0 and aligned
    if n <= WARP_MAX_N and not (n >= BLOCK_FROM_N and n % 32 == 0
                                and aligned):
        shmem = _WARP_BAR_BYTES + _WARP_WARPS * (_WARP_STAGES + 1) \
            * _stage_bytes(n)
        return Route("warp", n % 32 == 16 and aligned, 32 * _WARP_WARPS,
                     0, shmem, 0)
    w = -(-n // 32)                 # words a bit row, and 32-node panels
    threads = block_threads(n)
    # the bit rows (32 W of them: the last panel padded with zero rows)
    # and the tables
    wp = smem_row_words(w)
    shmem = (32 * w + BLOCK_TABLE_ROWS) * wp * 4
    if shmem <= SMEM_LIMIT:
        return Route("block_smem", vec, threads, wp, shmem, 0)
    wp = 4 * -(-w // 4)
    return Route("block_global", vec, threads, wp, 0,
                 (32 * w + BLOCK_TABLE_ROWS) * wp)


def _n_iter(n: int) -> int:
    """Squarings that reach every path of length <= n."""
    return max(1, (max(n, 2) - 1).bit_length())


def closure_plain(adj: torch.Tensor) -> torch.Tensor:
    """Repeated squaring in float32 matrix products; adj bool[..., N, N]."""
    reach = adj
    for _ in range(_n_iter(adj.shape[-1])):
        r = reach.to(torch.float32)
        reach = reach | (torch.matmul(r, r) > 0)
    return reach


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.paxi_transitive_closure.argtypes = [p, p, i64, i32, i32, i32, i32,
                                            i32, i32, p, i64, p]
    lib.paxi_transitive_closure.restype = i32
    return lib


def closure_launch(adj: torch.Tensor) -> torch.Tensor:
    """The kernel on a contiguous CUDA ``bool[B, N, N]``, any N >= 1, at
    any byte offset (Warshall's algorithm on bit rows: the same relation
    as ``closure_plain``)."""
    if adj.ndim != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"adjacency must be (B, N, N), got "
                         f"{tuple(adj.shape)}")
    if adj.device.type != "cuda":
        raise ValueError(f"closure kernel needs a CUDA tensor, got "
                         f"{adj.device}")
    if adj.dtype != torch.bool:
        raise TypeError(f"adjacency has dtype {adj.dtype}, expected bool")
    if not adj.is_contiguous():
        raise ValueError("adjacency is not contiguous")
    b, n = adj.shape[0], adj.shape[1]
    out = torch.empty_like(adj)
    if b == 0 or n == 0:
        return out
    r = closure_route(n, adj.data_ptr() % 16, out.data_ptr() % 16)
    scratch, grid = None, 0
    if r.variant == "block_global":
        # a block an SM, each with its own graph's bit rows
        sms = torch.cuda.get_device_properties(adj.device) \
            .multi_processor_count
        grid = min(b, sms)
        scratch = torch.empty(grid * r.scratch_words, dtype=torch.int32,
                              device=adj.device)
    err = _lib().paxi_transitive_closure(
        adj.data_ptr(), out.data_ptr(), b, n, VARIANTS.index(r.variant),
        int(r.vec), r.wp, r.threads, r.shmem,
        None if scratch is None else scratch.data_ptr(), grid,
        torch.cuda.current_stream(adj.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transitive_closure kernel launch failed "
                           f"({r.variant}, N={n}): CUDA error {err}")
    transitive_closure.launches += 1
    return out


def transitive_closure(adj: torch.Tensor) -> torch.Tensor:
    """Reachability closure of ``bool[..., N, N]`` (lead axes batched)."""
    lead, n = adj.shape[:-2], adj.shape[-1]
    flat = adj.reshape((-1, n, n))
    if adj.device.type == "cpu":
        out = closure_plain(flat)
    elif adj.device.type == "cuda":
        out = closure_launch(flat)
    else:
        raise ValueError(f"no closure kernel for device {adj.device}")
    return out.reshape(lead + (n, n))


transitive_closure.launches = 0


def reset_launches() -> None:
    transitive_closure.launches = 0
