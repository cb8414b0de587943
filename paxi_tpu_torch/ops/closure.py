"""Boolean transitive closure of a batch of small graphs (CUDA for Hopper).

The EPaxos execution step (``protocols/epaxos/sim.py``) orders its
committed dependency graph with ``reach = transitive_closure(A)``: SCCs are
``reach & reach^T``.  The reachability relation is what ``_n_iter(N)``
squarings ``r <- r | r.r`` give; self-reach appears only through a cycle.

``closure_launch`` runs the hand-written kernel (``csrc/closure.cu``),
which replaces the JAX package's Pallas kernel ``closure_pallas`` in
``paxi_tpu/ops/closure.py``.  ``closure_plain`` is its plain version, the
float32 matrix squaring of ``closure_xla`` there.  ``transitive_closure``
dispatches by the tensor's device and nothing else: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  The wrapper
counts its launches in ``transitive_closure.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paxi_tpu_torch.ops import _build

_LIB = "closure"
# the kernel keeps a lane's rows, ceil(N/32) 32-bit words each, in
# registers; this is the widest graph it takes (csrc/closure.cu)
MAX_N = 256


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
    lib.paxi_transitive_closure.argtypes = [p, p, i64, i32, p]
    lib.paxi_transitive_closure.restype = i32
    return lib


def closure_launch(adj: torch.Tensor) -> torch.Tensor:
    """The kernel on a contiguous CUDA ``bool[B, N, N]``, N <= MAX_N, at
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
    if n > MAX_N:
        raise ValueError(f"closure kernel takes N <= {MAX_N}, got {n}")
    out = torch.empty_like(adj)
    err = _lib().paxi_transitive_closure(
        adj.data_ptr(), out.data_ptr(), b, n,
        torch.cuda.current_stream(adj.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transitive_closure kernel launch failed: "
                           f"CUDA error {err}")
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
