"""Plain transitive closure: repeated squaring of the bool adjacency in
float32 matrix products (a frozen copy of the port's ``closure_plain``).
The products count paths of at most ``N`` nodes, exact in float32, and
TF32 is kept off so that a card computes them in full float32."""

from __future__ import annotations

import torch


def _n_iter(n: int) -> int:
    """Squarings that reach every path of length <= n."""
    return max(1, (max(n, 2) - 1).bit_length())


def transitive_closure(adj: torch.Tensor) -> torch.Tensor:
    """Reachability closure of ``bool[..., N, N]`` (lead axes batched)."""
    if adj.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matrix products are on; the reference "
                           "closure needs full float32")
    reach = adj
    for _ in range(_n_iter(adj.shape[-1])):
        r = reach.to(torch.float32)
        reach = reach | (torch.matmul(r, r) > 0)
    return reach
