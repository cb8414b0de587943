"""The two collectives of the sharded path, over a mesh's process group.

``mesh`` is a ``parallel.mesh.Mesh`` (only its ``group`` and ``world`` are
read); a mesh without a process group (world 1) passes its tensors
through.  Under gloo a CUDA tensor crosses through the host.  This module
imports only torch, so both the ops layer (the ring shift's plain
version) and the sharded runner can import it.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def _via_host(t: torch.Tensor, mesh) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def all_reduce_sum(tensors: Dict[str, torch.Tensor],
                   mesh) -> Dict[str, torch.Tensor]:
    """Sum each tensor (of any shape) over the ranks in its own dtype
    (int32 wraps, as ``lax.psum`` does): one collective per dtype."""
    if mesh.group is None:
        return dict(tensors)
    out = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tensors.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = torch.cat([tensors[k].reshape(-1) for k in keys])
        buf = flat.cpu() if _via_host(flat, mesh) else flat
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        parts = buf.to(flat.device).split(
            [tensors[k].numel() for k in keys])
        out.update({k: p.reshape(tensors[k].shape)
                    for k, p in zip(keys, parts)})
    return {k: out[k] for k in tensors}


def all_gather(t: torch.Tensor, mesh) -> list:
    """Every rank's ``t`` (same shape and dtype on all ranks), in rank
    order, on ``t``'s device."""
    if mesh.group is None:
        return [t]
    buf = t.cpu() if _via_host(t, mesh) else t
    # gloo gathers no bool: move the bytes as uint8
    wire = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
    parts = [torch.empty_like(wire) for _ in range(mesh.world)]
    dist.all_gather(parts, wire.contiguous(), group=mesh.group)
    if buf.dtype == torch.bool:
        parts = [p.view(torch.bool) for p in parts]
    return [p.to(t.device) for p in parts]
