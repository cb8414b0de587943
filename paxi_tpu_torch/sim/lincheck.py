"""Vectorized (batched) linearizability oracle for big sim histories.

The precedence-graph checker in ``paxi_tpu_torch.host.history`` is exact
but O(n^3)-ish per key — right for benchmark-sized histories.  For the
sim runtime's scale (100k groups) this module provides the vectorized
**stale/future-read** check over dense op tensors, which is the register
condition the reference's checker enforces in practice: a read must not
return a value whose write was already overwritten by a write that
completed before the read started, nor a value written only after the
read ended.

Planes (ops flattened per group; pad with valid=False), torch tensors or
numpy arrays:
- ``valid   (B, N) bool``
- ``key     (B, N) int32``
- ``is_read (B, N) bool``
- ``val     (B, N) int32``  unique per write within (group, key)
- ``start, end (B, N) float/int`` — any monotonic clock (sim step ids)

Returns per-group anomaly counts ``(B,) int32`` on ``device``: the card
unless the caller passes ``device="cpu"``.  The JAX package's numpy
checker, the same ``(chunk, N, N)`` intermediates chunked by the same
``max_elems`` rule, as torch tensor code.
"""

from __future__ import annotations

import torch


def _plane(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def stale_read_anomalies(valid, key, is_read, val, start, end,
                         max_elems: int = 10_000_000, device=None):
    """Chunks the batch axis so the (chunk, N, N) intermediates stay
    around ``max_elems`` booleans regardless of B."""
    device = torch.device(device or "cuda")
    planes = [_plane(x, device)
              for x in (valid, key, is_read, val, start, end)]
    B, N = planes[0].shape
    chunk = max(1, max_elems // max(N * N, 1))
    if B > chunk:
        return torch.cat([_anomalies(*(p[i:i + chunk] for p in planes))
                          for i in range(0, B, chunk)])
    return _anomalies(*planes)


def _anomalies(valid, key, is_read, val, start, end) -> torch.Tensor:
    valid = valid.bool()
    is_read = is_read.bool()
    B = valid.shape[0]
    w_ok = valid & ~is_read                      # (B, N) writes
    r_ok = valid & is_read

    # match reads to their writes: same (key, val)
    same_key = key[:, :, None] == key[:, None, :]        # (B, r, w)
    same_val = val[:, :, None] == val[:, None, :]
    rw = r_ok[:, :, None] & w_ok[:, None, :] & same_key & same_val

    has_src = rw.any(dim=2)                               # (B, r)
    # a read of a non-initial value with no matching write is anomalous
    no_src = r_ok & (val != 0) & ~has_src

    # the first matching write, as numpy's argmax of a bool row picks it
    # (torch has no bool argmax; its argmax keeps the first maximum too)
    src = rw.to(torch.uint8).argmax(dim=2)                # (B, r)
    bidx = torch.arange(B, device=valid.device)[:, None]
    w_start = start[bidx, src].masked_fill(~has_src, 0)
    w_end = end[bidx, src].masked_fill(~has_src, 0)

    # future read: the sourcing write started only after the read ended
    future = has_src & (w_start > end)

    # stale read: some OTHER write to the same key began after the
    # sourcing write ended and completed before the read started
    other = w_ok[:, None, :] & same_key & ~same_val       # (B, r, w)
    overw = other & (start[:, None, :] > w_end[:, :, None]) \
        & (end[:, None, :] < start[:, :, None])
    stale = has_src & overw.any(dim=2)

    # initial-value read (val == 0): stale if ANY write to the key
    # completed before the read started
    init_r = r_ok & (val == 0)
    any_w = w_ok[:, None, :] & same_key & (end[:, None, :]
                                           < start[:, :, None])
    init_stale = init_r & any_w.any(dim=2)

    bad = no_src | future | stale | init_stale
    return bad.sum(dim=1, dtype=torch.int32)
