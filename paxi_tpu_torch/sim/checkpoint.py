"""Checkpoint and resume for long simulation runs (the port's copy of the
JAX package's ``sim/checkpoint.py`` and its file format).

The whole simulation is one carry ``(state, wheel, fs, key)``, so a
checkpoint is an exact resume point: ``continue_run`` over 60 steps equals
30 steps, ``save_carry``, ``load_carry``, 30 steps.

Format: one ``.npz`` of path-flattened arrays plus a JSON meta blob, the
carry in the reference's layout (``convert.carry_to_numpy``: the wheel as
per-type ``{"valid", field}`` planes, the key as ``uint32[2]``) under the
key strings the reference builds (``[0]|['ballot']``,
``[1]|['p1a']|['valid']``, ``[2]|['conn']``, ``[3]``), so a checkpoint
written by either package resumes in the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from paxi_tpu_torch import convert
from paxi_tpu_torch.sim.mailbox import WheelBox

_META_KEY = "__paxi_tpu_meta__"
_SEP = "|"
# bump when a kernel's carry layout changes incompatibly: load_carry turns
# a mismatch into a clear error instead of a bare shape error
LAYOUT_VERSION = 2

Path = Tuple[Tuple[str, Any], ...]    # ("seq", index) / ("dict", key)


def layout_version(meta: dict) -> int:
    return int(meta.get("layout_version", 1))


def key_paths(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """``(path, leaf)`` in the reference's flattening order: tuples and
    lists by index, dicts by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], path + (("dict", k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from key_paths(v, path + (("seq", i),))
    else:
        yield path, tree


def path_key(path: Path) -> str:
    """The archive key of a path: ``[0]|['ballot']``."""
    return _SEP.join(f"[{k}]" if kind == "seq" else f"[{k!r}]"
                     for kind, k in path)


def path_repr(path: Path) -> str:
    """The printed key path of the reference's flattening:
    ``(SequenceKey(idx=0), DictKey(key='ballot'))``."""
    parts = [f"SequenceKey(idx={k})" if kind == "seq"
             else f"DictKey(key={k!r})" for kind, k in path]
    return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"


def flatten(tree: Any) -> Dict[str, np.ndarray]:
    """``{archive key: numpy array}`` of a tree of arrays or tensors."""
    out = {}
    for path, leaf in key_paths(tree):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        out[path_key(path)] = np.asarray(leaf)
    return out


def _norm(path: str) -> str:
    """np.savez appends .npz when missing — normalize on both ends."""
    return path if path.endswith(".npz") else path + ".npz"


def save_carry(path: str, carry: Any, meta: Optional[dict] = None) -> None:
    """Write a resumable checkpoint of a simulation carry (the port's
    ``(state, wheel, fs, key)``)."""
    flat = flatten(convert.carry_to_numpy(carry))
    meta = dict(meta or {})
    meta.setdefault("layout_version", LAYOUT_VERSION)
    flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                    dtype=np.uint8)
    np.savez_compressed(_norm(path), **flat)


def load_carry(path: str, like: Any) -> Tuple[Any, dict]:
    """Load a checkpoint into the structure of ``like`` (a carry built by
    ``init_carry`` with the same geometry), on ``like``'s device; returns
    ``(carry, meta)``."""
    with np.load(_norm(path)) as z:
        meta = (json.loads(bytes(z[_META_KEY]).decode())
                if _META_KEY in z else {})
        flat = {k: z[k] for k in z.files if k != _META_KEY}
    if layout_version(meta) != LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint layout v{layout_version(meta)} is incompatible "
            f"with this build (v{LAYOUT_VERSION}): kernel carry layouts "
            "changed; re-run the simulation from scratch")
    np_carry = _rebuild(convert.carry_to_numpy(like), flat, ())
    per_group = not isinstance(next(iter(like[1].values())), WheelBox)
    return (convert.carry_from_numpy(np_carry, like[-1].device, per_group),
            meta)


def _rebuild(like: Any, flat: Dict[str, np.ndarray], path: Path) -> Any:
    """``like``'s tree (its own key order, so each wheel block stacks its
    fields as the protocol does) with every leaf read from ``flat``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (("dict", k),))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, flat, path + (("seq", i),))
                          for i, v in enumerate(like))
    key = path_key(path)
    if key not in flat:
        raise KeyError(f"checkpoint missing array {key!r}")
    arr = flat[key]
    if arr.shape != like.shape:
        raise ValueError(f"{key!r}: checkpoint shape {arr.shape} != "
                         f"expected {like.shape}")
    return arr.astype(like.dtype)
