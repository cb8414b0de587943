"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py).

Values cross between the JAX package and the port as numpy arrays; every
comparison is exact, dtype included, because every plane of the simulator
is int32 or bool.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    """Apply ``fn`` to the leaves of a tree of dicts, tuples, lists and
    named tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaf_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return np.asarray(x)
    return x            # numbers, configs and other objects pass through


def to_np(tree):
    """A tree of JAX arrays / tensors -> the same tree with numpy leaves
    (numbers and other objects kept)."""
    return _map(_leaf_np, tree)


def to_torch(tree, device="cpu"):
    """A tree with numpy leaves -> torch tensors (dtypes kept)."""
    def leaf(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.array(x, copy=True)).to(device)
        return x
    return _map(leaf, tree)


def key_to_torch(key) -> torch.Tensor:
    """A JAX ``uint32[2]`` key -> the port's int64 key."""
    return torch.from_numpy(np.asarray(key, dtype=np.uint32)
                            .astype(np.int64))


def assert_tree_equal(want, got, path="") -> None:
    """Exact equality of two trees (numpy/JAX/torch leaves), dtype and
    shape included."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(want) == sorted(got), (path, sorted(want), sorted(got))
        for k in want:
            assert_tree_equal(want[k], got[k], f"{path}.{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_tree_equal(a, b, f"{path}[{i}]")
        return
    a, b = to_np(want), to_np(got)
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{path}: dtype {a.dtype} != {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=path)
