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


def fuzz_pair(fuzz_kw: dict):
    """``(JAX FuzzConfig, port FuzzConfig)`` of ``fuzz_kw``, whose
    ``scenario`` (if any) names a scenario of each package's ``NAMED``."""
    from paxi_tpu.scenarios import NAMED as JNAMED
    from paxi_tpu.sim import FuzzConfig as JFuzz
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FuzzConfig
    kw = dict(fuzz_kw)
    scn = kw.pop("scenario", None)
    return (JFuzz(**kw, scenario=None if scn is None else JNAMED[scn]),
            FuzzConfig(**kw, scenario=None if scn is None else NAMED[scn]))


def run_pair(name: str, cfg_kw: dict, fuzz_kw: dict, g: int, t: int,
             seed: int):
    """One run of the kernel registered as ``name`` in both packages on
    the same seed: ``(JAX SimResult, port SimResult)``, the port's on the
    CPU."""
    import jax.random as jr
    from paxi_tpu.protocols import sim_protocol as jax_protocol
    from paxi_tpu.sim import SimConfig as JCfg
    from paxi_tpu.sim import SimResult as JResult
    from paxi_tpu.sim import make_run as jax_make_run
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig, make_run
    from paxi_tpu_torch.sim.runner import SimResult

    jfuzz, pfuzz = fuzz_pair(fuzz_kw)
    js, jm, jv = jax_make_run(jax_protocol(name), JCfg(**cfg_kw),
                              jfuzz)(jr.PRNGKey(seed), g, t)
    ps, pm, pv = make_run(sim_protocol(name), SimConfig(**cfg_kw),
                          pfuzz, device="cpu")(
        tr.PRNGKey(seed), g, t)
    return (JResult(state=js, metrics=jm, violations=jv, steps=t, groups=g),
            SimResult(state=ps, metrics=pm, violations=pv, steps=t,
                      groups=g))


def assert_one_step_from_mid_run_carry(name: str, cfg_kw: dict,
                                       fuzz_kw: dict, g: int, seed: int,
                                       t0: int) -> None:
    """Step ``t0`` of a JAX run, taken as a carry, converted (a per-group
    kernel's in its own layout), and advanced one step by each package:
    the same carry, violations and counters come out."""
    import jax
    import jax.random as jr
    from paxi_tpu.protocols import sim_protocol as jax_protocol
    from paxi_tpu.sim import SimConfig as JCfg
    from paxi_tpu.sim.runner import continue_run, init_carry
    from paxi_tpu_torch import convert
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig
    from paxi_tpu_torch.sim.runner import make_scan_body

    proto, cfg = jax_protocol(name), JCfg(**cfg_kw)
    fuzz, pfuzz = fuzz_pair(fuzz_kw)
    carry = init_carry(proto, cfg, fuzz, g, jr.PRNGKey(seed))
    _, carry = continue_run(proto, cfg, carry, 0, t0, fuzz)
    np_carry = jax.device_get(carry)
    res, new_carry = continue_run(proto, cfg, carry, t0, 1, fuzz)

    pproto = sim_protocol(name)
    body = make_scan_body(pproto, SimConfig(**cfg_kw), pfuzz)
    with torch.inference_mode():
        p_carry, (viol, counts) = body(
            convert.carry_from_numpy(np_carry, "cpu",
                                     per_group=not pproto.batched), t0)
    assert_tree_equal(jax.device_get(new_carry),
                      convert.carry_to_numpy(p_carry), "carry")
    assert_tree_equal(res.violations, viol, "violations")
    for k, v in counts.items():
        assert_tree_equal(res.metrics[k], v, k)


def assert_group_invariants_equal(name: str, cfg_kw: dict, fuzz_kw: dict,
                                  g: int, t0: int, seed: int = 1) -> None:
    """The port's per-group invariants on its carries before and after
    step ``t0`` of a run (and backwards, where ballots fall and commits
    vanish), element for element against the reference's
    ``per_group_invariants``; their sum is the port's ``invariants``."""
    import jax.numpy as jnp
    from paxi_tpu.protocols import sim_protocol as jax_protocol
    from paxi_tpu.sim import SimConfig as JCfg
    from paxi_tpu.sim import runner as jrun
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig, runner

    proto, cfg = sim_protocol(name), SimConfig(**cfg_kw)
    pfuzz = fuzz_pair(fuzz_kw)[1]
    body = runner.make_scan_body(proto, cfg, pfuzz)
    with torch.inference_mode():
        carry = runner.init_carry(proto, cfg, pfuzz, g, tr.PRNGKey(seed),
                                  "cpu")
        for t in range(t0):
            carry, _ = body(carry, t)
        new, _ = body(carry, t0)
    old, new = carry[0], new[0]
    for a, b in ((old, new), (new, old)):
        got = runner.per_group_invariants(proto, cfg, a, b)
        want = jrun.per_group_invariants(
            jax_protocol(name), JCfg(**cfg_kw),
            {k: jnp.asarray(v.numpy()) for k, v in a.items()},
            {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        assert got.shape == (g,)
        assert_tree_equal(want, got, name)
        assert int(torch.sum(got)) == int(proto.invariants(a, b, cfg))


def capture_pair(name: str, cfg_kw: dict, fuzz_kw: dict, g: int, t: int,
                 seed: int):
    """The first violating group's trace captured by each package on the
    same seed: ``(JAX Trace, port Trace)``, the port's on the CPU."""
    from paxi_tpu import trace as jtr
    from paxi_tpu.protocols import sim_protocol as jax_protocol
    from paxi_tpu.sim import SimConfig as JCfg
    from paxi_tpu_torch import trace as ptr
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import SimConfig

    jfuzz, pfuzz = fuzz_pair(fuzz_kw)
    jt = jtr.capture(jax_protocol(name), JCfg(**cfg_kw), jfuzz, seed=seed,
                     n_groups=g, n_steps=t)
    pt = ptr.capture(sim_protocol(name), SimConfig(**cfg_kw), pfuzz,
                     seed=seed, n_groups=g, n_steps=t, device="cpu")
    return jt, pt
