"""Kernel-purity rule family (PXK1xx) for the port's eager PyTorch kernels.

The JAX package's rule guards traced code: inside ``jax.jit``/``lax.scan``
a Python branch on a traced value fails or freezes one side.  The port
runs eagerly, so the same bug costs something else: a Python ``if`` on a
CUDA tensor, an ``.item()`` or a ``torch.nonzero`` inside a step makes
the host wait for the card (``cudaStreamSynchronize``), which stalls the
launch queue every step and rules out capturing the step as a CUDA
graph.  ``sim/runner.py:run_steps`` promises a step loop with no host
sync; this family checks the promise statically.

The kernel surface (closure over calls, module-local and — through the
project index — across modules):

- the ``SimProtocol(...)`` entry points ``step``, ``metrics``,
  ``invariants`` and ``group_invariants`` (every step runs them), and
  ``init_state`` for the determinism codes only (PXK101, 103, 105, 106:
  it runs once, so a sync there costs nothing a step);
- every top-level function of the kernel-library modules
  (``KERNEL_LIB_MODULES``: the mailbox and ring cores, the exchange,
  closure and hashing wrappers, ``random.py``, the on-device counters and
  histograms, the switchnet plane);
- the runner's per-step code: ``_group_step``, ``pg_step``,
  ``flush_measurements``, the step closure ``make_scan_body`` returns and
  ``run_steps``'s loop body.

Not kernel surface: setup, checkpoint IO and the drivers, and any
function under ``functools.lru_cache``/``functools.cache`` — it is built
once and replayed from the cache (``mailbox._delay_plane``), so the
closure never enters it.  A host-side helper of a kernel-library module
that no step reaches is named in ``HOST_SIDE`` with its reason.

Checks (the JAX package's numbers; each message says what it costs on
the card):

- **PXK101** nondeterministic call: ``time.*``, ``random.*``,
  ``np.random.*``, ``datetime.*``, ``uuid.*``, ``os.urandom`` and
  PyTorch's own draws (``torch.rand*``, ``torch.randperm``,
  ``torch.bernoulli``/``multinomial``/``normal``/``poisson``,
  ``torch.manual_seed``/``seed``, ``torch.Generator``, a ``generator=``
  draw, in-place ``.uniform_()``-style fills) — draws go through
  ``random.py``'s counter hash, or replay breaks;
- **PXK102** ``np.``/``numpy.`` in kernel code: host compute plus a
  pageable copy to the card;
- **PXK103** iteration over a set (unordered: launch order and thus
  results may differ between runs);
- **PXK104** a host sync: a Python ``if``/``while``/``assert``/ternary/
  ``and``/``or`` on a tensor expression, ``bool()``/``int()``/
  ``float()``/``range()``/builtin ``min``/``max`` of one, ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``torch.nonzero``/``.nonzero()``, a one-argument ``torch.where``,
  ``torch.argwhere``, ``torch.unique``, ``masked_select``,
  ``torch.bincount``, ``torch.equal``/``allclose``/``is_nonzero``,
  ``torch.cuda.synchronize`` and ``.synchronize()``.  A tensor
  expression is a ``torch.`` call (not one of the host-valued ones such
  as ``torch.cuda.*``), a tensor method such as ``.any()``/``.all()``/
  ``.sum()``/``.max()``, a subscript of a state, outbox, inbox or carry
  dict (``TENSOR_DICTS``), arithmetic on one, or a local name bound to
  one; ``.shape``/``.dtype``/``.device`` and friends make it host data;
- **PXK105** float64: ``torch.float64``/``torch.double``/``.double()``/
  ``np.float64``/``"float64"`` (the kernels are int32/float32; a double
  plane runs at a fraction of the card's rate);
- **PXK106** ``id()``/``hash()`` of a value in kernel code (object
  identity is not a kernel fact);
- **PXK107** a device tensor built from host data in per-step code:
  ``torch.tensor``/``torch.as_tensor``/``torch.from_numpy`` with
  ``device=`` or followed by ``.to(...)``/``.cuda()`` — an allocation
  and a host-to-device copy from pageable memory every step; the copy
  is a blocking ``copy_`` (copy, then stream sync), which the CUDA sync
  debug mode reports like any other sync.

Purely static, like every paxi-lint family: no module under analysis is
imported.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation
from paxi_tpu_torch.analysis.project import ProjectIndex, shared_index

RULE = "kernel-purity"

# file globs (repo-relative) holding kernel or kernel-adjacent code
TARGETS = (
    "paxi_tpu_torch/protocols/*/sim*.py",
    "paxi_tpu_torch/sim/*.py",
    "paxi_tpu_torch/ops/*.py",
    "paxi_tpu_torch/random.py",
    "paxi_tpu_torch/metrics/*.py",
    "paxi_tpu_torch/switchnet/plane.py",
    "paxi_tpu_torch/trace/demo.py",
    "paxi_tpu_torch/scenarios/*.py",
    "paxi_tpu_torch/workload/*.py",
)

# modules whose every top-level function is kernel code (they exist to
# be called from someone else's step)
KERNEL_LIB_MODULES = frozenset({
    "paxi_tpu_torch/sim/mailbox.py",
    "paxi_tpu_torch/sim/mailbox_pg.py",
    "paxi_tpu_torch/sim/lanes.py",
    "paxi_tpu_torch/sim/ring.py",
    "paxi_tpu_torch/sim/ballot_ring.py",
    "paxi_tpu_torch/sim/cell_ring.py",
    "paxi_tpu_torch/sim/inscan.py",
    # the wrappers run every step: their argument checks and launch
    # plans are per-step host work too
    "paxi_tpu_torch/ops/exchange.py",
    "paxi_tpu_torch/ops/closure.py",
    "paxi_tpu_torch/ops/hashing.py",
    "paxi_tpu_torch/random.py",
    "paxi_tpu_torch/metrics/simcount.py",
    "paxi_tpu_torch/metrics/lathist.py",
    "paxi_tpu_torch/switchnet/plane.py",
})

# top-level functions of kernel-library modules that no step reaches:
# (module, function) -> why it is host-side
HOST_SIDE: Dict[Tuple[str, str], str] = {
    ("paxi_tpu_torch/ops/exchange.py", "make_remote_lane_shift"):
        "the staged group-migration primitive: no run path calls it",
    ("paxi_tpu_torch/ops/exchange.py", "lane_shift_plain"):
        "the ring shift's plain version: no run path calls the shift",
    ("paxi_tpu_torch/ops/exchange.py", "lane_shift_launch"):
        "the ring shift's launch: no run path calls the shift",
    ("paxi_tpu_torch/ops/exchange.py", "reset_launches"):
        "zeroes the launch counters between a driver's runs",
    ("paxi_tpu_torch/ops/closure.py", "reset_launches"):
        "zeroes the launch counter between a driver's runs",
    ("paxi_tpu_torch/metrics/lathist.py", "summarize"):
        "host-side summary of a finished run's histogram",
    ("paxi_tpu_torch/metrics/lathist.py", "to_host_snapshot"):
        "host registry export of a finished run's histogram",
    ("paxi_tpu_torch/metrics/lathist.py", "total_hist"):
        "host-side fold of a finished run's numpy state",
    ("paxi_tpu_torch/metrics/lathist.py", "to_sparse"):
        "host-side sparse form of a finished run's histogram",
    ("paxi_tpu_torch/metrics/lathist.py", "bin_steps"):
        "numpy twin of hist_update, folding a finished run's pending plane",
    ("paxi_tpu_torch/metrics/lathist.py", "plane_total"):
        "host-side sum of a finished run's histogram plane",
    ("paxi_tpu_torch/metrics/lathist.py", "percentile_steps"):
        "host-side percentile of a finished run's histogram",
    ("paxi_tpu_torch/metrics/simcount.py", "counters_of"):
        "renames a finished run's metrics",
    ("paxi_tpu_torch/random.py", "PRNGKey"):
        "builds a run's root key once, before the first step",
}

RUNNER = "paxi_tpu_torch/sim/runner.py"
# the runner's per-step functions (``run_steps`` contributes its loop
# body only: the accumulators before it are set up once)
RUNNER_STEP_FUNCS = frozenset({"_group_step", "pg_step",
                               "flush_measurements", "body"})
RUNNER_LOOP_FUNCS = frozenset({"run_steps"})

# SimProtocol kwargs that run every step, and the one that runs once
PROTOCOL_STEP_KWARGS = frozenset({"step", "metrics", "invariants",
                                  "group_invariants"})
PROTOCOL_INIT_KWARGS = frozenset({"init_state"})
DETERMINISM_CODES = frozenset({"PXK101", "PXK103", "PXK105", "PXK106"})

CACHE_DECORATORS = frozenset({"lru_cache", "cache"})

BANNED_CALL_PREFIXES = (
    "time.", "random.", "np.random.", "numpy.random.", "datetime.",
    "uuid.", "secrets.",
)
BANNED_CALLS = frozenset({"os.urandom", "os.getrandom"})
TORCH_DRAWS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson",
    "manual_seed", "seed", "Generator", "cuda.manual_seed",
    "cuda.manual_seed_all", "cuda.seed", "cuda.seed_all",
})
INPLACE_DRAWS = frozenset({"random_", "uniform_", "normal_", "bernoulli_",
                           "exponential_", "geometric_", "cauchy_",
                           "log_normal_"})

# dict names whose string-keyed entries are tensors in kernel code
TENSOR_DICTS = frozenset({"state", "st", "new", "old", "new_state",
                          "outbox", "inbox", "out", "carry", "fs", "m",
                          "msg", "box", "sw", "faults", "sched_t"})
# torch.* calls that return host values, not tensors
HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.",
                       "torch.distributed.", "torch.testing.")
HOST_TORCH_CALLS = frozenset({
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.device", "torch.Size", "torch.iinfo", "torch.finfo",
    "torch.get_default_dtype", "torch.is_grad_enabled",
    "torch.is_inference_mode_enabled", "torch.promote_types",
    "torch.result_type", "torch.can_cast", "torch.broadcast_shapes",
    "torch.numel",
})
# attributes / methods of a tensor that are host data
HOST_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                        "layout", "requires_grad", "is_sparse"})
HOST_METHODS = frozenset({"numel", "dim", "size", "element_size",
                          "data_ptr", "stride", "is_contiguous",
                          "get_device", "nelement", "ndimension",
                          "storage_offset", "untyped_storage",
                          "is_floating_point", "item", "tolist"})
# tensor methods that make an expression a tensor whatever the receiver
TENSOR_METHODS = frozenset({"any", "all", "sum", "max", "min", "amax",
                            "amin", "mean", "prod", "argmax", "argmin",
                            "count_nonzero"})

# PXK104: calls that wait for the card whatever their context
SYNC_CALLS = frozenset({
    "torch.nonzero", "torch.argwhere", "torch.unique",
    "torch.unique_consecutive", "torch.masked_select", "torch.bincount",
    "torch.equal", "torch.allclose", "torch.is_nonzero",
    "torch.cuda.synchronize",
})
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero",
                          "unique", "masked_select", "synchronize",
                          "bincount"})
# builtins that convert (or compare) their tensor argument on the host
SYNC_BUILTINS = frozenset({"bool", "int", "float", "range", "min", "max",
                           "print", "str", "repr", "format"})
HOST_DATA_CTORS = frozenset({"torch.tensor", "torch.as_tensor",
                             "torch.from_numpy"})

_COSTS = {
    "PXK101": "replay breaks: the draw is not a function of the run's key",
    "PXK102": "host compute and a pageable copy to the card",
    "PXK103": "unordered iteration: launch order may differ between runs",
    "PXK104": "the host waits for the card (cudaStreamSynchronize): the "
              "launch queue drains every step and no CUDA graph can "
              "capture the step",
    "PXK105": "float64 creep: a double plane runs at a fraction of the "
              "card's float32/int32 rate",
    "PXK106": "object identity is not a kernel fact",
    "PXK107": "an allocation and a host-to-device copy from pageable "
              "memory every step, which the host waits for (a stream "
              "sync the CUDA sync debug mode reports)",
}


def _name(node: ast.AST) -> str:
    return astutil.dotted_name(node) or ""


def _cached(fn: ast.AST) -> bool:
    return any(d.split(".")[-1] in CACHE_DECORATORS
               for d in astutil.decorator_names(fn))


class _Tensors:
    """Which expressions of one function are tensors (a local fixpoint
    over its assignments)."""

    def __init__(self, fn: ast.AST):
        self.names: Set[str] = set()
        assigns: List[Tuple[List[str], ast.expr]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                names = [n for t in node.targets
                         for n in _target_names(t)]
                assigns.append((names, node.value))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    node.value is not None:
                assigns.append((_target_names(node.target), node.value))
            elif isinstance(node, ast.NamedExpr):
                assigns.append(([node.target.id], node.value))
        changed = True
        while changed:
            changed = False
            for names, value in assigns:
                if set(names) <= self.names or not self.is_tensor(value):
                    continue
                self.names.update(names)
                changed = True

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in HOST_ATTRS:
                return False
            return self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            base = e.value
            if isinstance(base, ast.Name) and base.id in TENSOR_DICTS and (
                    base.id == "carry" or isinstance(e.slice, ast.JoinedStr)
                    or (isinstance(e.slice, ast.Constant)
                        and isinstance(e.slice.value, str))):
                return True
            return self.is_tensor(base)
        if isinstance(e, ast.Call):
            name = _name(e.func)
            if name.startswith("torch."):
                return not (name in HOST_TORCH_CALLS
                            or name.startswith(HOST_TORCH_PREFIXES))
            if isinstance(e.func, ast.Attribute):
                meth = e.func.attr
                if meth in HOST_METHODS:
                    return False
                if meth in TENSOR_METHODS:
                    return True
                return self.is_tensor(e.func.value)
            if name in ("sum", "abs"):
                return any(self.is_tensor(a) for a in e.args)
            return False
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in e.ops):
                return False
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for el in target.elts for n in _target_names(el)]
    if isinstance(target, ast.Starred):
        return _target_names(target.value)
    return []


class _KernelChecker:
    def __init__(self, relpath: str, fn: ast.AST, codes=None,
                 repo_aliases: Set[str] = frozenset()):
        self.relpath = relpath
        self.fn_name = getattr(fn, "name", "<lambda>")
        self.codes = codes
        self.repo_aliases = repo_aliases
        self.tensors = _Tensors(fn)
        self.out: List[Violation] = []
        self._claimed: Set[int] = set()   # Attribute ids consumed by calls

    def _add(self, code: str, node: ast.AST, msg: str) -> None:
        if self.codes is not None and code not in self.codes:
            return
        self.out.append(Violation(
            rule=RULE, code=code, path=self.relpath,
            line=node.lineno, col=node.col_offset,
            message=f"{msg} — {_COSTS[code]} (in kernel function "
                    f"`{self.fn_name}`)"))

    def _claim_chain(self, node: ast.AST) -> None:
        while isinstance(node, ast.Attribute):
            self._claimed.add(id(node))
            node = node.value

    # -- individual checks ------------------------------------------------
    def check_call(self, node: ast.Call) -> None:
        name = _name(node.func)
        root = name.split(".")[0]
        if name in ("id", "hash"):
            self._add("PXK106", node, f"`{name}()` of a value in kernel "
                                      "code")
            return
        if root not in self.repo_aliases and (
                name in BANNED_CALLS
                or any(name.startswith(p) for p in BANNED_CALL_PREFIXES)
                or (name.startswith("torch.")
                    and name[len("torch."):] in TORCH_DRAWS)
                or any(kw.arg == "generator" for kw in node.keywords)
                or (isinstance(node.func, ast.Attribute)
                    and node.func.attr in INPLACE_DRAWS)):
            self._claim_chain(node.func)
            self._add("PXK101", node, f"nondeterministic call "
                                      f"`{name or node.func.attr}()` in "
                                      "kernel code")
            return
        if name.startswith(("np.", "numpy.")):
            self._claim_chain(node.func)
            self._add("PXK102", node, f"`{name}()` in kernel code")
            return
        if name in HOST_DATA_CTORS and any(kw.arg == "device"
                                           for kw in node.keywords):
            self._add("PXK107", node, f"`{name}(..., device=...)` in "
                                      "per-step code")
            return
        if isinstance(node.func, ast.Attribute):
            meth, recv = node.func.attr, node.func.value
            if meth in ("to", "cuda") and isinstance(recv, ast.Call) and \
                    _name(recv.func) in HOST_DATA_CTORS:
                self._add("PXK107", node, f"`{_name(recv.func)}(...)."
                                          f"{meth}(...)` in per-step code")
                return
            if meth == "double" and not node.args:
                self._add("PXK105", node, "`.double()` in kernel code")
                return
            if meth == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in [*node.args,
                              *(kw.value for kw in node.keywords)]):
                self._add("PXK104", node, "`.to(\"cpu\")` in kernel code")
                return
            if meth in SYNC_METHODS and not (
                    isinstance(recv, ast.Name)
                    and recv.id in self.repo_aliases):
                self._add("PXK104", node, f"`.{meth}()` in kernel code")
                return
        if name in SYNC_CALLS or (name == "torch.where"
                                  and len(node.args) == 1
                                  and not node.keywords):
            self._add("PXK104", node, f"`{name}(...)` in kernel code")
            return
        if isinstance(node.func, ast.Name) and name in SYNC_BUILTINS and \
                any(self.tensors.is_tensor(a) for a in node.args):
            self._add("PXK104", node, f"`{name}()` of a tensor "
                                      "expression in kernel code")

    def check_attribute(self, node: ast.Attribute) -> None:
        if id(node) in self._claimed:
            return
        name = _name(node)
        if not name:
            return
        if node.attr in ("float64", "double") and \
                name.split(".")[0] in ("np", "numpy", "torch"):
            self._add("PXK105", node, f"`{name}` in kernel code")
            return
        if name.startswith(("np.", "numpy.")) and \
                not name.startswith(("np.random.", "numpy.random.")) and \
                isinstance(getattr(node, "ctx", None), ast.Load):
            self._add("PXK102", node, f"`{name}` referenced in kernel "
                                      "code")

    def check_iteration(self, node: ast.AST) -> None:
        iters = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters = [node.iter]
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters = [g.iter for g in node.generators]
        for it in iters:
            if isinstance(it, ast.Set):
                self._add("PXK103", it, "iteration over a set literal in "
                                        "kernel code")
            elif isinstance(it, ast.Call) and \
                    _name(it.func) in ("set", "frozenset"):
                self._add("PXK103", it, f"iteration over "
                                        f"`{_name(it.func)}()` in kernel "
                                        "code — wrap in `sorted(...)`")

    def check_branch(self, node: ast.AST) -> None:
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.Assert, ast.IfExp)):
            tests = [node.test]
        elif isinstance(node, ast.comprehension):
            tests = list(node.ifs)
        for test in tests:
            if self.tensors.is_tensor(test):
                kind = ("if" if isinstance(node, ast.comprehension)
                        else type(node).__name__.lower())
                self._add("PXK104", node if not isinstance(
                    node, ast.comprehension) else test,
                    f"Python `{kind}` on a tensor expression "
                    f"(`{ast.unparse(test)[:60]}`) — use `torch.where`")
                return
        if isinstance(node, ast.BoolOp):
            # every operand but the last is converted to bool
            for v in node.values[:-1]:
                if self.tensors.is_tensor(v):
                    op = "and" if isinstance(node.op, ast.And) else "or"
                    self._add("PXK104", node,
                              f"Python `{op}` on a tensor expression "
                              f"(`{ast.unparse(v)[:60]}`) — use `&`/`|`")
                    return

    def check_constant(self, node: ast.Constant) -> None:
        if node.value == "float64":
            self._add("PXK105", node, "\"float64\" dtype string in "
                                      "kernel code")

    # -- driver -----------------------------------------------------------
    def run(self, body: Sequence[ast.AST]) -> List[Violation]:
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    self.check_call(node)
                elif isinstance(node, ast.Attribute):
                    self.check_attribute(node)
                elif isinstance(node, ast.Constant):
                    self.check_constant(node)
                if isinstance(node, (ast.For, ast.AsyncFor, ast.ListComp,
                                     ast.SetComp, ast.DictComp,
                                     ast.GeneratorExp)):
                    self.check_iteration(node)
                if isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp, ast.BoolOp,
                                     ast.comprehension)):
                    self.check_branch(node)
        return self.out


# ---------------------------------------------------------------------------
# the kernel surface
# ---------------------------------------------------------------------------


def _protocol_roots(tree: ast.Module, funcs: Dict[str, List[ast.AST]]
                    ) -> List[Tuple[ast.AST, str]]:
    """Functions wired as ``SimProtocol(...)`` entry points, each with its
    mode (``"step"`` or ``"init"``)."""
    roots: List[Tuple[ast.AST, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                _name(node.func).split(".")[-1] != "SimProtocol":
            continue
        for kw in node.keywords:
            if not isinstance(kw.value, ast.Name):
                continue
            mode = ("step" if kw.arg in PROTOCOL_STEP_KWARGS
                    else "init" if kw.arg in PROTOCOL_INIT_KWARGS else None)
            if mode is not None:
                roots += [(fn, mode) for fn in funcs.get(kw.value.id, [])]
    return roots


def _loop_bodies(fn: ast.AST) -> List[ast.stmt]:
    return [s for node in ast.walk(fn)
            if isinstance(node, (ast.For, ast.While)) for s in node.body]


class Surface:
    """The kernel surface over the project: ``(rel, def) -> mode``, mode
    ``"step"`` (every check) or ``"init"`` (the determinism codes), and
    the loop bodies that stand for ``run_steps``."""

    def __init__(self, root: Path, files: Sequence[Path]):
        self.index: ProjectIndex = shared_index(root, extra_files=files)
        self.root = Path(root).resolve()
        self.mode: Dict[Tuple[str, int], str] = {}
        self.defs: Dict[Tuple[str, int], ast.AST] = {}
        self.loops: Dict[str, List[Tuple[ast.AST, List[ast.stmt]]]] = {}
        work: List[Tuple[str, ast.AST, str]] = []
        for path in files:
            rel = astutil.rel(Path(path).resolve(), self.root)
            info = self.index.module(rel)
            if info is None:
                continue
            funcs = info.functions
            work += [(rel, fn, mode)
                     for fn, mode in _protocol_roots(info.tree, funcs)]
            if rel in KERNEL_LIB_MODULES:
                work += [(rel, n, "step") for n in info.tree.body
                         if isinstance(n, astutil.FuncNode)
                         and (rel, n.name) not in HOST_SIDE]
            if rel == RUNNER:
                for name in RUNNER_STEP_FUNCS:
                    work += [(rel, fn, "step")
                             for fn in funcs.get(name, [])]
                for name in RUNNER_LOOP_FUNCS:
                    for fn in funcs.get(name, []):
                        body = _loop_bodies(fn)
                        self.loops.setdefault(rel, []).append((fn, body))
                        work += [(r, f, "step")
                                 for r, f in self._callees(rel, body)]
        while work:
            rel, fn, mode = work.pop()
            if _cached(fn):
                continue          # built once, replayed from the cache
            key = (rel, id(fn))
            if self.mode.get(key) in (mode, "step"):
                continue
            self.mode[key] = mode
            self.defs[key] = fn
            work += [(r, t, mode) for r, t in self._callees(rel, [fn])]

    def _callees(self, rel: str, nodes: Sequence[ast.AST]
                 ) -> List[Tuple[str, ast.AST]]:
        """Top-level defs the nodes reference: module-local names, and
        calls or names the project index resolves to a module of the
        package (a nested def is checked as part of its enclosing def)."""
        info = self.index.module(rel)
        top_level = {n.name: n for n in info.tree.body
                     if isinstance(n, astutil.FuncNode)}
        out: List[Tuple[str, ast.AST]] = []
        for top in nodes:
            # ``f.launches += 1`` reads an attribute of f, it runs nothing
            bases = {id(n.value) for n in ast.walk(top)
                     if isinstance(n, ast.Attribute)}
            for node in ast.walk(top):
                tgt = None
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        id(node) not in bases:
                    # nested defs are checked with their enclosing def
                    if node.id in top_level:
                        out.append((rel, top_level[node.id]))
                        continue
                    tgt = self.index.resolve_symbol(rel, node.id)
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.ctx, ast.Load):
                    tgt = self.index.resolve_call(
                        rel, ast.Call(func=node, args=[], keywords=[]))
                if tgt is None or tgt[0] == rel and \
                        isinstance(node, ast.Name):
                    continue
                tinfo = self.index.module(tgt[0])
                if tinfo is not None:
                    out += [(tgt[0], f) for f in tinfo.tree.body
                            if isinstance(f, astutil.FuncNode)
                            and f.name == tgt[1]]
        return out


def _repo_aliases(index: ProjectIndex, rel: str) -> Set[str]:
    """Names a module binds to modules of the repo (``tr`` for the
    port's ``random``): their calls are the repo's, not the stdlib's."""
    info = index.module(rel)
    if info is None:
        return set()
    return {k for k, e in info.imports.items() if e.kind == "module"}


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    root = Path(root).resolve()
    defaults = list(astutil.iter_py(root, TARGETS))
    wanted = [Path(p).resolve() for p in (files if files is not None
                                          else defaults)]
    surface = Surface(root, sorted(set(defaults) | set(wanted)))
    # a whole-tree run reports wherever the surface reaches (a step's
    # helper may live outside the globs); a scoped run, its own files
    report = ({rel for rel, _ in surface.defs} if files is None
              else {astutil.rel(p, root) for p in wanted})
    seen: set = set()
    out: List[Violation] = []

    def emit(vs: List[Violation]) -> None:
        for v in vs:
            key = (v.path, v.line, v.col, v.code)
            if key not in seen:
                seen.add(key)
                out.append(v)

    for (rel, _), fn in sorted(surface.defs.items(),
                               key=lambda kv: (kv[0][0],
                                               kv[1].lineno)):
        if rel not in report:
            continue
        mode = surface.mode[(rel, id(fn))]
        checker = _KernelChecker(
            rel, fn, None if mode == "step" else DETERMINISM_CODES,
            _repo_aliases(surface.index, rel))
        emit(checker.run(fn.body if isinstance(fn.body, list)
                         else [fn.body]))
    for rel, loops in sorted(surface.loops.items()):
        if rel not in report:
            continue
        for fn, body in loops:
            emit(_KernelChecker(rel, fn, None,
                                _repo_aliases(surface.index, rel)
                                ).run(body))
    return sorted(out, key=lambda v: (v.path, v.line, v.col, v.code))


def flagged_spans(root: Path, violations: Sequence[Violation],
                  codes: Sequence[str] = ("PXK104", "PXK107")
                  ) -> Dict[str, List[Tuple[int, int]]]:
    """``path -> [(first, last)]``: the source lines of each flagged
    expression of ``codes`` (a branch's own line through its test's
    last, a call's whole extent), where a runtime sync report of that
    site may point."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    by_path: Dict[str, List[Violation]] = {}
    for v in violations:
        if v.code in codes:
            by_path.setdefault(v.path, []).append(v)
    for path, vs in by_path.items():
        tree, _ = astutil.parse_file(Path(root) / path)
        at = {}
        for node in ast.walk(tree):
            if hasattr(node, "lineno") and hasattr(node, "end_lineno"):
                test = getattr(node, "test", None)
                end = (test.end_lineno if isinstance(
                    node, (ast.If, ast.While, ast.Assert, ast.IfExp))
                    else node.end_lineno)
                key = (node.lineno, node.col_offset)
                at[key] = max(at.get(key, node.lineno), end)
        out[path] = sorted({(v.line, at.get((v.line, v.col), v.line))
                            for v in vs})
    return out
