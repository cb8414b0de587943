"""Measurement-isolation rule family (PXM10x) over the port's kernels (a
copy of the JAX package's ``analysis/measure.py``: the taint walk reads
no array library's idioms).

The on-device observability layer (metrics/lathist, sim/inscan) rides
in ``m_``-prefixed *measurement planes* inside protocol state.  The
architecture promises two things about them:

- they are **excluded from the trace witness hash**
  (``trace/replay.state_hash`` strips ``m_`` keys), so traces captured
  before a kernel grew an instrumentation plane replay hash-clean; and
- they are **write-only from the protocol's point of view**: a
  transition may *accumulate into* them, but no protocol decision —
  state write, message plane, guard — may ever *depend on* one.
  Otherwise "adding a histogram" could change commit behavior, and the
  hash exclusion would hide exactly the divergence it introduced.

This family enforces the second promise statically with a forward
taint walk over every ``step``/``_step`` function in the sim kernels
(the protocol logic; ``metrics``/``invariants`` are read-side exports
and oracles, where reading measurement planes is the whole point):

- a read of ``<anything>["m_..."]`` taints the expression;
- taint propagates through assignments, tuple unpacking, augmented
  assignments, and calls (any tainted argument taints the result);
- a dict construction **quarantines** taint carried under ``m_`` keys
  (the sanctioned store-back) but stays tainted if a tainted value
  sits under a non-``m_`` key.

Checks:

- **PXM101** a tainted value is stored under a non-``m_`` dict key —
  a measurement plane feeding protocol state or an outbox plane.
- **PXM102** a tainted value escapes through a ``return`` (outside the
  quarantined dict form) — e.g. ``return m_hist`` from a transition.

Two additions to the JAX package's walk, for the port's helper-built
planes: a subscript store ``out[key] = v`` taints ``out`` unless ``key``
is an m_ key (an f-string key counts by its constant head), and a call
to a helper the project index resolves is judged by that helper's own
walk — its result is clean when every return keeps tainted arguments
under m_ keys (``workload/compile.class_hist_planes``), else tainted as
any call with a tainted argument is.

Loop bodies are walked twice (wrap-around taint).  The walk is intentionally conservative: a false
positive is an invitation to restructure the write so the quarantine
is syntactically evident, which is what keeps the property auditable.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Set

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation
from paxi_tpu_torch.analysis.project import ProjectIndex, shared_index

RULE = "measurement-isolation"

TARGETS = (
    "paxi_tpu_torch/protocols/*/sim*.py",
    "paxi_tpu_torch/trace/demo.py",
)

def _is_step_name(name: str) -> bool:
    """Transition functions: ``step``, ``_step``, and ``*_step``
    variants (seeded twins / fixtures follow the same convention)."""
    return name in ("step", "_step") or name.endswith("_step")


def _is_m_key(node: ast.expr) -> Optional[bool]:
    """True/False for a constant-string dict key; None when dynamic."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("m_")
    return None


class _Taint(ast.NodeVisitor):
    """Expression-taint query against a set of tainted names."""

    def __init__(self, tainted: Set[str], summarize=None):
        self.tainted = tainted
        self.summarize = summarize
        self.hit = False

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.tainted:
            self.hit = True

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # the taint SOURCE: state["m_..."] (any base expression)
        if _is_m_key(node.slice) is True:
            self.hit = True
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict) -> None:
        # quarantine: values under m_ keys do not taint the dict
        for k, v in zip(node.keys, node.values):
            if k is not None and _is_m_key(k) is True:
                continue
            if k is None:                      # **expansion
                self.visit(v)
                continue
            self.visit(k)
            self.visit(v)

    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Name) and node.func.id == "dict"):
            for a in node.args:
                self.visit(a)
            for kw in node.keywords:
                if kw.arg is not None and kw.arg.startswith("m_"):
                    continue                   # quarantined kwarg
                self.visit(kw.value)
            return
        if self.summarize is not None and \
                self.summarize(node, self.tainted) is False:
            return                             # the helper quarantines
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:  # nested defs: opaque
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _tainted(expr: ast.expr, tainted: Set[str], summarize=None) -> bool:
    t = _Taint(tainted, summarize)
    t.visit(expr)
    return t.hit


def _m_key_store(key: ast.expr) -> Optional[bool]:
    """Like ``_is_m_key`` for a subscript store's key, where an f-string
    key counts by its constant head (``out[f"m_wl_hist_{nm}"]``)."""
    if isinstance(key, ast.JoinedStr) and key.values and \
            isinstance(key.values[0], ast.Constant) and \
            isinstance(key.values[0].value, str):
        return key.values[0].value.startswith("m_") or None
    return _is_m_key(key)


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    return []


class _StepWalker:
    """Forward taint walk over one step function's body."""

    def __init__(self, rel: str, out: List[Violation], summarize=None):
        self.rel = rel
        self.out = out
        self.summarize = summarize
        self.tainted: Set[str] = set()
        self.reported: Set[tuple] = set()

    def _t(self, expr: ast.expr) -> bool:
        return _tainted(expr, self.tainted, self.summarize)

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        key = (node.lineno, code)
        if key in self.reported:
            return
        self.reported.add(key)
        self.out.append(Violation(
            rule=RULE, code=code, path=self.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    def _check_dicts(self, expr: ast.expr) -> None:
        """PXM101 at every dict construction with a tainted non-m_
        value, anywhere inside ``expr``."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    mk = None if k is None else _is_m_key(k)
                    if mk is not True and self._t(v):
                        key = (k.value if isinstance(k, ast.Constant)
                               else "<dynamic>")
                        self._flag(
                            "PXM101", v,
                            f"measurement-plane value stored under "
                            f"non-m_ key {key!r}: protocol state/"
                            f"messages must never depend on m_ planes")
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Name)
                  and node.func.id == "dict"):
                for kw in node.keywords:
                    if kw.arg is not None and kw.arg.startswith("m_"):
                        continue
                    if self._t(kw.value):
                        self._flag(
                            "PXM101", kw.value,
                            f"measurement-plane value stored under "
                            f"non-m_ key {kw.arg or '**'!r}: protocol "
                            f"state/messages must never depend on m_ "
                            f"planes")

    def _walk(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                        # nested defs: opaque
            if isinstance(stmt, ast.Assign):
                self._check_dicts(stmt.value)
                names = [n for t in stmt.targets
                         for n in _target_names(t)]
                if self._t(stmt.value):
                    self.tainted.update(names)
                    # ``out[key] = v``: the dict carries v unless the key
                    # is an m_ key (the store-back form of the quarantine)
                    self.tainted.update(
                        t.value.id for t in stmt.targets
                        if isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and _m_key_store(t.slice) is not True)
                else:
                    self.tainted.difference_update(names)
                continue
            if isinstance(stmt, ast.AugAssign):
                self._check_dicts(stmt.value)
                if self._t(stmt.value):
                    self.tainted.update(_target_names(stmt.target))
                continue
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._check_dicts(stmt.value)
                names = _target_names(stmt.target)
                if self._t(stmt.value):
                    self.tainted.update(names)
                else:
                    self.tainted.difference_update(names)
                continue
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    self._check_dicts(stmt.value)
                    if self._t(stmt.value):
                        self._flag(
                            "PXM102", stmt,
                            "measurement-plane value escapes through "
                            "return outside an m_-keyed dict entry")
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                # two passes for wrap-around taint (asyncflow precedent)
                self._walk(stmt.body)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, ast.If):
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, ast.With):
                self._walk(stmt.body)
                continue
            if isinstance(stmt, ast.Expr):
                self._check_dicts(stmt.value)
                continue
        # other statement kinds carry no interesting dataflow here


class _Summaries:
    """Whether a helper's result carries measurement taint, given which of
    its arguments do: the callee (resolved through the project index) is
    walked with those parameters tainted, and its result is clean when
    every return keeps the taint under m_ keys — a dict a helper builds
    and returns is the quarantine form at one remove."""

    MAX_DEPTH = 2

    def __init__(self, index: ProjectIndex, rel: str, depth: int = 0,
                 cache: Optional[dict] = None):
        self.index = index
        self.rel = rel
        self.depth = depth
        self.cache = {} if cache is None else cache

    def __call__(self, call: ast.Call, tainted: Set[str]) -> Optional[bool]:
        args = [*call.args, *(kw.value for kw in call.keywords)]
        # a summary only ever clears taint: no tainted argument, nothing
        # to judge
        if self.depth >= self.MAX_DEPTH or \
                not any(_tainted(a, tainted) for a in args):
            return None
        if any(isinstance(a, ast.Starred) for a in call.args) or any(
                kw.arg is None for kw in call.keywords):
            return None
        tgt = self.index.resolve_call(self.rel, call)
        if tgt is None:
            return None
        fn = self.index.function_def(*tgt)
        if fn is None or not isinstance(fn, ast.FunctionDef):
            return None
        params = [a.arg for a in [*fn.args.posonlyargs, *fn.args.args,
                                  *fn.args.kwonlyargs]]
        bound = {p for p, a in zip(params, call.args)
                 if _tainted(a, tainted, self)}
        bound |= {kw.arg for kw in call.keywords
                  if kw.arg in params and _tainted(kw.value, tainted, self)}
        key = (tgt, frozenset(bound), self.depth)
        if key not in self.cache:
            inner = _Summaries(self.index, tgt[0], self.depth + 1,
                               self.cache)
            walker = _StepWalker(tgt[0], [], inner)
            walker.tainted = set(bound)
            walker._walk(fn.body)
            walker._walk(fn.body)
            self.cache[key] = any(
                isinstance(r, ast.Return) and r.value is not None
                and walker._t(r.value) for r in ast.walk(fn))
        return self.cache[key]


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = [Path(p) for p in (files if files is not None
                               else astutil.iter_py(root, TARGETS))]
    index = shared_index(root, extra_files=paths)
    cache: dict = {}
    out: List[Violation] = []
    for path in paths:
        try:
            tree = ast.parse(path.read_text())
        except (OSError, SyntaxError):
            continue
        rel = astutil.rel(path, root)
        for node in ast.walk(tree):
            if (isinstance(node, ast.FunctionDef)
                    and _is_step_name(node.name)):
                walker = _StepWalker(rel, out,
                                     _Summaries(index, rel, cache=cache))
                # two passes over the whole body: a later stamp into a
                # name read earlier (scan-carry style) still taints
                walker._walk(node.body)
                walker._walk(node.body)
    return sorted(out, key=lambda v: (v.path, v.line, v.code))
