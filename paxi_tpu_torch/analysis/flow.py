"""Interprocedural plumbing for the port's paxi-lint rule families (the
JAX package's ``analysis/flow.py``):

- :class:`ModuleModel` — classes, methods, module functions, self-attr
  assignments, and a name-based call graph (``self._foo()`` chains and
  bare local calls), with reachability queries;
- :func:`dominating_guards` — for every statement of a function, the
  set of branch conditions that *every* path from the function entry
  must pass through (with polarity).  Computed structurally: Python
  function bodies are reducible, so guard domination falls out of a
  single recursive pass that models if/elif/else, early
  return/raise/continue/break, loops and try blocks;
- :class:`SymEval` — a symbolic evaluator for the small integer
  expression language quorum thresholds are written in (``n//2+1``,
  ``-(-3*n//4)``, ``math.ceil(3*n/4)``, ``max(z-q+1, 1)``, ...),
  exact over rationals so ceil-division idioms cannot drift
  (:func:`min_satisfying` reads a quorum predicate's threshold off it);
- the replay-determinism taint plumbing (PXD14x): :func:`fabric_atom` /
  :func:`live_only` recognize the host tier's documented
  fabric-resolution guards (``host/node.py`` "resolved fabric under
  replay"), and :class:`ExprTaint` is the kind-tracking expression
  taint visitor the determinism rule walks functions with.

Nothing here reads an array library's idioms: the kernels' update forms
(``torch.where``, ``torch.maximum``) are recognised by the families that
consume this engine (``crossflow.py``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, \
    Set, Tuple

from paxi_tpu_torch.analysis import astutil

# ---------------------------------------------------------------------------
# module model + call graph
# ---------------------------------------------------------------------------


@dataclass
class FuncInfo:
    name: str
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    cls: Optional[str] = None      # owning class name (None: module level)
    # bare names and self-method names this function calls
    calls_self: Set[str] = field(default_factory=set)
    calls_bare: Set[str] = field(default_factory=set)


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    bases: List[str]
    methods: Dict[str, FuncInfo]
    # every attr ever assigned as ``self.X = ...`` / ``self.X: T = ...``
    # anywhere in the class body, plus AnnAssign dataclass-style fields
    attrs: Set[str]


def _self_call_name(call: ast.Call) -> Optional[str]:
    """``foo`` for ``self.foo(...)``."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "self":
        return f.attr
    return None


class ModuleModel:
    """Classes, functions and the module-local call graph of one file."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.classes: Dict[str, ClassInfo] = {}
        self.functions: Dict[str, FuncInfo] = {}
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = self._class_info(node)
            elif isinstance(node, astutil.FuncNode):
                self.functions[node.name] = self._func_info(node, None)

    def _class_info(self, cls: ast.ClassDef) -> ClassInfo:
        methods: Dict[str, FuncInfo] = {}
        attrs: Set[str] = set()
        for item in cls.body:
            if isinstance(item, astutil.FuncNode):
                methods[item.name] = self._func_info(item, cls.name)
            elif isinstance(item, ast.AnnAssign) and \
                    isinstance(item.target, ast.Name):
                attrs.add(item.target.id)    # dataclass-style field
            elif isinstance(item, ast.Assign):
                for t in item.targets:
                    if isinstance(t, ast.Name):
                        attrs.add(t.id)      # class-level default
        for node in ast.walk(cls):
            target = None
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    target = t
                    while isinstance(target, ast.Subscript):
                        target = target.value
                    if isinstance(target, ast.Attribute) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == "self":
                        attrs.add(target.attr)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Attribute) and \
                    isinstance(node.target.value, ast.Name) and \
                    node.target.value.id == "self":
                attrs.add(node.target.attr)
        bases = [astutil.dotted_name(b) or "" for b in cls.bases]
        return ClassInfo(cls.name, cls, bases, methods, attrs)

    def _func_info(self, fn: ast.AST, cls: Optional[str]) -> FuncInfo:
        info = FuncInfo(fn.name, fn, cls)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _self_call_name(node)
                if name is not None:
                    info.calls_self.add(name)
                elif isinstance(node.func, ast.Name):
                    info.calls_bare.add(node.func.id)
        return info

    def method(self, cls: str, name: str) -> Optional[FuncInfo]:
        ci = self.classes.get(cls)
        return ci.methods.get(name) if ci else None

    def reachable_methods(self, cls: str,
                          roots: Sequence[str]) -> List[FuncInfo]:
        """Closure of ``roots`` over ``self.foo()`` edges within one
        class (the interprocedural scope of the stage-2 rules)."""
        ci = self.classes.get(cls)
        if ci is None:
            return []
        seen: Dict[str, FuncInfo] = {}
        work = [r for r in roots if r in ci.methods]
        while work:
            name = work.pop()
            if name in seen:
                continue
            info = ci.methods[name]
            seen[name] = info
            work.extend(c for c in info.calls_self
                        if c in ci.methods and c not in seen)
        return list(seen.values())


# ---------------------------------------------------------------------------
# guard domination over a function body
# ---------------------------------------------------------------------------

# a guard atom: (comparison-or-test expression, polarity).  polarity
# True means the test held on every path reaching the statement,
# False means its negation held (the early-return idiom).
Guard = Tuple[ast.expr, bool]
GuardSet = FrozenSet[Guard]


def guard_atoms(test: ast.expr, polarity: bool) -> List[Guard]:
    """Decompose a branch test into atoms that definitely hold under
    ``polarity``: ``a and b`` true => both true; ``a or b`` false =>
    both false; ``not a`` flips.  Mixed cases keep the whole test as
    one opaque atom."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return guard_atoms(test.operand, not polarity)
    if isinstance(test, ast.BoolOp):
        if (isinstance(test.op, ast.And) and polarity) or \
                (isinstance(test.op, ast.Or) and not polarity):
            out: List[Guard] = []
            for v in test.values:
                out.extend(guard_atoms(v, polarity))
            return out
        return [(test, polarity)]
    return [(test, polarity)]


class _GuardWalk:
    """One structural pass computing, per statement, the guard atoms
    every entry path traverses.  ``None`` out-state means all paths
    through the construct terminated (return/raise/continue/break), so
    whatever follows is only reachable on the *other* branch — exactly
    the early-return domination the ballot rule needs."""

    def __init__(self) -> None:
        self.at: Dict[int, GuardSet] = {}

    def run(self, fn: ast.AST) -> Dict[int, GuardSet]:
        self._body(fn.body, frozenset())
        return self.at

    def _body(self, stmts: Sequence[ast.stmt],
              guards: Optional[GuardSet]) -> Optional[GuardSet]:
        for stmt in stmts:
            if guards is None:
                break               # unreachable; stop attributing
            guards = self._stmt(stmt, guards)
        return guards

    def _stmt(self, stmt: ast.stmt,
              guards: GuardSet) -> Optional[GuardSet]:
        self.at[id(stmt)] = guards
        if isinstance(stmt, (ast.Return, ast.Raise, ast.Continue,
                             ast.Break)):
            return None
        if isinstance(stmt, ast.If):
            t_in = guards | frozenset(guard_atoms(stmt.test, True))
            f_in = guards | frozenset(guard_atoms(stmt.test, False))
            t_out = self._body(stmt.body, t_in)
            f_out = self._body(stmt.orelse, f_in) if stmt.orelse else f_in
            if t_out is None:
                return f_out
            if f_out is None:
                return t_out
            return t_out & f_out
        if isinstance(stmt, (ast.While,)):
            self._body(stmt.body,
                       guards | frozenset(guard_atoms(stmt.test, True)))
            self._body(stmt.orelse, guards)
            return guards
        if isinstance(stmt, ast.For) or \
                isinstance(stmt, getattr(ast, "AsyncFor", ())):
            self._body(stmt.body, guards)   # 0-or-more iterations
            self._body(stmt.orelse, guards)
            return guards
        if isinstance(stmt, ast.With) or \
                isinstance(stmt, getattr(ast, "AsyncWith", ())):
            return self._body(stmt.body, guards)
        if isinstance(stmt, ast.Try):
            b_out = self._body(stmt.body, guards)
            # a handler can be entered from any point of the body: its
            # statements are only guaranteed the guards held at entry
            h_outs = [self._body(h.body, guards) for h in stmt.handlers]
            outs = [o for o in [b_out, *h_outs] if o is not None]
            merged: Optional[GuardSet]
            merged = (frozenset.intersection(*outs) if outs else None)
            if stmt.orelse and b_out is not None:
                e_out = self._body(stmt.orelse, b_out)
                outs2 = [o for o in [e_out, *h_outs] if o is not None]
                merged = (frozenset.intersection(*outs2) if outs2
                          else None)
            if stmt.finalbody:
                merged = self._body(stmt.finalbody,
                                    merged if merged is not None
                                    else guards)
            return merged
        if isinstance(stmt, astutil.FuncNode) or \
                isinstance(stmt, ast.ClassDef):
            return guards           # deferred body: not this pass's job
        if isinstance(stmt, ast.Assert):
            return guards | frozenset(guard_atoms(stmt.test, True))
        return guards


def dominating_guards(fn: ast.AST) -> Dict[int, GuardSet]:
    """``id(stmt) -> guard atoms`` for every statement of ``fn``.  An
    atom ``(test, True)`` means the test held on every path from the
    function entry to the statement; ``(test, False)`` means its
    negation held (e.g. statements after ``if test: return``)."""
    return _GuardWalk().run(fn)


# ---------------------------------------------------------------------------
# replay-determinism taint plumbing (stage 4, PXD14x)
# ---------------------------------------------------------------------------


def _is_fabric_value(expr: ast.AST) -> bool:
    """``<x>.fabric`` / bare ``fabric`` / ``current_fabric()`` — the
    spellings the host tier uses for "the attached virtual-clock
    fabric" (host/fabric.py)."""
    if isinstance(expr, ast.Attribute) and expr.attr == "fabric":
        return True
    if isinstance(expr, ast.Name) and expr.id == "fabric":
        return True
    if isinstance(expr, ast.Call):
        name = astutil.dotted_name(expr.func) or ""
        return name.split(".")[-1] == "current_fabric"
    return False


def fabric_atom(test: ast.expr) -> Optional[bool]:
    """What a guard test asserts about fabric attachment when it holds:
    ``True`` (a fabric IS attached), ``False`` (no fabric — the live
    serving path), or ``None`` (not a fabric test).  Recognizes
    ``x.fabric is [not] None`` and bare ``x.fabric`` truthiness."""
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and _is_fabric_value(test.left) \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value is None:
        if isinstance(test.ops[0], ast.Is):
            return False
        if isinstance(test.ops[0], ast.IsNot):
            return True
        return None
    if _is_fabric_value(test):
        return True
    return None


def live_only(guards: GuardSet) -> bool:
    """True when the guard set proves the statement runs only with NO
    fabric attached — the live serving path, which replay never
    reaches, so the PXD14x determinism obligations do not apply.  The
    polarity algebra: an atom ``(test, held)`` with
    ``fabric_atom(test) != held`` means every entry path established
    "no fabric" (either the test says so and held, or it says a fabric
    is attached and its negation held — the early-return idiom)."""
    for test, polarity in guards:
        fa = fabric_atom(test)
        if fa is not None and fa != polarity:
            return True
    return False


class ExprTaint(ast.NodeVisitor):
    """Which taint kinds does an expression carry?  ``tainted`` maps
    local names to a kind tag; ``root_of`` classifies any
    sub-expression as a fresh taint root (returning its kind, or
    None).  Fabric-resolution short circuits are sanctioned in place:
    in ``no_fabric and <e>`` / ``has_fabric or <e>`` / the matching
    ternary arms, ``<e>`` only evaluates on the live path and carries
    no replay taint.  Nested defs/lambdas are opaque, like every
    per-function walk in this package."""

    def __init__(self, tainted: Dict[str, str],
                 root_of: Optional[Callable[[ast.AST],
                                            Optional[str]]] = None):
        self.tainted = tainted
        self.root_of = root_of
        self.kinds: Set[str] = set()

    def visit(self, node: ast.AST):
        if self.root_of is not None:
            kind = self.root_of(node)
            if kind is not None:
                self.kinds.add(kind)
        return super().visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.tainted:
            self.kinds.add(self.tainted[node.id])

    def visit_BoolOp(self, node: ast.BoolOp) -> None:
        live = False
        for value in node.values:
            if not live:
                self.visit(value)
            fa = fabric_atom(value)
            if isinstance(node.op, ast.And) and fa is False:
                live = True                 # rest evaluates live-only
            elif isinstance(node.op, ast.Or) and fa is True:
                live = True

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self.visit(node.test)
        fa = fabric_atom(node.test)
        if fa is not False:
            self.visit(node.body)           # body is live-only when False
        if fa is not True:
            self.visit(node.orelse)         # orelse is live-only when True

    def visit_FunctionDef(self, node) -> None:   # nested defs: opaque
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def expr_taint(expr: ast.expr, tainted: Dict[str, str],
               root_of: Optional[Callable[[ast.AST],
                                          Optional[str]]] = None
               ) -> Set[str]:
    """The taint kinds ``expr`` carries under ``tainted``/``root_of``."""
    t = ExprTaint(tainted, root_of)
    t.visit(expr)
    return t.kinds


# ---------------------------------------------------------------------------
# symbolic integer expressions
# ---------------------------------------------------------------------------


class SymEval:
    """Evaluate the integer expression language of quorum arithmetic.

    ``env`` maps *source text* of name/attribute/call expressions to
    exact values (e.g. ``{"self.n": 5, "len(self.cfg.ids)": 5}``);
    ``resolve`` is an optional hook the quorum rule uses to chase
    attributes through their module-level/`__init__` assignments.
    Division is exact (:class:`fractions.Fraction`), so ``3*n/4`` and
    the ``-(-3*n//4)`` ceil idiom evaluate without float drift.
    Returns ``None`` for anything outside the language — the caller
    reports "unresolvable" rather than guessing.
    """

    def __init__(self, env: Dict[str, Fraction],
                 resolve: Optional[Callable[[str],
                                            Optional[ast.expr]]] = None,
                 funcs: Optional[Dict[str, Tuple[List[str],
                                                 ast.expr]]] = None):
        self.env = {k: Fraction(v) for k, v in env.items()}
        self.resolve = resolve
        # known single-return helpers: name -> (params, body expr), e.g.
        # core/quorum.py's majority_size(n) = n // 2 + 1
        self.funcs = funcs or {}
        self._resolving: Set[str] = set()

    # -- helpers ---------------------------------------------------------
    def _lookup(self, key: str) -> Optional[Fraction]:
        if key in self.env:
            return self.env[key]
        if self.resolve is not None and key not in self._resolving:
            self._resolving.add(key)
            try:
                expr = self.resolve(key)
                if expr is not None:
                    return self.eval(expr)
            finally:
                self._resolving.discard(key)
        return None

    # -- evaluation ------------------------------------------------------
    def eval(self, node: ast.expr) -> Optional[Fraction]:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return Fraction(int(node.value))
            if isinstance(node.value, (int, float)):
                return Fraction(node.value).limit_denominator(10**9)
            return None
        if isinstance(node, (ast.Name, ast.Attribute)):
            name = astutil.dotted_name(node)
            return self._lookup(name) if name else None
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if v is None:
                return None
            if isinstance(node.op, ast.USub):
                return -v
            if isinstance(node.op, ast.UAdd):
                return v
            return None
        if isinstance(node, ast.BinOp):
            left, right = self.eval(node.left), self.eval(node.right)
            if left is None or right is None:
                return None
            op = node.op
            if isinstance(op, ast.Add):
                return left + right
            if isinstance(op, ast.Sub):
                return left - right
            if isinstance(op, ast.Mult):
                return left * right
            if isinstance(op, ast.Div):
                return left / right if right != 0 else None
            if isinstance(op, ast.FloorDiv):
                return Fraction((left / right).__floor__()) \
                    if right != 0 else None
            if isinstance(op, ast.Mod):
                if right == 0:
                    return None
                return left - right * Fraction((left / right).__floor__())
            return None
        if isinstance(node, ast.Call):
            fname = astutil.dotted_name(node.func) or ""
            tail = fname.split(".")[-1]
            args = [self.eval(a) for a in node.args]
            if tail in ("max", "min") and args and None not in args:
                return (max if tail == "max" else min)(args)
            if tail == "abs" and len(args) == 1 and args[0] is not None:
                return abs(args[0])
            if tail == "ceil" and len(args) == 1 and args[0] is not None:
                return Fraction(-((-args[0]).__floor__()))
            if tail == "floor" and len(args) == 1 and args[0] is not None:
                return Fraction(args[0].__floor__())
            if tail in self.funcs and None not in args:
                params, body = self.funcs[tail]
                if len(params) == len(args):
                    child = SymEval(dict(zip(params, args)),
                                    funcs=self.funcs)
                    return child.eval(body)
            if tail == "len" and len(node.args) == 1:
                # len(...) resolves through env by source text
                return self._lookup(ast.unparse(node))
            # named size helpers etc. resolve through env/resolve by
            # their full call text (e.g. "majority_size(cfg.n)")
            return self._lookup(ast.unparse(node))
        if isinstance(node, ast.IfExp):
            test = self.eval_bool(node.test)
            if test is None:
                return None
            return self.eval(node.body if test else node.orelse)
        return None

    def eval_bool(self, node: ast.expr) -> Optional[bool]:
        """Comparison chains and boolean combinations over the same
        language (used to derive predicate thresholds)."""
        if isinstance(node, ast.Compare):
            left = self.eval(node.left)
            if left is None:
                return None
            for op, comp in zip(node.ops, node.comparators):
                right = self.eval(comp)
                if right is None:
                    return None
                ok = {ast.Gt: left > right, ast.GtE: left >= right,
                      ast.Lt: left < right, ast.LtE: left <= right,
                      ast.Eq: left == right,
                      ast.NotEq: left != right}.get(type(op))
                if ok is None or not ok:
                    return ok
                left = right
            return True
        if isinstance(node, ast.BoolOp):
            vals = [self.eval_bool(v) for v in node.values]
            if None in vals:
                return None
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            v = self.eval_bool(node.operand)
            return None if v is None else not v
        v = self.eval(node)
        return None if v is None else v != 0


def min_satisfying(predicate: ast.expr, count_key: str,
                   evaluator: SymEval, n: int) -> Optional[int]:
    """Smallest ``k`` in ``0..n`` making ``predicate`` true when
    ``count_key`` (e.g. ``"len(self.acks)"``) evaluates to ``k`` —
    i.e. the threshold a quorum predicate encodes for cluster size
    ``n``.  Returns ``None`` when unsatisfiable or unresolvable."""
    for k in range(0, n + 1):
        evaluator.env[count_key] = Fraction(k)
        ok = evaluator.eval_bool(predicate)
        if ok is None:
            return None
        if ok:
            return k
    return None
