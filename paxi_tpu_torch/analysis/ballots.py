"""Ballot-guard domination rule family (PXB6xx).

The second half of the decomposed safety obligation (see quorum.py for
the first): every handler of a ballot-carrying message may only touch
acceptor/replica state *under* a ballot comparison against the
incoming message, and the ballot register itself must be monotone.
That is the textbook acceptor contract (promise/accept guards), the
Bipartisan Paxos per-module proof obligation, and — per the cloud-Paxos
experience report — exactly the discipline that silently erodes as
handlers grow retry/recovery side paths.

Mechanics (analysis/flow.py):

- a handler is in scope when its registered wire message declares a
  ballot-like field (``ballot``, ``bal``, ``gen``, ``ver``, ``ts``,
  ``term``, ``view``, ``counter`` — the names this repo's protocols
  use for monotone epoch state);
- a *ballot comparison* is any comparison with a message-derived
  ballot term on one side and replica state (a ``self.`` expression or
  a local derived from one) on the other;
- a write is **guard-dominated** when every path from the handler
  entry to the write crosses such a comparison
  (:func:`flow.dominating_guards` — early returns count, which is how
  most handlers here are written);
- the analysis is interprocedural over ``self._helper(...)`` chains
  (module-local, depth-bounded): a callee inherits the call site's
  guards, and its parameters inherit message-ness from the arguments.

Checks:

- **PXB601** a handler (or helper reached from one) writes a
  ballot-like ``self`` attribute with no dominating ballot comparison
- **PXB602** a ballot-like attribute assignment that can go
  *backwards*: the RHS is not monotone by construction (``max``,
  ``next_ballot``, ``+= k``) and the dominating comparisons do not
  establish ``new >= old`` (e.g. guarded only by ``!=``)
- **PXB603** a write into a replicated-state container
  (``self.log[m.slot] = ...``) keyed or valued from the message, with
  no dominating ballot comparison — accepting without checking the
  promise
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation

RULE = "ballot-guard"

TARGETS = (
    "paxi_tpu_torch/protocols/*/host.py",
    "paxi_tpu_torch/trace/demo_host.py",
)

# monotone-epoch field names used across this repo's protocols
BALLOTISH = frozenset({"ballot", "bal", "term", "view", "gen", "ver",
                       "ts", "counter"})

# RHS call names that are monotone by construction
MONOTONE_CALLS = ("next_", "max")

MAX_DEPTH = 4


# ---------------------------------------------------------------------------
# message / state term detection
# ---------------------------------------------------------------------------


@dataclass
class Ctx:
    """Message-ness of one function's names, for one call chain."""

    msg_roots: FrozenSet[str]      # params holding the whole message
    msg_scalars: FrozenSet[str]    # params holding a ballot field value
    chain_guarded: bool            # a ballot cmp dominated the call site
    root_handler: str              # for the report
    depth: int = 0


def _locals_of(fn: ast.AST, ctx: Ctx) -> Tuple[Set[str], Set[str]]:
    """(message-derived locals, state-derived locals) — a pre-pass over
    all assignments, order-insensitive (over-approximates both ways,
    which for guard detection errs toward accepting real guards)."""
    msg, state = set(ctx.msg_roots | ctx.msg_scalars), set()
    for _ in range(2):             # two rounds: alias-of-alias
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            names = []
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    names.extend(e.id for e in t.elts
                                 if isinstance(e, ast.Name))
            if not names:
                continue
            if _mentions_msg(node.value, msg):
                msg.update(names)
            if _mentions_state(node.value, state):
                state.update(names)
    return msg, state


def _mentions_msg(expr: ast.AST, msg_names: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in msg_names:
            return True
    return False


def _mentions_state(expr: ast.AST, state_locals: Set[str]) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and (
                node.id == "self" or node.id in state_locals):
            return True
    return False


def _msg_ballot_term(expr: ast.AST, msg_roots: Set[str],
                     msg_scalars: Set[str]) -> bool:
    """Does ``expr`` contain a message-derived ballot value —
    ``m.ballot``-style attribute access or a scalar already known to
    carry one?"""
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in BALLOTISH \
                and isinstance(node.value, ast.Name) and \
                node.value.id in msg_roots:
            return True
        if isinstance(node, ast.Name) and node.id in msg_scalars:
            return True
    return False


def _monotone_merge(value: ast.expr) -> bool:
    """``max(self.front.get(k, 0), m.execute)``-style merges compare
    against the current state by construction."""
    for node in ast.walk(value):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id in ("max", "min") and \
                any(_mentions_state(a, set()) for a in node.args):
            return True
    return False


def _is_ballot_cmp(test: ast.expr, msg_roots: Set[str],
                   msg_scalars: Set[str],
                   state_locals: Set[str]) -> bool:
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        has_msg = [
            _msg_ballot_term(s, msg_roots, msg_scalars) for s in sides]
        has_state = [_mentions_state(s, state_locals) for s in sides]
        # a message-derived ballot on one side, replica state on a
        # DIFFERENT side (a local can legitimately be both — an entry
        # looked up by a message key is state)
        if any(m and any(s for j, s in enumerate(has_state) if j != i)
               for i, m in enumerate(has_msg)):
            return True
    return False


# ---------------------------------------------------------------------------
# module facts: wire classes, dispatch table, handler params
# ---------------------------------------------------------------------------


def _wire_fields(tree: ast.Module) -> Dict[str, Set[str]]:
    """@register_message class -> declared field names."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        decs = astutil.decorator_names(node)
        if not any(d.split(".")[-1] == "register_message" for d in decs):
            continue
        fields = {item.target.id for item in node.body
                  if isinstance(item, ast.AnnAssign)
                  and isinstance(item.target, ast.Name)}
        out[node.name] = fields
    return out


def _dispatch(tree: ast.Module) -> List[Tuple[str, str]]:
    """(message class name, handler method name) per register() call."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "register" and len(node.args) >= 2:
            cls = node.args[0]
            h = node.args[1]
            cls_name = cls.id if isinstance(cls, ast.Name) else None
            h_name = (h.attr if isinstance(h, ast.Attribute)
                      else h.id if isinstance(h, ast.Name) else None)
            if cls_name and h_name:
                out.append((cls_name, h_name))
    return out


def _msg_param(fn: ast.AST) -> Optional[str]:
    args = [a.arg for a in fn.args.args if a.arg != "self"]
    return args[0] if args else None


# ---------------------------------------------------------------------------
# the checker
# ---------------------------------------------------------------------------


class _Checker:
    def __init__(self, relpath: str, model: flow.ModuleModel,
                 cls: flow.ClassInfo):
        self.relpath = relpath
        self.model = model
        self.cls = cls
        self.out: List[Violation] = []
        self._guards_cache: Dict[int, Dict[int, flow.GuardSet]] = {}
        self._reported: Set[Tuple[int, int, str]] = set()
        self._visited: Set[Tuple[str, FrozenSet[str], FrozenSet[str],
                                 bool]] = set()

    def _guards(self, fn: ast.AST) -> Dict[int, flow.GuardSet]:
        g = self._guards_cache.get(id(fn))
        if g is None:
            g = flow.dominating_guards(fn)
            self._guards_cache[id(fn)] = g
        return g

    def _add(self, code: str, node: ast.AST, msg: str) -> None:
        key = (node.lineno, node.col_offset, code)
        if key in self._reported:
            return
        self._reported.add(key)
        self.out.append(Violation(
            rule=RULE, code=code, path=self.relpath,
            line=node.lineno, col=node.col_offset, message=msg))

    # -- one function under one context ---------------------------------
    def run(self, fn: ast.AST, ctx: Ctx) -> None:
        key = (fn.name, ctx.msg_roots, ctx.msg_scalars,
               ctx.chain_guarded)
        if key in self._visited or ctx.depth > MAX_DEPTH:
            return
        self._visited.add(key)
        guards = self._guards(fn)
        msg_locals, state_locals = _locals_of(fn, ctx)
        roots = set(ctx.msg_roots)
        scalars = set(ctx.msg_scalars) | (msg_locals - roots)

        def guarded_at(stmt: ast.stmt) -> bool:
            if ctx.chain_guarded:
                return True
            atoms = guards.get(id(stmt), frozenset())
            return any(_is_ballot_cmp(test, roots, scalars,
                                      state_locals)
                       for test, _pol in atoms)

        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.stmt) or id(stmt) not in guards:
                continue
            self._check_writes(fn, stmt, ctx, roots, scalars,
                               state_locals, guarded_at)
            self._follow_calls(stmt, ctx, roots, scalars, guarded_at)

    # -- writes ----------------------------------------------------------
    def _check_writes(self, fn, stmt, ctx, roots, scalars,
                      state_locals, guarded_at) -> None:
        targets: List[Tuple[ast.expr, Optional[ast.expr], bool]] = []
        if isinstance(stmt, ast.Assign):
            targets = [(t, stmt.value, False) for t in stmt.targets]
        elif isinstance(stmt, ast.AugAssign):
            targets = [(stmt.target, stmt.value, True)]
        for target, value, aug in targets:
            # self.<ballotish> = ...
            if isinstance(target, ast.Attribute) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == "self" and \
                    target.attr in BALLOTISH:
                if not guarded_at(stmt):
                    self._add(
                        "PXB601", stmt,
                        f"`self.{target.attr}` written in a path from "
                        f"handler `{ctx.root_handler}` with no "
                        "dominating ballot comparison against the "
                        "incoming message — the acceptor promise is "
                        "not checked")
                elif not aug:
                    self._check_monotone(fn, stmt, target, value, ctx,
                                         roots, scalars)
                elif isinstance(stmt.op, ast.Sub):
                    self._add(
                        "PXB602", stmt,
                        f"`self.{target.attr} -= ...` in a path from "
                        f"handler `{ctx.root_handler}` — epoch state "
                        "must be monotone")
                continue
            # self.<container>[k] = ... keyed/valued from the message
            base = target
            subscripted = False
            while isinstance(base, ast.Subscript):
                subscripted = True
                base = base.value
            if subscripted and isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                key_or_val_msg = _mentions_msg(target, roots | scalars) \
                    or (value is not None
                        and _mentions_msg(value, roots | scalars))
                if key_or_val_msg and value is not None and \
                        _monotone_merge(value):
                    continue         # max-merge carries its own compare
                if key_or_val_msg and not guarded_at(stmt):
                    self._add(
                        "PXB603", stmt,
                        f"message-derived write into "
                        f"`self.{base.attr}[...]` in a path from "
                        f"handler `{ctx.root_handler}` with no "
                        "dominating ballot comparison — state accepted "
                        "without checking the promise")

    def _check_monotone(self, fn, stmt, target, value, ctx, roots,
                        scalars) -> None:
        """The write is ballot-guarded; verify the guard direction (or
        the RHS shape) forbids a decrease."""
        attr_text = f"self.{target.attr}"
        if value is None:
            return
        # monotone by construction?
        for node in ast.walk(value):
            if isinstance(node, ast.Call):
                name = (astutil.dotted_name(node.func) or ""
                        ).split(".")[-1]
                if name.startswith(MONOTONE_CALLS[0]) or \
                        name == "max":
                    return
        if isinstance(value, ast.BinOp) and \
                isinstance(value.op, ast.Add):
            return                   # old + k idiom (k checked by review)
        rhs_text = ast.unparse(value)
        atoms = self._guards(fn).get(id(stmt), frozenset())
        for test, pol in atoms:
            for node in ast.walk(test):
                if not (isinstance(node, ast.Compare)
                        and len(node.ops) == 1):
                    continue
                lhs, op, rhs = (ast.unparse(node.left), node.ops[0],
                                ast.unparse(node.comparators[0]))
                pairs = {(lhs, rhs): False, (rhs, lhs): True}
                if (rhs_text, attr_text) not in pairs and \
                        (attr_text, rhs_text) not in pairs:
                    continue
                new_on_left = (lhs == rhs_text)
                # does (test, pol) imply NEW >= OLD ?
                ok = {
                    (ast.Gt, True, True), (ast.GtE, True, True),
                    (ast.Lt, False, True), (ast.LtE, False, True),
                    (ast.Eq, True, True), (ast.Eq, True, False),
                    (ast.Lt, True, False), (ast.LtE, True, False),
                    (ast.Gt, False, False), (ast.GtE, False, False),
                }
                if (type(op), pol, new_on_left) in ok:
                    return
        if _msg_ballot_term(value, roots, scalars) or \
                isinstance(value, ast.Constant):
            self._add(
                "PXB602", stmt,
                f"`{attr_text} = {rhs_text}` in a path from handler "
                f"`{ctx.root_handler}`: no dominating comparison "
                f"establishes `{rhs_text} >= {attr_text}` — the "
                "assignment can move the ballot backwards")

    # -- interprocedural -------------------------------------------------
    def _follow_calls(self, stmt, ctx, roots, scalars,
                      guarded_at) -> None:
        # only the statement's OWN expressions: a compound statement's
        # body is visited as separate statements with their own (deeper)
        # guard sets — following its subtree here would re-enter callees
        # under the weaker outer guards
        calls: List[ast.Call] = []
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                calls.extend(n for n in ast.walk(child)
                             if isinstance(n, ast.Call))
        for node in calls:
            if not (isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                continue
            callee = self.cls.methods.get(node.func.attr)
            if callee is None:
                continue
            params = [a.arg for a in callee.node.args.args
                      if a.arg != "self"]
            new_roots: Set[str] = set()
            new_scalars: Set[str] = set()
            for p, arg in zip(params, node.args):
                if isinstance(arg, ast.Name) and arg.id in roots:
                    new_roots.add(p)
                elif _msg_ballot_term(arg, roots, scalars):
                    new_scalars.add(p)
                elif _mentions_msg(arg, roots | scalars):
                    new_scalars.add(p)
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                if isinstance(kw.value, ast.Name) and \
                        kw.value.id in roots:
                    new_roots.add(kw.arg)
                elif _mentions_msg(kw.value, roots | scalars):
                    new_scalars.add(kw.arg)
            if not (new_roots or new_scalars):
                continue             # no message flow: out of scope
            self.run(callee.node, Ctx(
                msg_roots=frozenset(new_roots),
                msg_scalars=frozenset(new_scalars),
                chain_guarded=guarded_at(stmt),
                root_handler=ctx.root_handler,
                depth=ctx.depth + 1))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_file(path: Path, root: Path) -> List[Violation]:
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    model = flow.ModuleModel(tree)
    fields = _wire_fields(tree)
    out: List[Violation] = []
    for cls in model.classes.values():
        checker = _Checker(relpath, model, cls)
        for msg_cls, handler in _dispatch(cls.node):
            ballots = fields.get(msg_cls, set()) & BALLOTISH
            if not ballots:
                continue             # no epoch field: nothing to guard
            info = cls.methods.get(handler)
            if info is None:
                continue
            param = _msg_param(info.node)
            if param is None:
                continue
            checker.run(info.node, Ctx(
                msg_roots=frozenset({param}),
                msg_scalars=frozenset(),
                chain_guarded=False,
                root_handler=f"{cls.name}.{handler}"))
        out.extend(checker.out)
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root))
    return out
