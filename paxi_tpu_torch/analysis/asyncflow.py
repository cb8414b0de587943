"""Async-atomicity rule family (PXA9xx) — interleaving races the
lockset rules cannot see.

The host serving path (``host/``) is a heavily-async pipeline: one event
loop, hundreds of coroutines, almost no locks — asyncio code takes no
locks because *between* suspension points a coroutine is atomic.  The
flip side is the whole safety argument: any read-modify-write on
shared ``self`` state that SPANS a suspension point is a race, because
another task can run at the ``await`` and change the state under the
saved value or the already-taken branch.  PXC's lockset analysis is
blind to this (there is no lock to drop); the hunt engine finds these
only dynamically, one witness at a time.  This family is the static
closure of that bug class.

Model (one linear walk per method, loop bodies walked twice so
wrap-around staleness is seen):

- a **suspension point** is an ``await`` expression, an ``async for``
  iteration or an ``async with`` entry;
- an observation of ``self.X`` (a guard test, or a local snapshot
  ``v = self.X``) goes **stale** when a suspension point passes;
- a write to ``self.X`` (assignment, augmented assignment, item write,
  ``del``, or a mutating container call) **fires** when its value uses
  a stale snapshot of ``X`` or its taken branch is a stale guard on
  ``X`` — unless ``self.X`` was re-read after the suspension
  (re-validation makes the decision fresh again).

Checks:

- **PXA901** a read-modify-write on ``self`` state spans an ``await``
  without re-validation (the lost-update / check-then-act shapes);
- **PXA902** the same split across a *deferral*: a nested
  def/lambda handed to ``call_soon``/``call_later``/``create_task``/
  ``add_done_callback`` (or stored on ``self``) writes ``self.X``
  from a captured pre-scheduling snapshot of ``X`` without re-reading
  it — the resumption point is the deferral boundary;
- **PXA903** a suspension point inside ``with self.<threading lock>``:
  holding a sync lock across an ``await`` stalls the entire event loop
  (asyncio locks are exempt — awaiting under them is their purpose).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.concurrency import MUTATORS
from paxi_tpu_torch.analysis.model import Violation

RULE = "async-atomicity"

TARGETS = (
    "paxi_tpu_torch/host/*.py",
)

# sinks whose callable argument runs at a later event-loop tick
_DEFER_RE = re.compile(
    r"(call_soon|call_later|call_at|create_task|ensure_future|"
    r"add_done_callback|run_in_executor|submit)$")

# sync lock factories (asyncio.Lock is exempt: awaiting under it is
# the point; threading locks held across an await block the loop)
_SYNC_LOCKS = frozenset({"threading.Lock", "threading.RLock",
                         "threading.Condition", "Lock", "RLock",
                         "Condition"})


def _self_attr(node: ast.AST) -> Optional[str]:
    """``x`` for ``self.x`` (through subscripts)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _walk_live(node: ast.AST):
    """``ast.walk`` minus the bodies of nested defs/lambdas — code
    that runs at a later tick, not when this statement executes.  (A
    bare ``continue`` on the def node inside an ``ast.walk`` loop does
    NOT prune: walk queues children before yielding.  Unpruned walks
    both over-report — an ``await`` inside a deferred ``async def``
    read as suspending under a lock — and under-report — a
    ``self.X`` load inside a stored lambda counted as re-validation.)"""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if not isinstance(c, (ast.Lambda, *astutil.FuncNode)):
                stack.append(c)


def _attr_loads(expr: ast.AST) -> Set[str]:
    """Every ``self.X`` loaded anywhere in an expression (nested
    def/lambda bodies excluded — those loads happen at call time)."""
    out: Set[str] = set()
    for n in _walk_live(expr):
        if isinstance(n, ast.Attribute) and \
                isinstance(n.ctx, ast.Load) and \
                isinstance(n.value, ast.Name) and n.value.id == "self":
            out.add(n.attr)
    return out


def _has_await(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Await) for n in _walk_live(node))


def _sync_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            if astutil.dotted_name(node.value.func) in _SYNC_LOCKS:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        out.add(attr)
    return out


# ---------------------------------------------------------------------------
# the linear walker
# ---------------------------------------------------------------------------


@dataclass
class _Guard:
    attrs: Set[str]               # self attrs the test mentions
    crossed: bool = False         # a suspension passed since the test


@dataclass
class _State:
    """Mutable walk state.  ``fresh`` holds attrs whose last
    observation is on this side of every suspension; ``local_src``
    maps locals to the self attrs their value snapshots; ``crossed``
    holds locals whose snapshot predates a suspension."""

    fresh: Set[str] = field(default_factory=set)
    local_src: Dict[str, Set[str]] = field(default_factory=dict)
    crossed: Set[str] = field(default_factory=set)

    def copy(self) -> "_State":
        return _State(set(self.fresh),
                      {k: set(v) for k, v in self.local_src.items()},
                      set(self.crossed))

    def merge(self, other: "_State") -> None:
        self.fresh &= other.fresh          # stale on either path wins
        for k, v in other.local_src.items():
            self.local_src.setdefault(k, set()).update(v)
        self.crossed |= other.crossed


class _MethodWalk:
    def __init__(self, relpath: str, cls: str, method: str,
                 code: str = "PXA901"):
        self.relpath = relpath
        self.cls = cls
        self.method = method
        self.code = code
        self.guards: List[_Guard] = []
        self.out: List[Violation] = []
        self._seen: Set[Tuple[int, str]] = set()

    # -- reporting --------------------------------------------------------
    def _add(self, node: ast.AST, attr: str, why: str) -> None:
        key = (node.lineno, attr)
        if key in self._seen:
            return
        self._seen.add(key)
        boundary = ("an `await`" if self.code == "PXA901"
                    else "the deferral boundary")
        self.out.append(Violation(
            rule=RULE, code=self.code, path=self.relpath,
            line=node.lineno, col=node.col_offset,
            message=(
                f"read-modify-write on `self.{attr}` in "
                f"`{self.cls}.{self.method}` spans {boundary} "
                f"({why}) without re-reading `self.{attr}` — another "
                "task can change it at the suspension point")))

    # -- suspension -------------------------------------------------------
    def _suspend(self, st: _State) -> None:
        st.fresh.clear()
        st.crossed.update(st.local_src)
        for g in self.guards:
            g.crossed = True

    # -- per-statement ----------------------------------------------------
    def _observe(self, expr: ast.AST, st: _State) -> None:
        st.fresh |= _attr_loads(expr)

    def _bind_locals(self, stmt: ast.stmt, st: _State) -> None:
        if isinstance(stmt, ast.Assign):
            srcs = _attr_loads(stmt.value)
            # transitive: a local built from another snapshot local —
            # and copying a CROSSED snapshot keeps it crossed
            # (``w = v`` after the await must not launder v's
            # staleness into a fresh-looking name)
            tainted = False
            for n in _walk_live(stmt.value):
                if isinstance(n, ast.Name) and n.id in st.local_src:
                    srcs |= st.local_src[n.id]
                    if n.id in st.crossed:
                        tainted = True
            for t in stmt.targets:
                names = [t] if isinstance(t, ast.Name) else (
                    [e for e in t.elts if isinstance(e, ast.Name)]
                    if isinstance(t, (ast.Tuple, ast.List)) else [])
                for n in names:
                    if srcs:
                        st.local_src[n.id] = set(srcs)
                        if tainted:
                            st.crossed.add(n.id)
                        else:
                            st.crossed.discard(n.id)
                    else:
                        st.local_src.pop(n.id, None)
                        st.crossed.discard(n.id)

    def _check_write(self, target: ast.AST, value: Optional[ast.AST],
                     stmt: ast.stmt, st: _State,
                     mutator: bool = False) -> None:
        attr = _self_attr(target)
        if attr is None:
            # mutator through a snapshot alias of a self attr (an
            # assignment to a plain local is just a local)
            if mutator and isinstance(target, ast.Name) and \
                    target.id in st.local_src and \
                    len(st.local_src[target.id]) == 1:
                attr = next(iter(st.local_src[target.id]))
            else:
                return
        if attr in st.fresh:
            return                     # re-validated after the await
        # (i) the written value uses a stale snapshot of the same attr
        if value is not None:
            for n in ast.walk(value):
                if isinstance(n, ast.Name) and n.id in st.crossed and \
                        attr in st.local_src.get(n.id, ()):
                    self._add(stmt, attr,
                              f"the value reuses `{n.id}`, a snapshot "
                              "taken before the suspension")
                    return
            # (i') single-statement lost update: a load of the attr
            # that evaluates BEFORE the value's await — inside the
            # awaited operand (``self.x = await f(self.x)``), or
            # positioned left of the last await (operands evaluate
            # left to right: ``self.x = self.x + await f()``), or the
            # implicit target read of an augmented assignment
            # (``self.x += await f()`` loads x before the RHS runs).
            # Loads after the last await evaluate post-resumption and
            # stay clean.
            awaits = [n for n in ast.walk(value)
                      if isinstance(n, ast.Await)]
            if awaits:
                if isinstance(stmt, ast.AugAssign) and \
                        _self_attr(stmt.target) == attr:
                    self._add(stmt, attr,
                              f"`self.{attr}`'s old value loads "
                              "before the awaited right-hand side "
                              "runs")
                    return
                for a in awaits:
                    if attr in _attr_loads(a.value):
                        self._add(stmt, attr,
                                  f"the value reads `self.{attr}` "
                                  "inside the awaited expression, "
                                  "before the suspension")
                        return
                last = max((a.lineno, a.col_offset) for a in awaits)
                for n in _walk_live(value):
                    if isinstance(n, ast.Attribute) and \
                            isinstance(n.ctx, ast.Load) and \
                            isinstance(n.value, ast.Name) and \
                            n.value.id == "self" and n.attr == attr \
                            and (n.lineno, n.col_offset) < last:
                        self._add(stmt, attr,
                                  f"the value reads `self.{attr}` "
                                  "left of the awaited expression, "
                                  "before the suspension")
                        return
        # (ii) the taken branch tested the attr before the suspension
        for g in self.guards:
            if g.crossed and attr in g.attrs:
                self._add(stmt, attr,
                          "the guarding test ran before the "
                          "suspension")
                return

    def _writes_of(self, stmt: ast.stmt
                   ) -> List[Tuple[ast.AST, Optional[ast.AST], bool]]:
        out: List[Tuple[ast.AST, Optional[ast.AST], bool]] = []

        def flat(t: ast.AST) -> List[ast.AST]:
            if isinstance(t, (ast.Tuple, ast.List)):
                return [x for e in t.elts for x in flat(e)]
            return [t]

        if isinstance(stmt, ast.Assign):
            out.extend((t, stmt.value, False)
                       for tgt in stmt.targets for t in flat(tgt))
        elif isinstance(stmt, ast.AugAssign):
            out.append((stmt.target, stmt.value, False))
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            out.append((stmt.target, stmt.value, False))
        elif isinstance(stmt, ast.Delete):
            out.extend((t, None, False) for t in stmt.targets)
        for n in _walk_live(stmt):
            if isinstance(n, ast.Call) and \
                    isinstance(n.func, ast.Attribute) and \
                    n.func.attr in MUTATORS:
                args = ast.Tuple(elts=list(n.args), ctx=ast.Load())
                out.append((n.func.value, args, True))
        return out

    def _stmt(self, stmt: ast.stmt, st: _State) -> None:
        if isinstance(stmt, astutil.FuncNode) or \
                isinstance(stmt, ast.ClassDef):
            return                     # deferred body: PXA902's job
        if isinstance(stmt, ast.If):
            self._observe(stmt.test, st)
            g = _Guard(attrs={a for a in _attr_loads(stmt.test)} | {
                a for n in ast.walk(stmt.test)
                if isinstance(n, ast.Name)
                for a in st.local_src.get(n.id, ())})
            if _has_await(stmt.test):
                self._suspend(st)
            other = st.copy()
            self.guards.append(g)
            self._body(stmt.body, st)
            self._body(stmt.orelse, other)
            self.guards.pop()
            st.merge(other)
            return
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(stmt, ast.While):
                self._observe(stmt.test, st)
            else:
                self._observe(stmt.iter, st)
                if isinstance(stmt, ast.AsyncFor):
                    self._suspend(st)
            # two passes: wrap-around staleness (a suspension late in
            # the body stales reads early in it on iteration 2)
            for _ in range(2):
                self._body(stmt.body, st)
                if isinstance(stmt, ast.AsyncFor):
                    self._suspend(st)
            self._body(stmt.orelse, st)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._observe(item.context_expr, st)
            if isinstance(stmt, ast.AsyncWith) or _has_await(stmt):
                self._suspend(st)
            self._body(stmt.body, st)
            return
        if isinstance(stmt, ast.Try):
            self._body(stmt.body, st)
            for h in stmt.handlers:
                hs = st.copy()
                self._body(h.body, hs)
                st.merge(hs)
            self._body(stmt.orelse, st)
            self._body(stmt.finalbody, st)
            return
        # simple statement: loads first, then (if it awaits) the
        # suspension, then its writes — matching evaluation order for
        # the ``self.x = await f(self.x)`` shape
        self._observe(stmt, st)
        self._bind_locals(stmt, st)
        if _has_await(stmt):
            # value loads happened before the suspension: their
            # snapshots are already crossed
            self._suspend(st)
        writes = self._writes_of(stmt)
        for target, value, mutator in writes:
            self._check_write(target, value, stmt, st, mutator)
        # a write makes the attr known-current again
        for target, _v, _m in writes:
            attr = _self_attr(target)
            if attr is not None:
                st.fresh.add(attr)

    def _body(self, stmts: Sequence[ast.stmt], st: _State) -> None:
        for s in stmts:
            self._stmt(s, st)

    def run(self, fn: ast.AST,
            seed: Optional[_State] = None) -> List[Violation]:
        st = seed if seed is not None else _State()
        self._body(fn.body, st)
        return self.out


# ---------------------------------------------------------------------------
# PXA902: deferred-callback RMW
# ---------------------------------------------------------------------------


def _method_snapshots(method: ast.AST) -> Dict[str, Set[str]]:
    """Order-insensitive local -> self-attr snapshot map for the whole
    method (what a nested callback can capture)."""
    src: Dict[str, Set[str]] = {}
    for _ in range(2):
        for node in ast.walk(method):
            if not isinstance(node, ast.Assign):
                continue
            attrs = _attr_loads(node.value)
            for n in ast.walk(node.value):
                if isinstance(n, ast.Name) and n.id in src:
                    attrs |= src[n.id]
            if not attrs:
                continue
            for t in node.targets:
                names = [t] if isinstance(t, ast.Name) else (
                    [e for e in t.elts if isinstance(e, ast.Name)]
                    if isinstance(t, (ast.Tuple, ast.List)) else [])
                for nm in names:
                    src.setdefault(nm.id, set()).update(attrs)
    return src


def _deferred_callbacks(method: ast.AST) -> List[ast.AST]:
    """Nested defs/lambdas that run at a later tick: passed to a
    deferral sink, stored on ``self``, or returned."""
    nested = {n.name: n for n in ast.walk(method)
              if isinstance(n, astutil.FuncNode) and n is not method}
    out: List[ast.AST] = []
    deferred_names: Set[str] = set()
    for node in ast.walk(method):
        if isinstance(node, ast.Call):
            tail = (astutil.dotted_name(node.func) or "").split(".")[-1]
            if _DEFER_RE.search(tail):
                for arg in [*node.args,
                            *(kw.value for kw in node.keywords)]:
                    if isinstance(arg, ast.Lambda):
                        out.append(arg)
                    elif isinstance(arg, ast.Name) and \
                            arg.id in nested:
                        deferred_names.add(arg.id)
        elif isinstance(node, (ast.Assign, ast.Return)) and \
                getattr(node, "value", None) is not None:
            v = node.value
            if isinstance(v, ast.Lambda):
                out.append(v)
            elif isinstance(v, ast.Name) and v.id in nested:
                deferred_names.add(v.id)
    out.extend(nested[n] for n in sorted(deferred_names))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_file(path: Path, root: Path) -> List[Violation]:
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    out: List[Violation] = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        sync_locks = _sync_lock_attrs(cls)
        for item in cls.body:
            if not isinstance(item, astutil.FuncNode):
                continue
            if item.name == "__init__":
                continue
            # PXA901: RMW across awaits in async methods
            if isinstance(item, ast.AsyncFunctionDef):
                out.extend(_MethodWalk(relpath, cls.name,
                                       item.name).run(item))
                out.extend(_check_lock_spans(relpath, cls.name, item,
                                             sync_locks))
            # PXA902: RMW split across a deferral boundary
            snaps = _method_snapshots(item)
            for cb in _deferred_callbacks(item):
                name = getattr(cb, "name", "<lambda>")
                walk = _MethodWalk(relpath, cls.name,
                                   f"{item.name}.{name}",
                                   code="PXA902")
                seed = _State(fresh=set(),
                              local_src={k: set(v)
                                         for k, v in snaps.items()},
                              crossed=set(snaps))
                if isinstance(cb, ast.Lambda):
                    body = [ast.Expr(value=cb.body)]
                    ast.fix_missing_locations(ast.Module(
                        body=body, type_ignores=[]))
                    walk._body(body, seed)
                    out.extend(walk.out)
                else:
                    out.extend(walk.run(cb, seed))
    return out


def _check_lock_spans(relpath: str, cls: str, fn: ast.AST,
                      sync_locks: Set[str]) -> List[Violation]:
    """PXA903: a suspension point under ``with self.<sync lock>``."""
    if not sync_locks:
        return []
    out: List[Violation] = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.With):
            continue
        held = None
        for it in node.items:
            expr = it.context_expr
            attr = _self_attr(expr)
            if attr is None and isinstance(expr, ast.Call):
                attr = _self_attr(expr.func)
            if attr in sync_locks:
                held = attr
        if held is None:
            continue
        for sub in _walk_live(node):
            if isinstance(sub, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
                out.append(Violation(
                    rule=RULE, code="PXA903", path=relpath,
                    line=sub.lineno, col=sub.col_offset,
                    message=(
                        f"suspension point inside `with self.{held}` "
                        f"in `{cls}.{fn.name}` — a threading lock held "
                        "across an await blocks the entire event loop "
                        "and deadlocks against any other task that "
                        "takes it")))
                break
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root))
    return out
