"""Host-concurrency rule family (PXC4xx) — a lightweight race lint.

The host runtime is asyncio-first (one task per node), but a few
shared structures are also touched from real threads: the Database is
hit by HTTP worker contexts and benchmark executors, and anything that
grows a ``threading.Lock`` is *declaring* itself cross-thread shared.
For such a class the locking discipline is mechanical — every mutation
of ``self`` state happens inside ``with self._lock:`` — and mechanical
discipline is what a linter can hold forever, long after the original
author stops looking (the cloud-Paxos experience report's category of
"implementation diverges from the obviously-intended protocol").

Scope is deliberately narrow to stay true-positive-heavy: only classes
that themselves create a ``threading.Lock``/``RLock``/``Condition``
(or ``asyncio.Lock``) attribute are checked; ``__init__`` is exempt
(the object is not shared yet); nested function bodies are skipped
(deferred callbacks run under whatever discipline their call site
has).

Checks:

- **PXC401** assignment / augmented assignment / deletion of a
  ``self`` attribute (or an item of one) outside the lock
- **PXC402** a mutating container call (``self.x.append(...)``,
  ``.pop``, ``.update``, ``.clear``, ...) outside the lock

Stage-2 deepening (PXC45x) — the single-``with`` check above judges
each statement in place, which leaves two real race shapes invisible:

- **PXC451** a *deferred callable* (nested ``def``/``lambda`` handed to
  the socket/fabric/event loop, assigned to state, or returned) that
  writes or mutates ``self`` state without acquiring the lock
  *itself*.  Registration may well happen inside ``with self._lock:``
  — the callback still runs later, lock-free, on whatever thread the
  transport uses; the lock state at the registration site is
  irrelevant, so these bodies are analyzed as unlocked roots instead
  of being skipped.
- **PXC452** a mutating call through a local **alias** of a ``self``
  attribute (``d = self.items`` ... ``d.append(x)``) outside the lock
  — same shared structure, laundered through a name the per-statement
  check cannot see.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "host-concurrency"

TARGETS = (
    "paxi_tpu_torch/**/*.py",
)

LOCK_FACTORIES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition", "asyncio.Lock",
})

MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse",
})


def _self_attr(node: ast.AST) -> Optional[str]:
    """``x`` for ``self.x`` (possibly through subscripts:
    ``self.x[k]`` -> ``x``)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Names of self attributes bound to lock objects anywhere in the
    class body."""
    out: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        factory = astutil.dotted_name(node.value.func)
        if factory not in LOCK_FACTORIES:
            continue
        for t in node.targets:
            attr = _self_attr(t)
            if attr is not None:
                out.add(attr)
    return out


def _acquires_lock(node: ast.With, lock_attrs: Set[str]) -> bool:
    for item in node.items:
        expr = item.context_expr
        # both `with self._lock:` and `with self._lock.something():`
        attr = _self_attr(expr)
        if attr is None and isinstance(expr, ast.Call):
            attr = _self_attr(expr.func)
            if attr is None and isinstance(expr.func, ast.Attribute):
                attr = _self_attr(expr.func.value)
        if attr in lock_attrs:
            return True
    return False


class _MethodChecker:
    def __init__(self, relpath: str, cls: str, method: str,
                 lock_attrs: Set[str], deferred: bool = False):
        self.relpath = relpath
        self.cls = cls
        self.method = method
        self.lock_attrs = lock_attrs
        self.deferred = deferred      # body is a deferred callback
        self.aliases: dict = {}       # local name -> aliased self attr
        self.out: List[Violation] = []

    def _add(self, code: str, node: ast.AST, msg: str) -> None:
        if self.deferred:
            code = "PXC451"
            why = (" — the callback runs later without the lock, "
                   "whatever the registration site held")
        else:
            why = (" — the class declares itself cross-thread shared "
                   "by owning that lock")
        self.out.append(Violation(
            rule=RULE, code=code, path=self.relpath,
            line=node.lineno, col=node.col_offset,
            message=f"{msg} in `{self.cls}.{self.method}` outside "
                    f"`with self.{sorted(self.lock_attrs)[0]}`{why}"))

    def _check_write_target(self, target: ast.AST, node: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_write_target(elt, node)
            return
        attr = _self_attr(target)
        if attr is not None and attr not in self.lock_attrs:
            self._add("PXC401", node,
                      f"unlocked write to `self.{attr}`")

    def _check_stmt(self, stmt: ast.stmt, locked: bool) -> None:
        if isinstance(stmt, astutil.FuncNode):
            return   # deferred body: locking judged at its call site
        if isinstance(stmt, ast.With) and not locked and \
                _acquires_lock(stmt, self.lock_attrs):
            for s in stmt.body:
                self._check_stmt(s, True)
            return
        if isinstance(stmt, ast.Assign):
            # alias bookkeeping (lock state irrelevant: the alias may
            # outlive the with-block it was taken in)
            for t in stmt.targets:
                if not isinstance(t, ast.Name):
                    continue
                src = _self_attr(stmt.value) \
                    if isinstance(stmt.value, ast.Attribute) else None
                if src is not None and src not in self.lock_attrs:
                    self.aliases[t.id] = src
                else:
                    self.aliases.pop(t.id, None)
        if not locked:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    self._check_write_target(t, stmt)
            elif isinstance(stmt, ast.AugAssign) or (
                    isinstance(stmt, ast.AnnAssign)
                    and stmt.value is not None):
                self._check_write_target(stmt.target, stmt)
            elif isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    self._check_write_target(t, stmt)
            # mutating calls inside any expression of this statement
            for node in ast.iter_child_nodes(stmt):
                if isinstance(node, ast.expr):
                    self._check_expr(node)
        # recurse into compound statements, carrying the lock state
        for name in ("body", "orelse", "finalbody"):
            for s in getattr(stmt, name, []) or []:
                if isinstance(s, ast.stmt):
                    self._check_stmt(s, locked)
        for h in getattr(stmt, "handlers", []) or []:
            for s in h.body:
                self._check_stmt(s, locked)

    def _check_expr(self, expr: ast.expr) -> None:
        deferred: Set[int] = set()   # lambda bodies run at their call site
        for node in ast.walk(expr):
            if isinstance(node, ast.Lambda):
                for sub in ast.walk(node):
                    if sub is not node:
                        deferred.add(id(sub))
        for node in ast.walk(expr):
            if id(node) in deferred:
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in MUTATORS:
                attr = _self_attr(node.func.value)
                if attr is not None and attr not in self.lock_attrs:
                    self._add(
                        "PXC402", node,
                        f"unlocked mutating call "
                        f"`self.{attr}.{node.func.attr}(...)`")
                elif isinstance(node.func.value, ast.Name) and \
                        node.func.value.id in self.aliases:
                    src = self.aliases[node.func.value.id]
                    self._add(
                        "PXC452", node,
                        f"unlocked mutating call "
                        f"`{node.func.value.id}.{node.func.attr}(...)` "
                        f"through an alias of `self.{src}`")

    def run(self, fn: ast.AST) -> List[Violation]:
        for stmt in fn.body:
            self._check_stmt(stmt, False)
        return self.out

    def run_expr(self, expr: ast.expr) -> List[Violation]:
        """Lambda bodies (deferred callbacks) — expressions only."""
        self._check_expr(expr)
        return self.out


# call texts that defer their callable argument to another thread/tick
_DEFER_RE = re.compile(
    r"(call_soon|call_later|call_at|create_task|ensure_future|submit|"
    r"run_in_executor|add_done_callback|on_[a-z_]+|register|"
    r"\bsocket\.|\bfabric\.|\bloop\.|Timer|Thread)")


def _escaping_callables(method: ast.AST) -> List[ast.AST]:
    """Nested defs and lambdas of ``method`` that outlive it.  A nested
    def escapes when referenced outside the function position of a call
    (assigned, returned, stored, passed along); a lambda escapes when
    its enclosing call looks like a deferral sink (``loop.call_soon``,
    ``socket.on_*``, executor submission...) — lambdas fed to
    synchronous combinators (``sorted(key=...)``) run under the call
    site's own lock state and stay the per-statement check's business."""
    nested = {n.name: n for n in ast.walk(method)
              if isinstance(n, astutil.FuncNode) and n is not method}
    out: List[ast.AST] = []
    for node in ast.walk(method):
        if isinstance(node, ast.Call) and _DEFER_RE.search(
                ast.unparse(node.func)):
            for arg in [*node.args,
                        *(kw.value for kw in node.keywords)]:
                if isinstance(arg, ast.Lambda):
                    out.append(arg)
        # a lambda stored or returned outlives the method just like a
        # named nested def (`self.on_x = lambda: ...`, `return lambda`)
        # — descending through container literals but NOT through calls
        # (a lambda fed to sorted(key=...) runs synchronously and is
        # only deferred when the call matches _DEFER_RE above)
        if isinstance(node, (ast.Assign, ast.Return)) and \
                node.value is not None:
            work = [node.value]
            while work:
                v = work.pop()
                if isinstance(v, ast.Lambda):
                    out.append(v)
                elif isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                    work.extend(v.elts)
                elif isinstance(v, ast.Dict):
                    work.extend(x for x in v.values if x is not None)
    call_funcs = {id(n.func) for n in ast.walk(method)
                  if isinstance(n, ast.Call)}
    for name, fn in nested.items():
        refs = [n for n in ast.walk(method)
                if isinstance(n, ast.Name) and n.id == name
                and isinstance(n.ctx, ast.Load)]
        if any(id(r) not in call_funcs for r in refs):
            out.append(fn)
    return out


def check_file(path: Path, root: Path) -> List[Violation]:
    relpath = astutil.rel(path, root)
    tree, _ = astutil.parse_file(path)
    out: List[Violation] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        lock_attrs = _lock_attrs(node)
        if not lock_attrs:
            continue
        for item in node.body:
            if not isinstance(item, astutil.FuncNode):
                continue
            if item.name == "__init__":
                continue
            out.extend(_MethodChecker(relpath, node.name, item.name,
                                      lock_attrs).run(item))
            # stage-2 deepening: escaped callbacks run lock-free later
            for cb in _escaping_callables(item):
                name = getattr(cb, "name", "<lambda>")
                checker = _MethodChecker(
                    relpath, node.name, f"{item.name}.{name}",
                    lock_attrs, deferred=True)
                if isinstance(cb, ast.Lambda):
                    out.extend(checker.run_expr(cb.body))
                else:
                    out.extend(checker.run(cb))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = (list(files) if files is not None
             else list(astutil.iter_py(root, TARGETS)))
    out: List[Violation] = []
    for p in paths:
        out.extend(check_file(p, root))
    return out
