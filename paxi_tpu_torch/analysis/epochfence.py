"""Shard-epoch fence rule family (PXE15x).

Online migration behind ``move_range`` (``shard/migrate.py``) opens a
double-write window the moment any router path acts on a stale
``ShardMap``.  This family proves the swap discipline
``shard/router.py`` documents:
``_map`` and the pending queues live behind one lock; every
ShardMap-dependent forward, pending-queue epoch stamp, 2PC
partitioning, and writeback acts on a *fenced* map value; and the only
mutation is a version-advancing reference swap.  It is the ballot-
domination proof (PXB) at shard granularity: PXB proves no acceptor
acts on a stale ballot, PXE proves no router path acts on a stale
epoch.

A map value is **fenced** when it is:

- a ``._map`` attribute read *inside* a lock region (a ``with`` whose
  context expression ends in ``lock``) — the atomic snapshot;
- the ``shard_map`` property (which takes the lock itself), read as
  ``<obj>.shard_map``;
- a function parameter (the caller owed us a fenced value — this is
  how ``txn.partition_ops(shard_map, ops)`` stays in the proof);
- a name assigned from any fenced value, a ``.move_range(...)`` /
  ``.with_migration(...)`` / ``.complete_migration(...)`` result
  (pure derivations of a fenced map), or another fenced name —
  closed over the function by a two-pass propagation, so the
  snapshot-then-use-outside-the-lock idiom (``flush``) proves clean.

Checks:

- **PXE151** unfenced map read: a ``._map`` attribute load outside
  any lock region, or a ``group_of(...)`` / ``migration_of(...)`` /
  ``ranges_of(...)`` / ``partition_ops(...)`` whose map operand is
  not a fenced value — each one is a key that can resolve against a
  routing table mid-swap;
- **PXE152** non-monotone map write: a store to ``._map`` outside
  ``__init__`` that is not inside a lock region *and* dominated by a
  strict version-advance comparison (``new.version > current.version``
  in either spelling, including the ``if new.version <= cur.version:
  raise`` early-exit form) with the stored name's ``.version`` on one
  side — the guard shape :func:`flow.dominating_guards` extracts.

:func:`coverage` reports the per-module proof surface (map reads
seen/fenced, swaps seen/guarded) so tests can pin that the rule is
actually looking at the sites the docstring claims.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow
from paxi_tpu_torch.analysis.model import Violation

RULE = "epoch-fence"

TARGETS = (
    "paxi_tpu_torch/shard/router.py",
    "paxi_tpu_torch/shard/txn.py",
    "paxi_tpu_torch/shard/migrate.py",
)

# attribute names that ARE the guarded routing table
_MAP_ATTRS = ("_map",)
# attribute reads that are fenced by construction (the property takes
# the lock; reading it yields an immutable snapshot)
_FENCED_ATTRS = ("shard_map",)
# calls that consume a map operand which must be fenced; the
# method-style ones (receiver IS the map) vs. the function-style ones
# (map is the first argument) are told apart in _check_consumer
_MAP_CONSUMERS = ("group_of", "migration_of", "ranges_of",
                  "partition_ops")
_METHOD_CONSUMERS = ("group_of", "migration_of", "ranges_of")
# calls whose result is a fenced map derivation
_FENCED_DERIVATIONS = ("move_range", "with_migration",
                       "complete_migration")

_NEGATE = {ast.Lt: ast.GtE, ast.LtE: ast.Gt, ast.Gt: ast.LtE,
           ast.GtE: ast.Lt}


def _is_lock_ctx(expr: ast.expr) -> bool:
    dotted = astutil.dotted_name(expr)
    if dotted is None and isinstance(expr, ast.Call):
        dotted = astutil.dotted_name(expr.func)
    return dotted is not None and dotted.split(".")[-1].endswith("lock")


def _version_side(expr: ast.expr) -> Optional[str]:
    """The dotted base of a ``<base>.version`` read, else None."""
    if isinstance(expr, ast.Attribute) and expr.attr == "version":
        return astutil.dotted_name(expr.value) or "<expr>"
    return None


class _FnCheck:
    """One function's fence proof: lock regions, fenced-name closure,
    then the read/write checks."""

    def __init__(self, rel: str, fn, out: List[Violation],
                 stats: Dict[str, int]):
        self.rel = rel
        self.fn = fn
        self.out = out
        self.stats = stats
        self.guards = flow.dominating_guards(fn)
        self.in_lock: Set[int] = set()     # id(stmt) inside a lock With
        self._mark_lock(fn.body, False)
        self.fenced: Set[str] = {
            a.arg for a in (list(fn.args.posonlyargs)
                            + list(fn.args.args)
                            + list(fn.args.kwonlyargs))}
        if fn.args.vararg:
            self.fenced.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            self.fenced.add(fn.args.kwarg.arg)
        # two passes close use-before-textual-def chains
        for _ in range(2):
            self._propagate(fn.body)

    # -- lock regions -----------------------------------------------------
    def _mark_lock(self, body: Sequence[ast.stmt], locked: bool) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if locked:
                self.in_lock.add(id(stmt))
            inner = locked
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = locked or any(_is_lock_ctx(i.context_expr)
                                      for i in stmt.items)
            for field in ("body", "orelse", "finalbody"):
                self._mark_lock(getattr(stmt, field, []) or [], inner)
            for h in getattr(stmt, "handlers", []) or []:
                self._mark_lock(h.body, inner)

    # -- fenced-name closure ----------------------------------------------
    def _is_fenced_expr(self, expr: ast.expr, stmt: ast.stmt) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.fenced
        if isinstance(expr, ast.Attribute):
            if expr.attr in _FENCED_ATTRS:
                return True
            if expr.attr in _MAP_ATTRS:
                return id(stmt) in self.in_lock
        if isinstance(expr, ast.Call):
            name = astutil.dotted_name(expr.func) or ""
            if name.split(".")[-1] in _FENCED_DERIVATIONS:
                return True
        return False

    def _propagate(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.Assign) and stmt.value is not None:
                if self._is_fenced_expr(stmt.value, stmt):
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self.fenced.add(t.id)
            for field in ("body", "orelse", "finalbody"):
                self._propagate(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                self._propagate(h.body)

    # -- checks -----------------------------------------------------------
    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        self.out.append(Violation(
            rule=RULE, code=code, path=self.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    def _monotone_guarded(self, stmt: ast.stmt,
                          stored: ast.expr) -> bool:
        """Is ``stmt`` dominated by a strict ``stored.version >
        <other>.version`` comparison (any spelling)?"""
        if not isinstance(stored, ast.Name):
            return False
        want = stored.id
        for test, polarity in self.guards.get(id(stmt), frozenset()):
            if not (isinstance(test, ast.Compare)
                    and len(test.ops) == 1):
                continue
            op = type(test.ops[0])
            if op not in _NEGATE:
                continue
            if not polarity:
                op = _NEGATE[op]
            left = _version_side(test.left)
            right = _version_side(test.comparators[0])
            if left is None or right is None:
                continue
            if left == want and op is ast.Gt:
                return True                 # new.version > cur.version
            if right == want and op is ast.Lt:
                return True                 # cur.version < new.version
        return False

    def run(self) -> None:
        for stmt in self._stmts(self.fn.body):
            self._check_stmt(stmt)

    def _stmts(self, body: Sequence[ast.stmt]):
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            yield stmt
            for field in ("body", "orelse", "finalbody"):
                yield from self._stmts(getattr(stmt, field, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                yield from self._stmts(h.body)

    @staticmethod
    def _own_exprs(stmt: ast.stmt):
        """The statement's OWN expressions — compound statements yield
        only their header (test/iter/items); their bodies are separate
        statements the caller visits with their own lock membership."""
        if isinstance(stmt, (ast.If, ast.While)):
            yield stmt.test
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            yield stmt.target
            yield stmt.iter
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                yield item.context_expr
        elif not isinstance(stmt, ast.Try):
            yield stmt

    def _check_stmt(self, stmt: ast.stmt) -> None:
        for top in self._own_exprs(stmt):
            self._check_nodes(stmt, top)

    def _check_nodes(self, stmt: ast.stmt, top: ast.AST) -> None:
        for node in ast.walk(top):
            if isinstance(node, ast.Attribute) \
                    and node.attr in _MAP_ATTRS:
                if isinstance(node.ctx, ast.Store):
                    self._check_swap(stmt, node)
                elif isinstance(node.ctx, ast.Load):
                    self.stats["map_reads"] += 1
                    if id(stmt) in self.in_lock:
                        self.stats["fenced_reads"] += 1
                    else:
                        self._flag(
                            "PXE151", node,
                            "unfenced routing-map read: `._map` "
                            "accessed outside the lock can observe a "
                            "mid-swap table; snapshot it under the "
                            "lock (or via the shard_map property) "
                            "first")
            elif isinstance(node, ast.Call):
                self._check_consumer(stmt, node)

    def _check_consumer(self, stmt: ast.stmt, call: ast.Call) -> None:
        name = (astutil.dotted_name(call.func) or "").split(".")[-1]
        if name not in _MAP_CONSUMERS:
            return
        if name in _METHOD_CONSUMERS:
            assert isinstance(call.func, ast.Attribute)
            operand: Optional[ast.expr] = call.func.value
        else:
            operand = call.args[0] if call.args else None
        if operand is None:
            return
        self.stats["map_reads"] += 1
        if self._is_fenced_expr(operand, stmt):
            self.stats["fenced_reads"] += 1
            return
        if isinstance(operand, ast.Attribute) \
                and operand.attr in _MAP_ATTRS:
            return   # the raw ._map load above already flagged it
        self._flag(
            "PXE151", call,
            f"map-dependent `{name}(...)` on an unfenced operand: "
            f"resolve keys against one locked snapshot (shard_map "
            f"property / in-lock `._map` bind) so a concurrent "
            f"install_map cannot split the epoch")

    def _check_swap(self, stmt: ast.stmt, target: ast.Attribute) -> None:
        self.stats["swaps"] += 1
        if self.fn.name == "__init__":
            self.stats["guarded_swaps"] += 1
            return                          # initial install
        value = getattr(stmt, "value", None)
        ok = (id(stmt) in self.in_lock and value is not None
              and self._monotone_guarded(stmt, value))
        if ok:
            self.stats["guarded_swaps"] += 1
            return
        if id(stmt) not in self.in_lock:
            why = "outside the lock"
        else:
            why = ("without a dominating strict version-advance "
                   "comparison (new.version > installed.version)")
        self._flag(
            "PXE152", target,
            f"routing-map swap {why}: a regressing or racing install "
            f"re-opens the stale-epoch window the flush re-resolution "
            f"depends on closing")


def _new_stats() -> Dict[str, int]:
    return {"map_reads": 0, "fenced_reads": 0, "swaps": 0,
            "guarded_swaps": 0}


def _run(root: Path, files: Optional[Sequence[Path]]
         ) -> Tuple[List[Violation], Dict[str, Dict[str, int]]]:
    paths = list(files if files is not None
                 else astutil.iter_py(root, TARGETS))
    out: List[Violation] = []
    per_module: Dict[str, Dict[str, int]] = {}
    for path in paths:
        try:
            tree = ast.parse(Path(path).read_text())
        except (OSError, SyntaxError):
            continue
        rel = astutil.rel(Path(path).resolve(), root)
        stats = per_module.setdefault(rel, _new_stats())
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                _FnCheck(rel, node, out, stats).run()
    return (sorted(out, key=lambda v: (v.path, v.line, v.code)),
            per_module)


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    return _run(root, files)[0]


def coverage(root: Path,
             files: Optional[Sequence[Path]] = None
             ) -> Dict[str, Dict[str, int]]:
    """Per-module proof surface: how many map reads/swaps the rule
    actually examined and proved fenced/guarded — the tests pin these
    so a refactor cannot silently move the map out from under the
    rule."""
    return _run(root, files)[1]
