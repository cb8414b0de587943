"""Replay-determinism rule family (PXD14x).

Every headline claim of the replay stack — byte-identical trace
replay, deterministic span timelines, hunt witness reproduction —
rests on one discipline: replay-reachable host code derives time only
from the fabric-resolved logical clock and ordering only from
deterministic structures.  The documented resolution pattern is
``host/node.py``'s "resolved fabric under replay": a component holds
``self.fabric = fabric if fabric is not None else current_fabric()``
and every time read goes through the ``obs/collect.py`` ``now()``
shape::

    if self.fabric is not None:
        return self.fabric.clock()      # logical step under replay
    return time.perf_counter()          # live serving

This family is an interprocedural taint proof of that discipline over
``host/``, ``shard/``, ``switchnet/`` and ``obs/``:

**Taint roots**

- wall clocks: ``time.time`` / ``time.monotonic`` / ``time.perf_counter``
  (+ ``_ns`` variants, naive ``datetime.now``), through ``import``
  aliases, plus any *clock helper* — a function of the analyzed set
  that returns a raw clock value on a replay-reachable path (found by
  a pre-pass; call sites of such helpers are roots, the
  interprocedural step, resolved over the shared ProjectIndex);
- unordered iteration: ``for x in set(...)`` / set literals /
  ``.union()``-family results / comprehensions over them (dict/key
  iteration is insertion-ordered in the supported Pythons and does
  not taint; ``sorted(...)`` launders);
- ambient reads: ``os.environ`` / ``os.getenv`` / module-level
  ``random.*`` calls / unseeded ``random.Random()`` / ``uuid.uuid4``
  / ``secrets.*``.  A *seeded* ``random.Random(seed)`` is clean.

**Sinks** (where host state meets the replayed world)

- wire-frame emission: constructor arguments of any
  ``@register_message`` class or ``core/command.py`` wire type (the
  sink model comes from :func:`project.message_fields`), and stores
  into stamp-named fields (``timestamp``/``t0``/``t1``/``seq``/
  ``sess``/``epoch``) — sequencer stamps and span timestamps included;
- control flow: a tainted ``if``/``while``/``assert``/ternary test —
  fault-window comparisons and quorum decisions alike;
- state stamps: a tainted value stored into instance state
  (``self.x = ...`` / ``self.x[k] = ...``) — the fault-window
  ``*_until`` registers are the canonical case.

**Sanctioning** — the fabric-resolution discipline itself: statements
dominated by a "no fabric attached" guard (``flow.live_only`` over
``flow.dominating_guards``) are the live serving path replay never
reaches, including the early-return and short-circuit spellings.
Clock reads that feed only local measurement (metrics latency
observation) hit no sink and do not flag.

Checks:

- **PXD141** wall-clock taint reaches a sink on a replay-reachable
  path (frame field, fault-window/branch decision, state stamp);
- **PXD142** unordered-iteration taint reaches frame emission or a
  branch decision;
- **PXD143** ambient env/RNG read on a replay-reachable path (flagged
  at the root: the read itself is the nondeterminism).

Genuinely live-only code that the guard proof cannot see (open-loop
benchmark pacing, the fault-injection setters consulted only when no
fabric is attached) is baselined with reasons in
``analysis/baseline.toml`` — the contract is that the baseline only
shrinks.
"""

from __future__ import annotations

import ast
import builtins
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow, project
from paxi_tpu_torch.analysis.model import Violation

RULE = "replay-determinism"

TARGETS = (
    "paxi_tpu_torch/host/*.py",
    "paxi_tpu_torch/shard/*.py",
    "paxi_tpu_torch/switchnet/*.py",
    "paxi_tpu_torch/obs/*.py",
)

# canonical dotted names of raw wall-clock reads
CLOCK_CALLS = frozenset((
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
))

# canonical dotted names of ambient environment/entropy reads
AMBIENT_CALLS = frozenset((
    "os.getenv", "os.urandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.choice",
))

# stdlib modules whose import aliases the canonicalizer tracks
_STDLIB_MODULES = ("time", "datetime", "os", "random", "uuid", "secrets")

# frame/span/sequencer stamp fields: a tainted store into one of these
# on any object is frame emission even outside a constructor call
STAMP_ATTRS = ("timestamp", "t0", "t1", "seq", "sess", "epoch")

# set-producing method names whose results iterate in hash order
_SET_METHODS = ("union", "intersection", "difference",
                "symmetric_difference")

_CODE_OF = {"clock": "PXD141", "order": "PXD142"}

_BUILTIN_NAMES = frozenset(dir(builtins))


def _module_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> canonical dotted prefix for the tracked stdlib
    modules (``import time as t`` / ``from time import monotonic``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] in _STDLIB_MODULES:
                    out[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module in _STDLIB_MODULES:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _unordered(expr: ast.expr) -> bool:
    """Does ``expr`` produce a hash-ordered iterable?  ``set``/
    ``frozenset`` constructors, set literals/comprehensions and the
    ``.union()`` method family; ``sorted(...)`` never matches."""
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    if isinstance(expr, ast.Call):
        if isinstance(expr.func, ast.Name) \
                and expr.func.id in ("set", "frozenset"):
            return True
        if isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in _SET_METHODS:
            return True
        if isinstance(expr.func, ast.BinOp):
            return False
    return False


class _FnWalker:
    """Forward kind-tracking taint walk over one function's body."""

    def __init__(self, rel: str, aliases: Dict[str, str],
                 frames: Dict[str, List[str]], helpers: Set[str],
                 guards: Dict[int, flow.GuardSet],
                 out: Optional[List[Violation]]):
        self.rel = rel
        self.aliases = aliases
        self.frames = frames
        self.helpers = helpers
        self.guards = guards
        self.out = out                      # None: scout (helper) mode
        self.tainted: Dict[str, str] = {}
        self.reported: Set[tuple] = set()
        self.clock_return = False           # scout-mode result

    # -- canonicalization / roots ----------------------------------------
    def _canon(self, expr: ast.AST) -> Optional[str]:
        dotted = astutil.dotted_name(expr)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        base = self.aliases.get(head)
        if base is not None:
            return base + ("." + rest if rest else "")
        return dotted

    def _root_kind(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Call):
            c = self._canon(node.func)
            if c in CLOCK_CALLS:
                return "clock"
            if c in AMBIENT_CALLS:
                return "ambient"
            if c == "random.Random":
                # unseeded only: Random(seed) is the sanctioned form
                return "ambient" if not node.args and not node.keywords \
                    else None
            if c is not None and (c.startswith("random.")
                                  or c.startswith("secrets.")):
                return "ambient"
            if c is not None and c.split(".")[-1] in self.helpers:
                # interprocedural helper root; a BARE name shared with
                # a builtin (e.g. a method named `next`) resolves to
                # the builtin at bare call sites, not the helper
                if "." in c or c not in _BUILTIN_NAMES:
                    return "clock"
            if isinstance(node.func, ast.Name) \
                    and node.func.id in ("list", "tuple", "iter") \
                    and len(node.args) == 1 and _unordered(node.args[0]):
                return "order"
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load):
            if self._canon(node) == "os.environ":
                return "ambient"
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.SetComp)):
            if any(_unordered(g.iter) for g in node.generators):
                return "order"
        return None

    # -- reporting --------------------------------------------------------
    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        if self.out is None:
            return
        key = (node.lineno, code)
        if key in self.reported:
            return
        self.reported.add(key)
        self.out.append(Violation(
            rule=RULE, code=code, path=self.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    # -- expression scanning ----------------------------------------------
    def _scan(self, expr: ast.expr) -> Set[str]:
        """Taint kinds of ``expr``; ambient roots flag in place (the
        read is the violation), respecting short-circuit sanctioning."""
        hits: List[Tuple[ast.AST, str]] = []

        def root_of(node: ast.AST) -> Optional[str]:
            kind = self._root_kind(node)
            if kind is not None:
                hits.append((node, kind))
            return kind

        kinds = flow.expr_taint(expr, self.tainted, root_of)
        for node, kind in hits:
            if kind == "ambient":
                self._flag(
                    "PXD143", node,
                    "ambient env/RNG read on a replay-reachable path: "
                    "seed it, resolve it at construction, or gate it "
                    "on `fabric is None`")
        return kinds

    def _frame_sinks(self, expr: ast.expr) -> None:
        """PXD141/142 at every wire-frame constructor receiving a
        tainted argument anywhere inside ``expr``."""
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            name = (astutil.dotted_name(node.func) or "").split(".")[-1]
            if name not in self.frames:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                kinds = flow.expr_taint(arg, self.tainted,
                                        self._root_kind)
                for kind in ("clock", "order"):
                    if kind in kinds:
                        what = ("wall-clock value" if kind == "clock"
                                else "hash-ordered iteration value")
                        self._flag(
                            _CODE_OF[kind], arg,
                            f"{what} flows into wire frame "
                            f"{name}(...): replay-visible fields must "
                            f"derive from the resolved fabric clock "
                            f"(spans.now() / fabric.clock())")

    def _sinks_in(self, expr: ast.expr) -> Set[str]:
        kinds = self._scan(expr)
        self._frame_sinks(expr)
        return kinds

    # -- statement sinks --------------------------------------------------
    @staticmethod
    def _state_target(target: ast.expr) -> Optional[str]:
        """'state' for instance-state stores, 'stamp' for stamp-field
        stores on any object, None otherwise."""
        base = target
        while isinstance(base, ast.Subscript):
            base = base.value
        if isinstance(base, ast.Attribute):
            if isinstance(base.value, ast.Name) \
                    and base.value.id == "self":
                return "state"
            if base.attr in STAMP_ATTRS:
                return "stamp"
        return None

    def _flag_store(self, kind: str, target_kind: str,
                    stmt: ast.stmt) -> None:
        what = ("wall-clock value" if kind == "clock"
                else "hash-ordered iteration value")
        where = ("instance state (a replay-divergent register, e.g. a "
                 "fault window)" if target_kind == "state"
                 else "a stamp field (frame/span/sequencer surface)")
        self._flag(_CODE_OF[kind], stmt,
                   f"{what} stored into {where}: derive it from the "
                   f"resolved fabric clock or gate it on "
                   f"`fabric is None`")

    def _flag_branch(self, kind: str, node: ast.AST) -> None:
        what = ("wall-clock value" if kind == "clock"
                else "hash-ordered iteration value")
        self._flag(_CODE_OF[kind], node,
                   f"{what} steers replay-reachable control flow "
                   f"(fault-window comparison / protocol decision): "
                   f"use the resolved fabric clock or gate on "
                   f"`fabric is None`")

    # -- the walk ---------------------------------------------------------
    def _live(self, stmt: ast.stmt) -> bool:
        guards = self.guards.get(id(stmt))
        return guards is not None and flow.live_only(guards)

    def _walk(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                    # nested defs: opaque
            if self._live(stmt):
                continue                    # the live serving path
            if isinstance(stmt, ast.Expr):
                self._sinks_in(stmt.value)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                value = stmt.value
                if value is None:
                    continue
                kinds = self._sinks_in(value)
                if not kinds and isinstance(value, (ast.Attribute,
                                                    ast.Name)):
                    if self._canon(value) in CLOCK_CALLS:
                        kinds = {"clock"}   # clock-function alias
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                kind = ("clock" if "clock" in kinds
                        else "order" if "order" in kinds else None)
                names = [n for t in targets
                         for n in _target_names(t)]
                if kind is not None:
                    for t in targets:
                        tk = self._state_target(t)
                        if tk is not None:
                            self._flag_store(kind, tk, stmt)
                    self.tainted.update({n: kind for n in names})
                else:
                    if not isinstance(stmt, ast.AugAssign):
                        for n in names:
                            self.tainted.pop(n, None)
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                kinds = self._sinks_in(stmt.test)
                for kind in ("clock", "order"):
                    if kind in kinds:
                        self._flag_branch(kind, stmt.test)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, ast.Assert):
                kinds = self._scan(stmt.test)
                for kind in ("clock", "order"):
                    if kind in kinds:
                        self._flag_branch(kind, stmt.test)
                continue
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    kinds = self._sinks_in(stmt.value)
                    if "clock" in kinds:
                        self.clock_return = True
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._sinks_in(stmt.iter)
                if _unordered(stmt.iter):
                    self.tainted.update(
                        {n: "order" for n in _target_names(stmt.target)})
                # two passes for wrap-around taint (measure precedent)
                self._walk(stmt.body)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    self._sinks_in(item.context_expr)
                self._walk(stmt.body)
                continue
            if isinstance(stmt, ast.Try):
                self._walk(stmt.body)
                for h in stmt.handlers:
                    self._walk(h.body)
                self._walk(stmt.orelse)
                self._walk(stmt.finalbody)
                continue
        # other statement kinds carry no interesting dataflow here


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    return []


def _parse_all(root: Path, paths: Sequence[Path]
               ) -> List[Tuple[str, ast.Module, Dict[str, str]]]:
    out = []
    for path in paths:
        try:
            tree = ast.parse(Path(path).read_text())
        except (OSError, SyntaxError):
            continue
        out.append((astutil.rel(Path(path).resolve(), root), tree,
                    _module_aliases(tree)))
    return out


def _functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _clock_helpers(mods, frames) -> Set[str]:
    """Names of analyzed functions that return a raw clock value on a
    replay-reachable path — their call sites become taint roots.  Two
    rounds close helper-of-helper chains one level deep; the sanctioned
    ``now()`` resolver never qualifies because its raw-clock return is
    live-only dominated."""
    helpers: Set[str] = set()
    for _ in range(2):
        found: Set[str] = set(helpers)
        for rel, tree, aliases in mods:
            for fn in _functions(tree):
                scout = _FnWalker(rel, aliases, frames, helpers,
                                  flow.dominating_guards(fn), out=None)
                scout._walk(fn.body)
                scout._walk(fn.body)
                if scout.clock_return:
                    found.add(fn.name)
        if found == helpers:
            break
        helpers = found
    return helpers


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    paths = list(files if files is not None
                 else astutil.iter_py(root, TARGETS))
    index = project.shared_index(root, extra_files=files)
    frames = project.message_fields(index)
    mods = _parse_all(root, paths)
    helpers = _clock_helpers(mods, frames)
    out: List[Violation] = []
    for rel, tree, aliases in mods:
        for fn in _functions(tree):
            walker = _FnWalker(rel, aliases, frames, helpers,
                               flow.dominating_guards(fn), out)
            # two passes over the whole body: a later clock bind read
            # earlier still taints (measure precedent)
            walker._walk(fn.body)
            walker._walk(fn.body)
    return sorted(out, key=lambda v: (v.path, v.line, v.code))
