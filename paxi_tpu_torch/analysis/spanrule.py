"""Span-isolation rule family (PXO13x).

The causal tracing layer (paxi_tpu_torch/obs) instruments protocol host code
through the SpanCollector's **statement tier**: ``self.spans.open(key,
kind, ctx)`` / ``close(key)`` / ``close_group(prefix)`` are bare
expression statements that return ``None`` and no-op when the command
is unsampled.  The architecture promises that spans are **write-only
from protocol code**: a handler may emit span opens/closes, but no
span value — the collector itself, an open Span, its count — may ever
feed a protocol decision.  Otherwise "turning sampling on" could
change commit behavior, and the fabric-deterministic replay would mask
exactly the divergence the sampling introduced (the same contract the
PXM10x measurement-isolation family pins for the sim kernels, ported
to the host tier).

Enforced with a forward taint walk over every function of the protocol
host modules:

- a read of the ``.spans`` attribute (or the result of any
  ``.spans.<method>()`` call in expression position) taints;
- taint propagates through assignment to local names;
- three forms are **sanctioned** and carry no taint:
  a bare expression statement calling a collector method
  (``self.spans.open(...)`` — the statement tier), passing the
  collector through a ``spans=`` keyword (wiring it into a
  BatchBuffer or sub-component), and the resolved-clock read
  ``spans.now()`` — its value is a plain timestamp (fabric clock
  under replay, perf_counter live), not span state, and the lease
  machinery MUST read time through exactly this spelling (PXR165),
  so timestamping entries or lease deadlines with it is not a span
  leak.

Checks:

- **PXO131** a span value is stored into protocol state (attribute or
  subscript target, or a non-``_sp*`` local name) or passed as a
  non-``spans=`` argument to a non-collector call.
- **PXO132** a span value steers control flow (``if``/``while``/
  ``assert``/ternary test) — the "no protocol decision" core.
- **PXO133** a span value escapes through ``return``.

Local names prefixed ``_sp`` are quarantined for storage (PXO131) —
the sanctioned spelling for a helper that must hold a span briefly —
but branching on or returning them still flags: quarantine marks the
value as span-typed, it does not launder it.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional, Sequence, Set

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "span-isolation"

TARGETS = (
    "paxi_tpu_torch/protocols/*/host*.py",
)

# SpanCollector surface; a call through `.spans.<one of these>` in
# statement position is the sanctioned write
_COLLECTOR_METHODS = ("open", "close", "close_group", "start",
                      "finish", "clear", "export", "now")


def _is_spans_base(node: ast.expr) -> bool:
    """``<expr>.spans`` or a bare name ``spans``."""
    return ((isinstance(node, ast.Attribute) and node.attr == "spans")
            or (isinstance(node, ast.Name) and node.id == "spans"))


def _is_collector_call(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute)
            and f.attr in _COLLECTOR_METHODS
            and _is_spans_base(f.value))


class _Taint(ast.NodeVisitor):
    """Does this expression carry a span value?  ``.spans`` reads and
    quarantined ``_sp*`` names hit; ``spans=`` keyword values do not
    (the wiring quarantine)."""

    def __init__(self, tainted: Set[str]):
        self.tainted = tainted
        self.hit = False

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load) and node.id in self.tainted:
            self.hit = True

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr == "spans" and isinstance(node.ctx, ast.Load):
            self.hit = True
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "now" \
                and _is_spans_base(f.value):
            return          # resolved clock: a timestamp, not a span
        self.visit(node.func)
        for a in node.args:
            self.visit(a)
        for kw in node.keywords:
            if kw.arg == "spans":
                continue                        # sanctioned wiring
            self.visit(kw.value)

    def visit_FunctionDef(self, node) -> None:  # nested defs: opaque
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


def _tainted(expr: ast.expr, tainted: Set[str]) -> bool:
    t = _Taint(tainted)
    t.visit(expr)
    return t.hit


def _target_names(target: ast.expr) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for el in target.elts:
            out.extend(_target_names(el))
        return out
    return []


class _FnWalker:
    """Forward taint walk over one host function's body."""

    def __init__(self, rel: str, out: List[Violation]):
        self.rel = rel
        self.out = out
        self.tainted: Set[str] = set()          # incl. quarantined _sp*
        self.reported: Set[tuple] = set()

    def _flag(self, code: str, node: ast.AST, msg: str) -> None:
        key = (node.lineno, code)
        if key in self.reported:
            return
        self.reported.add(key)
        self.out.append(Violation(
            rule=RULE, code=code, path=self.rel, line=node.lineno,
            col=node.col_offset, message=msg))

    def _check_args(self, expr: ast.expr) -> None:
        """PXO131 at every non-collector call receiving a span value
        through a non-``spans=`` argument, anywhere in ``expr``; also
        PXO132 at every ternary whose test is span-tainted."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and not _is_collector_call(node):
                for a in node.args:
                    if _tainted(a, self.tainted):
                        self._flag(
                            "PXO131", a,
                            "span value passed into a non-collector "
                            "call: spans are write-only from protocol "
                            "code (use the spans= wiring keyword)")
                for kw in node.keywords:
                    if kw.arg == "spans":
                        continue
                    if _tainted(kw.value, self.tainted):
                        self._flag(
                            "PXO131", kw.value,
                            f"span value passed as keyword "
                            f"{kw.arg or '**'!r} into a non-collector "
                            f"call: spans are write-only from "
                            f"protocol code")
            elif isinstance(node, ast.IfExp):
                if _tainted(node.test, self.tainted):
                    self._flag(
                        "PXO132", node.test,
                        "span value steers a ternary: no protocol "
                        "decision may depend on span state")

    def _walk(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                        # nested defs: opaque
            if isinstance(stmt, ast.Expr):
                if (isinstance(stmt.value, ast.Call)
                        and _is_collector_call(stmt.value)):
                    continue                    # the statement tier
                self._check_args(stmt.value)
                continue
            if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                 ast.AugAssign)):
                value = stmt.value
                if value is None:
                    continue
                self._check_args(value)
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                if _tainted(value, self.tainted):
                    names = [n for t in targets
                             for n in _target_names(t)]
                    stored = [t for t in targets
                              if not isinstance(t, (ast.Name, ast.Tuple,
                                                    ast.List))]
                    bad = [n for n in names if not n.startswith("_sp")]
                    if stored:
                        self._flag(
                            "PXO131", stmt,
                            "span value stored into protocol state "
                            "(attribute/subscript target): spans are "
                            "write-only from protocol code")
                    elif bad:
                        self._flag(
                            "PXO131", stmt,
                            f"span value bound to {bad[0]!r}: hold "
                            f"spans only in _sp*-quarantined locals")
                    self.tainted.update(names)
                else:
                    self.tainted.difference_update(
                        n for t in targets for n in _target_names(t))
                continue
            if isinstance(stmt, (ast.If, ast.While)):
                if _tainted(stmt.test, self.tainted):
                    self._flag(
                        "PXO132", stmt.test,
                        "span value steers a branch: no protocol "
                        "decision may depend on span state")
                self._check_args(stmt.test)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, ast.Assert):
                if _tainted(stmt.test, self.tainted):
                    self._flag(
                        "PXO132", stmt.test,
                        "span value steers an assert: no protocol "
                        "decision may depend on span state")
                continue
            if isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    if _tainted(stmt.value, self.tainted):
                        self._flag(
                            "PXO133", stmt,
                            "span value escapes through return: spans "
                            "leave protocol code only via the "
                            "collector's export path")
                    self._check_args(stmt.value)
                continue
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._check_args(stmt.iter)
                # two passes for wrap-around taint (measure precedent)
                self._walk(stmt.body)
                self._walk(stmt.body)
                self._walk(stmt.orelse)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
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


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    out: List[Violation] = []
    for path in (files if files is not None
                 else astutil.iter_py(root, TARGETS)):
        try:
            tree = ast.parse(Path(path).read_text())
        except (OSError, SyntaxError):
            continue
        rel = astutil.rel(Path(path), root)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                walker = _FnWalker(rel, out)
                # two passes over the whole body: a later span bind
                # read earlier still taints (measure precedent)
                walker._walk(node.body)
                walker._walk(node.body)
    return sorted(out, key=lambda v: (v.path, v.line, v.code))
