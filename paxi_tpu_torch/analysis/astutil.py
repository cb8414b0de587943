"""AST plumbing shared by the port's paxi-lint rule families (a copy of
the JAX package's ``analysis/astutil.py``).

Everything here is *purely static*: rules parse source files and never
import the modules under analysis, so the linter runs in milliseconds,
needs no torch, and can analyze broken or heavyweight modules safely.
Paths are repo-relative (``rel``) and globs are rooted at the repo
(``iter_py``), as each family's ``TARGETS`` spell them.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


def parse_file(path: Path) -> Tuple[ast.Module, str]:
    source = path.read_text()
    return ast.parse(source, filename=str(path)), source


def rel(path: Path, root: Path) -> str:
    """``path`` relative to ``root``, '/'-separated; a file outside the
    repo (``lint /tmp/x.py``) keeps its absolute path."""
    try:
        return path.relative_to(root).as_posix()
    except ValueError:
        return Path(path).resolve().as_posix()


def iter_py(root: Path, patterns: Sequence[str]) -> Iterator[Path]:
    """Sorted union of glob matches under ``root`` (deterministic
    reports)."""
    seen = set()
    for pat in patterns:
        for p in root.glob(pat):
            if p.suffix == ".py" and p not in seen:
                seen.add(p)
    yield from sorted(seen)


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def collect_functions(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every function/async def in the module (any nesting depth),
    keyed by bare name.  Name collisions keep all defs — reachability
    over-approximates, which for a linter errs toward sensitivity."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, FuncNode):
            out.setdefault(node.name, []).append(node)
    return out


def referenced_names(fn: ast.AST) -> set:
    """Bare names referenced inside a function body (calls, aliases,
    partial() arguments alike) — the edge relation for reachability."""
    names = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            names.add(node.id)
    return names


def reachable_functions(roots: Sequence[ast.AST],
                        funcs: Dict[str, List[ast.AST]]) -> List[ast.AST]:
    """Closure of ``roots`` over the references-a-function-name
    relation, module-local.  Lambdas count as anonymous members of the
    function they appear in (ast.walk descends into them)."""
    seen: List[ast.AST] = []
    seen_ids = set()
    work = list(roots)
    while work:
        fn = work.pop()
        if id(fn) in seen_ids:
            continue
        seen_ids.add(id(fn))
        seen.append(fn)
        for name in referenced_names(fn):
            for target in funcs.get(name, []):
                if id(target) not in seen_ids:
                    work.append(target)
    return seen


def parse_module_dict(tree: ast.Module, name: str) -> Optional[ast.Dict]:
    """The dict literal bound to a module-level ``name = {...}``."""
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == name
                        and isinstance(node.value, ast.Dict)):
                    return node.value
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)
              and node.target.id == name
              and isinstance(node.value, ast.Dict)):
            return node.value
    return None


def str_dict_items(d: ast.Dict) -> List[Tuple[str, Optional[str],
                                              int, int]]:
    """(key, value-if-string, line, col) for every constant-string key
    of a dict literal; non-string values come back as None."""
    out = []
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            val = (v.value if isinstance(v, ast.Constant)
                   and isinstance(v.value, str) else None)
            out.append((k.value, val, k.lineno, k.col_offset))
    return out


def decorator_names(node: ast.AST) -> List[str]:
    out = []
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name:
            out.append(name)
        # @functools.partial(f, ...) — surface the wrapped callee
        if isinstance(dec, ast.Call) and name and \
                name.split(".")[-1] == "partial" and dec.args:
            inner = dotted_name(dec.args[0])
            if inner:
                out.append(inner)
    return out


def string_keys_of_returned_dicts(fn: ast.AST) -> List[Tuple[str, int]]:
    """Constant-string keys of every dict literal inside ``fn`` —
    how the trace-map rule reads a sim module's ``mailbox_spec``
    without executing it (specs are dict literals with computed
    values but constant keys)."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    out.append((k.value, k.lineno))
    return out
