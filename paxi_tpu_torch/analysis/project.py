"""ProjectIndex: the whole-program model of the port's paxi-lint (the
JAX package's ``analysis/project.py``, its universe the ``paxi_tpu_torch``
package).

The cross-module families (cross-module flow PXF8xx, async-atomicity
PXA9xx, replay-determinism PXD14x, and the kernel surface of
kernel-purity PXK1xx) need the one thing module-locality cannot give: a
call in kernel A
resolved to its definition in helper module B, with the analysis
context (guards, thresholds, message-ness) carried across the file
boundary.  This module supplies exactly that, still *purely static* —
no module under analysis is ever imported:

- **import resolution**: ``import a.b as c``, ``from a import b as c``
  (module or symbol), ``from a.b import f as g``, and package
  re-export chains (``from paxi_tpu_torch.sim import SimConfig`` resolves
  through ``sim/__init__.py`` to ``sim/types.py``), relative imports
  included;
- **call binding**: ``br.promise_p1a(...)`` / ``promise_p1a(...)`` /
  nested-def calls bound to the defining (module, function), searched
  innermost-out: enclosing-function locals, module functions, imports;
- **cross-module call graph**: every resolvable call edge between
  functions of different modules, with reverse (``callers_of``)
  queries — how a rule walks guard obligations back to call sites;
- **DOT dump** (``python -m paxi_tpu_torch lint --graph``): the cross-module
  edges, nodes colored by package, so analysis coverage is a picture
  instead of a claim.
- **wire-frame sink model** (:func:`message_fields`): the
  ``@register_message`` classes and ``core/command.py``'s wire types
  with their fields, where host state meets the wire (PXD14x).

Modules are parsed lazily and cached; the call graph is built over the
``paxi_tpu_torch`` package plus any explicitly indexed files (how
fixture modules join the universe).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow

# how many __init__ re-export hops a symbol import may chase
REEXPORT_DEPTH = 4

# the package whose modules make up the call graph's universe
PACKAGE = "paxi_tpu_torch"


@dataclass
class ImportEntry:
    """One name an ``import``/``from`` statement binds in a module.

    ``kind`` is ``"module"`` (the alias names a whole module — calls
    look like ``alias.func(...)``) or ``"symbol"`` (the alias names one
    object of ``relpath`` — calls look like ``alias(...)``)."""

    kind: str                 # "module" | "symbol"
    relpath: str              # repo-relative path of the source module
    symbol: str = ""          # original name, for kind == "symbol"


@dataclass
class ModInfo:
    relpath: str
    tree: ast.Module
    model: flow.ModuleModel
    imports: Dict[str, ImportEntry]
    # every def/async def at any nesting depth, by bare name
    functions: Dict[str, List[ast.AST]]
    # id(fn node) -> enclosing function nodes, outermost first
    enclosing: Dict[int, List[ast.AST]]


@dataclass
class CallSite:
    """One resolved call edge."""

    caller_rel: str
    caller_fn: ast.AST            # the def containing the call
    caller_qual: str              # "Class.method" / "func" / "func.<nested>"
    call: ast.Call
    target_rel: str
    target_name: str


def _module_parts(relpath: str) -> List[str]:
    parts = relpath[:-3].split("/")          # strip .py
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return parts


_SHARED: Dict[Tuple[str, FrozenSet[str]], "ProjectIndex"] = {}


def shared_index(root: Path,
                 extra_files: Optional[Sequence[Path]] = None
                 ) -> "ProjectIndex":
    """Process-wide cached index per (root, extra-file set).  The
    linter parses the same ~130 modules for every rule invocation
    otherwise; sharing is safe because paxi-lint runs are snapshots
    (nothing edits the tree mid-run) and fixture runs key differently
    through their extra files."""
    root = Path(root).resolve()
    pkg = str(root / PACKAGE) + "/"
    # a file of the package is in every index's universe already: only
    # the files outside it make an index different
    extra = frozenset(str(Path(p).resolve()) for p in extra_files or ())
    key = (str(root), frozenset(e for e in extra if not e.startswith(pkg)))
    idx = _SHARED.get(key)
    if idx is None:
        idx = _SHARED[key] = ProjectIndex(root, extra_files=sorted(key[1]))
    return idx


class ProjectIndex:
    """Lazy whole-program index rooted at the repo directory."""

    def __init__(self, root: Path,
                 extra_files: Optional[Sequence[Path]] = None):
        self.root = Path(root).resolve()
        self._mods: Dict[str, Optional[ModInfo]] = {}
        self._extra: Set[str] = set()
        self._graph: Optional[List[CallSite]] = None
        self._callers: Dict[Tuple[str, str], List[CallSite]] = {}
        for p in extra_files or ():
            rel = astutil.rel(Path(p).resolve(), self.root)
            self._extra.add(rel)

    # -- module loading ---------------------------------------------------
    def module(self, relpath: str) -> Optional[ModInfo]:
        """The parsed model of one repo-relative module path (cached;
        None when the file does not exist or does not parse)."""
        if relpath in self._mods:
            return self._mods[relpath]
        path = self.root / relpath
        info: Optional[ModInfo] = None
        if path.is_file():
            try:
                tree, _ = astutil.parse_file(path)
            except SyntaxError:
                tree = None
            if tree is not None:
                info = ModInfo(
                    relpath=relpath, tree=tree,
                    model=flow.ModuleModel(tree),
                    imports=self._imports_of(tree, relpath),
                    functions=astutil.collect_functions(tree),
                    enclosing=_enclosing_map(tree))
        self._mods[relpath] = info
        return info

    def resolve_module(self, dotted: str) -> Optional[str]:
        """Dotted module name -> repo-relative path (module file or
        package ``__init__.py``), or None when it is not in the repo
        (stdlib/third-party)."""
        base = dotted.replace(".", "/")
        for cand in (base + ".py", base + "/__init__.py"):
            if (self.root / cand).is_file():
                return cand
        return None

    def _imports_of(self, tree: ast.Module,
                    relpath: str) -> Dict[str, ImportEntry]:
        out: Dict[str, ImportEntry] = {}
        pkg_parts = _module_parts(relpath)[:-1]   # containing package
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    rel = self.resolve_module(alias.name)
                    if rel is None:
                        continue
                    if alias.asname:
                        out[alias.asname] = ImportEntry("module", rel)
                    else:
                        # ``import a.b.c`` binds ``a``; calls spelled
                        # ``a.b.c.f`` resolve through the dotted chain
                        out[alias.name.split(".")[0]] = ImportEntry(
                            "module",
                            self.resolve_module(alias.name.split(".")[0])
                            or rel)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    up = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                    dotted = ".".join(up + ([node.module]
                                            if node.module else []))
                else:
                    dotted = node.module or ""
                src = self.resolve_module(dotted)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    # ``from pkg import mod``: the name may be a
                    # submodule rather than a symbol of __init__ (and
                    # a namespace package has no __init__ at all)
                    sub = self.resolve_module(f"{dotted}.{alias.name}")
                    if sub is not None:
                        out[bound] = ImportEntry("module", sub)
                    elif src is not None:
                        out[bound] = ImportEntry("symbol", src,
                                                 alias.name)
        return out

    # -- symbol / call resolution ----------------------------------------
    def resolve_symbol(self, relpath: str, name: str,
                       _depth: int = 0) -> Optional[Tuple[str, str]]:
        """Where ``name``, used in ``relpath``, is defined: (module
        relpath, local name) — chasing ``from x import y`` and package
        re-export chains.  None for builtins/unresolvable names."""
        info = self.module(relpath)
        if info is None or _depth > REEXPORT_DEPTH:
            return None
        if name in info.functions or name in info.model.classes:
            return relpath, name
        entry = info.imports.get(name)
        if entry is None:
            return None
        if entry.kind == "module":
            return None               # a module alias is not a callable
        target = self.module(entry.relpath)
        if target is None:
            return None
        if entry.symbol in target.functions or \
                entry.symbol in target.model.classes:
            return entry.relpath, entry.symbol
        # re-export: the __init__ imported it from somewhere else
        return self.resolve_symbol(entry.relpath, entry.symbol,
                                   _depth + 1)

    def resolve_call(self, relpath: str,
                     call: ast.Call) -> Optional[Tuple[str, str]]:
        """(defining module relpath, function name) for a call, or
        None (builtins, methods on objects, unresolvable)."""
        f = call.func
        if isinstance(f, ast.Name):
            return self.resolve_symbol(relpath, f.id)
        dotted = astutil.dotted_name(f)
        if dotted is None or "." not in dotted:
            return None
        info = self.module(relpath)
        if info is None:
            return None
        head, rest = dotted.split(".", 1)
        entry = info.imports.get(head)
        if entry is None or entry.kind != "module":
            return None
        # walk the dotted chain through submodules to the final attr
        cur = entry.relpath
        parts = rest.split(".")
        for i, part in enumerate(parts):
            if i == len(parts) - 1:
                tgt = self.module(cur)
                if tgt is None:
                    return None
                if part in tgt.functions or part in tgt.model.classes:
                    return cur, part
                return self.resolve_symbol(cur, part)
            nxt = self.resolve_module(
                ".".join(_module_parts(cur) + [part]))
            if nxt is None:
                return None
            cur = nxt
        return None

    def function_def(self, relpath: str,
                     name: str) -> Optional[ast.AST]:
        info = self.module(relpath)
        if info is None:
            return None
        fns = info.functions.get(name)
        return fns[0] if fns else None

    # -- call graph -------------------------------------------------------
    def _universe(self) -> List[str]:
        pkg = [astutil.rel(p, self.root)
               for p in sorted((self.root / PACKAGE).rglob("*.py"))]
        # extras may name in-package files (how in-tree TARGET files
        # reach fixture-scoped runs); indexing one twice would double
        # every call edge and the callers_of proofs built on them
        return pkg + sorted(self._extra - set(pkg))

    def build_graph(self) -> List[CallSite]:
        """All resolvable cross-module call edges over the universe
        (the paxi_tpu_torch package plus explicitly indexed files)."""
        if self._graph is not None:
            return self._graph
        edges: List[CallSite] = []
        for rel in self._universe():
            info = self.module(rel)
            if info is None:
                continue
            for qual, fn in _iter_defs(info):
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Call):
                        continue
                    tgt = self.resolve_call(rel, node)
                    if tgt is None or tgt[0] == rel:
                        continue
                    edges.append(CallSite(
                        caller_rel=rel, caller_fn=fn, caller_qual=qual,
                        call=node, target_rel=tgt[0],
                        target_name=tgt[1]))
        self._graph = edges
        self._callers = {}
        for e in edges:
            self._callers.setdefault(
                (e.target_rel, e.target_name), []).append(e)
        return edges

    def callers_of(self, relpath: str, name: str) -> List[CallSite]:
        """Cross-module call sites invoking ``relpath:name`` (builds
        the graph on first use).  Module-local callers are the
        module-local engine's business (flow.ModuleModel)."""
        self.build_graph()
        return self._callers.get((relpath, name), [])

    # -- DOT dump ---------------------------------------------------------
    def to_dot(self) -> str:
        """The cross-module call graph as GraphViz DOT, functions
        clustered by module and colored by top-level package — the
        inspectable picture of what the cross-module rules can see."""
        edges = self.build_graph()
        palette = ["#6baed6", "#fd8d3c", "#74c476", "#9e9ac8",
                   "#fdd0a2", "#c6dbef", "#a1d99b", "#e377c2",
                   "#bcbd22", "#17becf"]
        pkg_color: Dict[str, str] = {}

        def color(rel: str) -> str:
            parts = _module_parts(rel)
            # protocols/<name> counts as its own package; everything
            # else colors by its first directory under the package
            if len(parts) >= 3 and parts[1] == "protocols":
                pkg = f"protocols.{parts[2]}"
            elif len(parts) >= 2:
                pkg = parts[1] if parts[0] == PACKAGE else parts[0]
            else:
                pkg = parts[0]
            if pkg not in pkg_color:
                pkg_color[pkg] = palette[len(pkg_color) % len(palette)]
            return pkg_color[pkg]

        def nid(rel: str, fn: str) -> str:
            return f'"{".".join(_module_parts(rel))}:{fn}"'

        nodes: Dict[str, str] = {}
        lines = ["digraph paxi_calls {", "  rankdir=LR;",
                 "  node [shape=box, style=filled, fontsize=10];"]
        seen: Set[Tuple[str, str, str, str]] = set()
        body: List[str] = []
        for e in edges:
            caller = e.caller_qual.split(".")[0]
            key = (e.caller_rel, caller, e.target_rel, e.target_name)
            if key in seen:
                continue
            seen.add(key)
            a = nid(e.caller_rel, caller)
            b = nid(e.target_rel, e.target_name)
            nodes[a] = color(e.caller_rel)
            nodes[b] = color(e.target_rel)
            body.append(f"  {a} -> {b};")
        for n, c in sorted(nodes.items()):
            lines.append(f'  {n} [fillcolor="{c}"];')
        lines.extend(sorted(body))
        lines.append("}")
        return "\n".join(lines)


def _iter_defs(info: ModInfo) -> List[Tuple[str, ast.AST]]:
    """(qualname, def node) for every top-level function and method —
    the units the call graph attributes edges to.  Nested defs belong
    to their enclosing function's edges (ast.walk descends)."""
    out: List[Tuple[str, ast.AST]] = []
    for node in info.tree.body:
        if isinstance(node, astutil.FuncNode):
            out.append((node.name, node))
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, astutil.FuncNode):
                    out.append((f"{node.name}.{item.name}", item))
    return out


def _enclosing_map(tree: ast.Module) -> Dict[int, List[ast.AST]]:
    """id(def node) -> chain of enclosing def nodes, outermost first
    (how a rule finds the local scope stack of a nested def)."""
    out: Dict[int, List[ast.AST]] = {}

    def walk(node: ast.AST, stack: List[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, astutil.FuncNode):
                out[id(child)] = list(stack)
                walk(child, stack + [child])
            else:
                walk(child, stack)

    walk(tree, [])
    return out


# ---------------------------------------------------------------------------
# wire-frame sink model (stage 4, PXD14x)
# ---------------------------------------------------------------------------

# every top-level dataclass of core/command.py crosses the wire (inside
# WireRequest frames or the HTTP surface), so its constructor keywords
# are frame-emission sinks alongside the @register_message classes
_COMMAND_MODULE = f"{PACKAGE}/core/command.py"

_MESSAGE_FIELDS: Dict[int, Dict[str, List[str]]] = {}


def message_fields(index: "ProjectIndex") -> Dict[str, List[str]]:
    """The wire-frame sink model: class name -> declared field names,
    for every class decorated ``@register_message`` anywhere in the
    indexed universe, plus the client wire types of
    ``core/command.py``.  A constructor call (or field store) on one of
    these is where host state meets the wire — the PXD14x frame-
    emission sink set.  Purely static (decorator spotting, AnnAssign
    fields) and cached per index, like the call graph."""
    cached = _MESSAGE_FIELDS.get(id(index))
    if cached is not None:
        return cached
    out: Dict[str, List[str]] = {}

    def fields_of(cls: ast.ClassDef) -> List[str]:
        return [item.target.id for item in cls.body
                if isinstance(item, ast.AnnAssign)
                and isinstance(item.target, ast.Name)]

    for rel in index._universe():
        info = index.module(rel)
        if info is None:
            continue
        for node in info.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            if rel == _COMMAND_MODULE or any(
                    d.split(".")[-1] == "register_message"
                    for d in astutil.decorator_names(node)):
                out.setdefault(node.name, fields_of(node))
    _MESSAGE_FIELDS[id(index)] = out
    return out
