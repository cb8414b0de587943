"""Sim/host state-parity rule family (PXS7xx).

Every hunt campaign "diverged" verdict so far has traced to the same
root cause: the sim kernel and the host replica disagree about what
state the protocol *has* — a field added to one runtime and not the
other, or renamed in a kernel refactor, turns the cross-runtime replay
into an apples-to-oranges comparison long before any schedule
subtlety matters.  This rule pins the correspondence statically.

The contract: every field of a sim kernel's state pytree (the dict
returned by ``init_state``) must correspond to host replica state —
either **by name** (a host-module class attribute with the same name,
including the ``Node`` base attributes like ``db``) or through an
explicit ``SIM_STATE_MAP`` in the protocol's host module::

    SIM_STATE_MAP = {
        "log_bal": "log",    # sim plane -> host attribute
        "timer":   "",       # kernel-internal, no host analog (say why
                             # in a comment)
    }

An empty value declares the field kernel-internal (timers, ack
bitmasks, scan plumbing).  The map is the documentation the next
kernel refactor reads — and like the trace maps (PXT3xx), it is
checked both ways so it cannot go stale.

Protocol pairs come from the registry exactly like the trace-map rule
(variants dedup onto their base host module).  Host attributes are
collected from *every* class in the host module (replica state often
lives in per-key/per-instance aggregates like WPaxos's ``KeyObject``)
plus the ``Node`` base class.

Checks:

- **PXS701** sim fields don't all match by name and the host module
  exports no ``SIM_STATE_MAP`` at all
- **PXS702** a sim state field with no same-named host attribute and
  no map entry — state drift, the thing every hunt divergence so far
  reduced to
- **PXS703** a map key that names no sim state field (stale after a
  kernel refactor)
- **PXS704** a non-empty map value that names no host-module class
  attribute (stale after a host refactor)
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from paxi_tpu_torch.analysis import astutil, flow, tracemap
from paxi_tpu_torch.analysis.model import Violation

RULE = "sim-host-parity"

MAP_NAME = "SIM_STATE_MAP"
NODE_MODULE = "paxi_tpu_torch/host/node.py"


def _option_bundles(fn: ast.AST) -> Set[int]:
    """ids of the ``dict(...)`` calls in ``fn`` that only ever reach a
    call as ``**name`` keywords of something other than ``dict`` — the
    kernels' tensor-option bundles (``i32 = dict(dtype=..., device=...)``
    then ``torch.zeros(shape, **i32)``), which are not state."""
    splatted: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and not (
                isinstance(sub.func, ast.Name) and sub.func.id == "dict"):
            splatted.update(kw.value.id for kw in sub.keywords
                            if kw.arg is None
                            and isinstance(kw.value, ast.Name))
    return {id(sub.value) for sub in ast.walk(fn)
            if isinstance(sub, ast.Assign)
            and isinstance(sub.value, ast.Call)
            and all(isinstance(t, ast.Name) and t.id in splatted
                    for t in sub.targets)}


def sim_state_fields(sim_path: Path) -> List[Tuple[str, int]]:
    """(field, line) for every key of the state dict ``init_state``
    returns — ``dict(k=..., ...)`` keywords and literal dict keys, at
    any nesting depth (kernels assemble sub-dicts for planes), less the
    tensor-option bundles the PyTorch kernels splat into constructors."""
    tree, _ = astutil.parse_file(sim_path)
    out: List[Tuple[str, int]] = []
    seen: Set[str] = set()
    for node in tree.body:
        if not (isinstance(node, astutil.FuncNode)
                and node.name == "init_state"):
            continue
        options = _option_bundles(node)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and id(sub) in options:
                continue
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and \
                    sub.func.id == "dict":
                for kw in sub.keywords:
                    if kw.arg and kw.arg not in seen:
                        seen.add(kw.arg)
                        out.append((kw.arg, sub.lineno))
            elif isinstance(sub, ast.Dict):
                for k in sub.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str) and \
                            k.value not in seen:
                        seen.add(k.value)
                        out.append((k.value, k.lineno))
    return out


# node.py's attr surface is identical for every pair in one run — one
# parse per root, not one per protocol
_NODE_ATTR_CACHE: Dict[str, Set[str]] = {}


def _node_attrs(root: Path) -> Set[str]:
    key = str(root)
    hit = _NODE_ATTR_CACHE.get(key)
    if hit is not None:
        return hit
    tree, _ = astutil.parse_file(root / NODE_MODULE)
    model = flow.ModuleModel(tree)
    out: Set[str] = set()
    for ci in model.classes.values():
        out |= ci.attrs
    _NODE_ATTR_CACHE[key] = out
    return out


def host_attrs(host_path: Path, root: Path,
               tree: Optional[ast.Module] = None,
               _seen: Optional[Set[Path]] = None) -> Set[str]:
    """Self-attributes and dataclass fields of every class in the host
    module, plus the Node base surface (db, socket, metrics...) —
    and, for classes whose base is imported from another in-repo host
    module (``SwitchPaxosReplica(PaxosReplica)``), that module's
    surface too: replica state inherited across a module boundary is
    still host state the sim map may point at."""
    if tree is None:
        tree, _ = astutil.parse_file(host_path)
    model = flow.ModuleModel(tree)
    out: Set[str] = set(_node_attrs(root))
    for ci in model.classes.values():
        out |= ci.attrs
    seen = _seen if _seen is not None else {host_path.resolve()}
    imported: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                imported[a.asname or a.name] = node.module
    base_mods = {imported[b] for ci in model.classes.values()
                 for b in ci.bases if b in imported}
    for mod in sorted(base_mods):
        if not mod.startswith("paxi_tpu_torch."):
            continue
        p = (root / (mod.replace(".", "/") + ".py")).resolve()
        if p.exists() and p not in seen:
            seen.add(p)
            out |= host_attrs(p, root, _seen=seen)
    return out


def host_state_map(host_path: Path,
                   tree: Optional[ast.Module] = None
                   ) -> Optional[Tuple[Dict[str, str], int]]:
    if tree is None:
        tree, _ = astutil.parse_file(host_path)
    d = astutil.parse_module_dict(tree, MAP_NAME)
    if d is None:
        return None
    out: Dict[str, str] = {}
    for key, val, _, _ in astutil.str_dict_items(d):
        out[key] = val if val is not None else ""
    return out, d.lineno


def check_pair(protocol: str, sim_path: Path, host_path: Path,
               root: Path) -> List[Violation]:
    rel_host = astutil.rel(host_path, root)
    rel_sim = astutil.rel(sim_path, root)
    fields = sim_state_fields(sim_path)
    if not fields:
        return []                    # not a sim kernel module
    host_tree, _ = astutil.parse_file(host_path)
    attrs = host_attrs(host_path, root, tree=host_tree)
    found = host_state_map(host_path, tree=host_tree)
    unmatched = [(f, ln) for f, ln in fields if f not in attrs]
    out: List[Violation] = []
    if found is None:
        if unmatched:
            names = ", ".join(f for f, _ in unmatched[:6])
            more = len(unmatched) - 6
            out.append(Violation(
                rule=RULE, code="PXS701", path=rel_host, line=1, col=0,
                message=f"protocol `{protocol}`: {len(unmatched)} sim "
                        f"state field(s) of {rel_sim} match no host "
                        f"attribute by name ({names}"
                        + (f", +{more} more" if more > 0 else "")
                        + f") and the host module exports no "
                          f"{MAP_NAME} — sim/host state "
                          "correspondence is undeclared"))
        return out
    mapping, line = found
    field_names = {f for f, _ in fields}
    for f, _ln in unmatched:
        if f not in mapping:
            out.append(Violation(
                rule=RULE, code="PXS702", path=rel_host, line=line,
                col=0,
                message=f"sim state field `{f}` of protocol "
                        f"`{protocol}` ({rel_sim}) has no same-named "
                        f"host attribute and no {MAP_NAME} entry — "
                        "state drift between the runtimes"))
    for key, val in mapping.items():
        if key not in field_names:
            out.append(Violation(
                rule=RULE, code="PXS703", path=rel_host, line=line,
                col=0,
                message=f"{MAP_NAME} key `{key}` names no sim state "
                        f"field of protocol `{protocol}` (stale after "
                        "a kernel refactor?)"))
        if val and val not in attrs:
            out.append(Violation(
                rule=RULE, code="PXS704", path=rel_host, line=line,
                col=0,
                message=f"{MAP_NAME} value `{val}` (key `{key}`) names "
                        "no class attribute in the host module (stale "
                        "after a host refactor?)"))
    return out


def analyzed_pairs(root: Path,
                   restrict: Optional[Sequence[Path]] = None
                   ) -> List[Tuple[str, Path, Path]]:
    """Same pair universe and restriction semantics as the trace-map
    rule — the two rules pin the two halves of one correspondence."""
    return tracemap.analyzed_pairs(root, restrict)


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    out: List[Violation] = []
    for protocol, sim_path, host_path in analyzed_pairs(root, files):
        out.extend(check_pair(protocol, sim_path, host_path, root))
    return out
