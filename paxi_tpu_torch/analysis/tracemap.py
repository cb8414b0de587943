"""Trace-map coverage rule family (PXT3xx), sim half, over the port.

The hunt projects a sim trace's per-mailbox fault schedule onto the host
runtime's message classes through the protocol's ``TRACE_MSG_MAP`` (sim
mailbox name -> host message class), which each host twin of the
registry's ``_HOST_MODULES`` holds, as in the JAX package.  Every
*unmapped* mailbox degrades to a coarse time-window drop in the
projection; a *missing* map disables the projection entirely.

This rule closes the loop statically, without importing anything:

- the protocol registry (``protocols/__init__.py``) is parsed for its
  ``_SIM_MODULES`` and ``_HOST_MODULES`` dict literals, and each
  protocol resolves to its map with the same variant-to-base rule as
  ``trace/host.py:host_algorithm`` (a protocol without a twin of its
  own projects through its sim module's package name — e.g.
  ``paxos_pg`` and ``wankeeper_nofloor``);
- the sim module's ``mailbox_spec`` supplies the mailbox names (dict
  literal keys — constant strings even where the field tuples are
  computed);
- each twin's ``TRACE_MSG_MAP`` (a twin with a ``TWIN_OF =
  "pkg.base_host"`` marker is read as its base) supplies each map, and
  its ``@register_message`` classes the names a map may use.

Checks:

- **PXT301** a registry protocol with a sim kernel whose base resolves
  to no map — its witnesses cannot project at all (reported at the
  registry entry)
- **PXT302** a sim mailbox absent from the map's keys (projection falls
  back to coarse windows for that message type)
- **PXT303** a map key that names no sim mailbox (stale after a kernel
  refactor — it will never match a recorded fault)
- **PXT304** a map value naming no ``@register_message`` class of the
  twin's module (the fabric matches type names, so a typo never fires)
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "trace-map"

REGISTRY = "paxi_tpu_torch/protocols/__init__.py"
MAP_NAME = "TRACE_MSG_MAP"

TARGETS = (REGISTRY, "paxi_tpu_torch/protocols/*/sim*.py",
           "paxi_tpu_torch/protocols/*/host.py",
           "paxi_tpu_torch/protocols/*/nogap.py",
           "paxi_tpu_torch/protocols/*/noread.py",
           "paxi_tpu_torch/trace/demo.py",
           "paxi_tpu_torch/trace/demo_host.py",
           "paxi_tpu_torch/scenarios/demo.py",
           "paxi_tpu_torch/scenarios/demo_host.py")


def _module_to_path(module: str, root: Path) -> Path:
    return root / (module.replace(".", "/") + ".py")


def registry(root: Path) -> List[Tuple[str, str, int]]:
    """(protocol, sim module, line of its registry entry)."""
    tree, _ = astutil.parse_file(root / REGISTRY)
    sims = astutil.parse_module_dict(tree, "_SIM_MODULES")
    if sims is None:
        raise ValueError(f"{REGISTRY}: _SIM_MODULES dict literal not "
                         "found — registry layout changed?")
    return [(k, v.partition(":")[0], line)
            for k, v, line, _ in astutil.str_dict_items(sims)
            if v is not None]


def _twin_of(root: Path, module: str) -> Optional[str]:
    """A host twin module's ``TWIN_OF = "pkg.base_host"`` marker: the
    twin subclasses its base replica to seed a bug and declares that its
    message classes and maps live in the base."""
    path = _module_to_path(module, root)
    if not path.exists():
        return None
    tree, _ = astutil.parse_file(path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "TWIN_OF" \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            return node.value.value
    return None


def twin_modules(root: Path) -> Dict[str, Path]:
    """protocol -> the file holding its host twin's map (its ``TWIN_OF``
    base where it has one)."""
    tree, _ = astutil.parse_file(root / REGISTRY)
    hosts = astutil.parse_module_dict(tree, "_HOST_MODULES")
    if hosts is None:
        raise ValueError(f"{REGISTRY}: _HOST_MODULES dict literal not "
                         "found — registry layout changed?")
    out = {}
    for k, v, _, _ in astutil.str_dict_items(hosts):
        if v is not None:
            out[k] = _module_to_path(_twin_of(root, v) or v, root)
    return out


def _maps(root: Path) -> Dict[str, Tuple[Dict[str, str], int, Path]]:
    """protocol -> (its map, the line of its map, the twin file holding
    it), for every twin that exports a map."""
    out: Dict[str, Tuple[Dict[str, str], int, Path]] = {}
    for protocol, path in twin_modules(root).items():
        if not path.exists():
            continue
        tm = astutil.parse_module_dict(astutil.parse_file(path)[0],
                                       MAP_NAME)
        if tm is not None:
            out[protocol] = ({key: val or "" for key, val, _, _
                              in astutil.str_dict_items(tm)}, tm.lineno,
                             path)
    return out


def trace_maps(root: Path) -> Dict[str, Tuple[Dict[str, str], int]]:
    """protocol -> (its map, the line of the map in its twin's file)."""
    return {k: (m, line) for k, (m, line, _) in _maps(root).items()}


def host_message_classes(path: Path) -> set:
    """The ``@register_message`` classes a host module defines."""
    tree, _ = astutil.parse_file(path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            decs = astutil.decorator_names(node)
            if any(d.split(".")[-1] == "register_message" for d in decs):
                out.add(node.name)
    return out


def base_protocol(protocol: str, sim_mod: str,
                  maps: Dict[str, object]) -> Optional[str]:
    """``trace/host.py:host_algorithm``'s variant rule: the protocol's own
    map, else its sim module's package name; None when neither has one."""
    base = protocol
    if base not in maps:
        parts = sim_mod.rsplit(".", 2)
        base = parts[-2] if len(parts) >= 2 else protocol
    return base if base in maps else None


def sim_mailboxes(sim_path: Path) -> List[Tuple[str, int]]:
    """(mailbox name, line) from the sim module's ``mailbox_spec``."""
    tree, _ = astutil.parse_file(sim_path)
    for node in tree.body:
        if isinstance(node, astutil.FuncNode) and \
                node.name == "mailbox_spec":
            return astutil.string_keys_of_returned_dicts(node)
    return []


def analyzed(root: Path, restrict: Optional[Sequence[Path]] = None
             ) -> List[Tuple[str, str, Path, int]]:
    """(protocol, sim module, sim path, registry line) for every kernel
    this rule checks.  ``restrict`` (files or directories) keeps a
    protocol when its sim module, the registry or a twin's file falls
    inside."""
    dirs = [p.resolve() for p in restrict or [] if p.is_dir()]
    files = {p.resolve() for p in restrict or [] if p.is_file()}

    def inside(path: Path) -> bool:
        rp = path.resolve()
        return rp in files or any(str(rp).startswith(str(d) + "/")
                                  for d in dirs)

    shared = (inside(root / REGISTRY)
              or any(inside(p) for p in twin_modules(root).values()))
    out = []
    for protocol, sim_mod, line in registry(root):
        sim_path = _module_to_path(sim_mod, root)
        if not sim_path.exists():
            continue
        if restrict is not None and not (shared or inside(sim_path)):
            continue
        out.append((protocol, sim_mod, sim_path, line))
    return out


def check(root: Path,
          files: Optional[Sequence[Path]] = None) -> List[Violation]:
    """``files``, when given, restricts the check to protocols whose sim
    module (or the registry, or a twin's file) is in the set."""
    sources = _maps(root)
    maps = {k: (m, line) for k, (m, line, _) in sources.items()}
    out: List[Violation] = []
    seen = set()
    for protocol, sim_mod, sim_path, reg_line in analyzed(root, files):
        boxes = sim_mailboxes(sim_path)
        if not boxes:
            continue            # no mailbox_spec: not a sim kernel
        base = base_protocol(protocol, sim_mod, maps)
        if base is None:
            out.append(Violation(
                rule=RULE, code="PXT301", path=REGISTRY, line=reg_line,
                col=0,
                message=f"protocol `{protocol}` has a sim kernel "
                        f"({astutil.rel(sim_path, root)}) but no host "
                        f"twin with a {MAP_NAME} (its own or its "
                        "base's) — its witnesses cannot project onto "
                        "host fault directives"))
            continue
        key = (base, sim_path)
        if key in seen:
            continue            # a variant on its base's kernel and map
        seen.add(key)
        mapping, line, map_file = sources[base]
        map_path = astutil.rel(map_file, root)
        box_names = {name for name, _ in boxes}
        for name, _ in boxes:
            if name not in mapping:
                out.append(Violation(
                    rule=RULE, code="PXT302", path=map_path, line=line,
                    col=0,
                    message=f"sim mailbox `{name}` of protocol "
                            f"`{protocol}` is not covered by "
                            f"{MAP_NAME} — its recorded faults degrade "
                            "to coarse drop windows"))
        for k in mapping:
            if k not in box_names:
                out.append(Violation(
                    rule=RULE, code="PXT303", path=map_path, line=line,
                    col=0,
                    message=f"{MAP_NAME} key `{k}` names no sim mailbox "
                            f"of protocol `{protocol}` (stale after a "
                            "kernel refactor?)"))
        classes = host_message_classes(map_file)
        for k, val in mapping.items():
            if val not in classes:
                out.append(Violation(
                    rule=RULE, code="PXT304", path=map_path, line=line,
                    col=0,
                    message=f"{MAP_NAME} value `{val}` (key `{k}`) "
                            "names no @register_message class in the "
                            "host module — the fabric matches type "
                            "names, a typo never fires"))
    return out
