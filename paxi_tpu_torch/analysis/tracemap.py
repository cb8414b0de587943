"""Trace-map coverage rule family (PXT3xx), sim half, over the port.

The hunt projects a sim trace's per-mailbox fault schedule onto the host
runtime's message classes through the protocol's trace map (sim mailbox
name -> host message class).  The port keeps those maps as data:
``trace/host.py``'s ``TRACE_MSG_MAPS`` literal, keyed by host-registry
name.  Every *unmapped* mailbox degrades to a coarse time-window drop in
the projection; a *missing* map disables the projection entirely.

This rule closes the loop statically, without importing anything:

- the protocol registry (``protocols/__init__.py``) is parsed for its
  ``_SIM_MODULES`` dict literal, and each protocol resolves to its map
  with the same variant-to-base rule as ``trace/host.py:host_algorithm``
  (a protocol without a map of its own projects through its sim
  module's package name — e.g. ``paxos_pg`` and ``wankeeper_nofloor``);
- the sim module's ``mailbox_spec`` supplies the mailbox names (dict
  literal keys — constant strings even where the field tuples are
  computed);
- ``TRACE_MSG_MAPS`` supplies each map.

Checks:

- **PXT301** a registry protocol with a sim kernel whose base resolves
  to no map — its witnesses cannot project at all (reported at the
  registry entry)
- **PXT302** a sim mailbox absent from the map's keys (projection falls
  back to coarse windows for that message type)
- **PXT303** a map key that names no sim mailbox (stale after a kernel
  refactor — it will never match a recorded fault)

Not ported: **PXT304** (a map value naming no ``@register_message``
class of the host module).  It reads the host runtime's message classes,
which stay in the JAX package; the port's maps are copies the hunt tests
hold equal to the JAX package's.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from paxi_tpu_torch.analysis import astutil
from paxi_tpu_torch.analysis.model import Violation

RULE = "trace-map"

REGISTRY = "paxi_tpu_torch/protocols/__init__.py"
MAPS = "paxi_tpu_torch/trace/host.py"
MAPS_NAME = "TRACE_MSG_MAPS"

TARGETS = (REGISTRY, MAPS, "paxi_tpu_torch/protocols/*/sim*.py",
           "paxi_tpu_torch/trace/demo.py",
           "paxi_tpu_torch/scenarios/demo.py")


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


def trace_maps(root: Path) -> Dict[str, Tuple[Dict[str, str], int]]:
    """protocol -> (its map, the line of its entry in TRACE_MSG_MAPS)."""
    tree, _ = astutil.parse_file(root / MAPS)
    d = astutil.parse_module_dict(tree, MAPS_NAME)
    if d is None:
        raise ValueError(f"{MAPS}: {MAPS_NAME} dict literal not found")
    out: Dict[str, Tuple[Dict[str, str], int]] = {}
    for k, v in zip(d.keys, d.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                and isinstance(v, ast.Dict):
            out[k.value] = ({key: val or "" for key, val, _, _
                             in astutil.str_dict_items(v)}, k.lineno)
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
    protocol when its sim module, the registry or the maps file falls
    inside."""
    dirs = [p.resolve() for p in restrict or [] if p.is_dir()]
    files = {p.resolve() for p in restrict or [] if p.is_file()}

    def inside(path: Path) -> bool:
        rp = path.resolve()
        return rp in files or any(str(rp).startswith(str(d) + "/")
                                  for d in dirs)

    shared = inside(root / REGISTRY) or inside(root / MAPS)
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
    module (or the registry, or the maps file) is in the set."""
    maps = trace_maps(root)
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
                        f"({astutil.rel(sim_path, root)}) but no "
                        f"{MAPS_NAME} entry (its own or its base's) — "
                        "its witnesses cannot project onto host fault "
                        "directives"))
            continue
        key = (base, sim_path)
        if key in seen:
            continue            # a variant on its base's kernel and map
        seen.add(key)
        mapping, line = maps[base]
        box_names = {name for name, _ in boxes}
        for name, _ in boxes:
            if name not in mapping:
                out.append(Violation(
                    rule=RULE, code="PXT302", path=MAPS, line=line, col=0,
                    message=f"sim mailbox `{name}` of protocol "
                            f"`{protocol}` is not covered by "
                            f"{MAPS_NAME}[{base!r}] — its recorded "
                            "faults degrade to coarse drop windows"))
        for k in mapping:
            if k not in box_names:
                out.append(Violation(
                    rule=RULE, code="PXT303", path=MAPS, line=line, col=0,
                    message=f"{MAPS_NAME}[{base!r}] key `{k}` names no "
                            f"sim mailbox of protocol `{protocol}` "
                            "(stale after a kernel refactor?)"))
    return out
