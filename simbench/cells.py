"""Find a cell and everything it names, by name, in the files of the
benchmark.

``BENCHMARK.json`` at the repository root lists the cells (``workloads``),
the configurations and the metrics.  A configuration's sizes live in
``simbench/configs/<config>.json`` (its ``sim`` object holds any field of
the port's ``SimConfig``, a ``workload`` object among them), its plain
reference in ``simbench/reference/<name>.py``, where ``<name>`` is the
file's ``reference`` or else its ``protocol``; a traffic mix in
``simbench/traffic/<traffic>.json``; a metric's reader in
``simbench/metrics/<metric>.py``.  Nothing here lists a cell: adding one
is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Metric:
    name: str
    unit: str
    workloads: List[str] = field(default_factory=list)

    def applies_to(self, cell: str) -> bool:
        return not self.workloads or cell in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]           # simbench/configs/<config>.json
    traffic: Dict[str, Any]          # simbench/traffic/<traffic>.json
    end_to_end: List[Metric]
    per_layer: List[Metric]

    @property
    def groups(self) -> int:
        return int(self.config["groups"])

    @property
    def rounds(self) -> int:
        """The rounds of one episode: the configuration's run length."""
        return int(self.config["episode_rounds"])


def load_json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(BENCHMARK)


def _metrics(entries, cell: str) -> List[Metric]:
    """The metrics of ``entries`` that the cell reports."""
    out = [Metric(m["name"], m["unit"], list(m.get("workloads", [])))
           for m in entries]
    return [m for m in out if m.applies_to(cell)]


def find_cell(name: str, spec: Dict[str, Any] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``), with its
    configuration and traffic files read; raises ``KeyError`` for a name
    the benchmark does not hold."""
    spec = benchmark() if spec is None else spec
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=_metrics(spec["end_to_end"], name),
                per_layer=_metrics(spec["per_layer"], name))


def reader(metric: str) -> ModuleType:
    """The module of ``simbench/metrics/<metric>.py`` (a metric's name may
    hold dots, so it is loaded from its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    mod_name = "simbench.metrics." + metric.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(config: Dict[str, Any]) -> ModuleType:
    """The plain reference of a configuration file,
    ``simbench/reference/<name>.py``: ``<name>`` is the file's
    ``reference``, else its protocol."""
    name = config.get("reference", config["protocol"])
    return importlib.import_module(f"simbench.reference.{name}")
