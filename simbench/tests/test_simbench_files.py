"""BENCHMARK.json and every file it names: parsed, found by name, and
within the contract's characters and counts."""

import json
import re

import pytest

from simbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = cells.benchmark()
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["simbench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in SPEC["configs"]] \
        + [w["name"] for w in SPEC["workloads"]] + [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in moves
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("simbench/configs/")
    data = cells.load_json(cells.ROOT / config["file"])
    assert data["name"] == config["name"]
    assert _line(config["source"]) and _line(data["source"])
    assert data["reduced"] == config["reduced"] == []
    assert data["guarantees"] and data["assumed"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    assert cells.reference(data["protocol"]).metrics


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    c = cells.find_cell(cell)
    assert c.groups == 100_000
    assert "fuzz" in c.traffic
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.reader(m.name).read)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(cells.reader(metric).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.find_cell("no_such_cell")
