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


def reduced_problems(config, data):
    """What keeps a configuration's cuts from being written down: its
    ``reduced`` has to be the same in ``BENCHMARK.json`` and in its file,
    name keys of the file (at the top or in ``sim``), and each key has its
    published value stated under ``assumed``."""
    problems = []
    if data.get("reduced") != config["reduced"]:
        problems.append("reduced differs between BENCHMARK.json and the file")
    if len(config["reduced"]) > 16:
        problems.append("more than 16 reduced keys")
    assumed = data.get("assumed", {})
    for key in config["reduced"]:
        if not NAME.match(key) or (key not in data
                                   and key not in data.get("sim", {})):
            problems.append(f"reduced key {key!r} is no key of the file")
        text = assumed.get(key, "")
        if not (_line(text) and "published" in text
                and re.search(r"[0-9]", text)):
            problems.append(f"reduced key {key!r} has no published value "
                            "under assumed")
    return problems


def _config_file(config):
    return cells.load_json(cells.ROOT / config["file"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("simbench/configs/")
    data = _config_file(config)
    assert data["name"] == config["name"]
    assert _line(config["source"]) and _line(data["source"])
    assert reduced_problems(config, data) == []
    assert data["guarantees"] and data["assumed"]
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
    assert cells.reference(data).metrics


def test_reduced_key_needs_its_published_value():
    config = dict(SPEC["configs"][0], reduced=["groups"])
    data = _config_file(config)
    data["reduced"] = ["groups"]
    data["assumed"]["groups"] = ("published 1,000,000 groups; 100,000 "
                                 "here, what one card holds")
    assert reduced_problems(config, data) == []
    del data["assumed"]["groups"]
    assert reduced_problems(config, data)
    data["assumed"]["groups"] = "fewer groups"
    assert reduced_problems(config, data)
    assert reduced_problems(dict(config, reduced=[]), data)
    data["reduced"] = config["reduced"] = ["no_such_key"]
    data["assumed"]["no_such_key"] = "published 3"
    assert reduced_problems(config, data)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_by_name(cell):
    c = cells.find_cell(cell)
    entry = {w["name"]: w for w in SPEC["workloads"]}[cell]
    config = {x["name"]: x for x in SPEC["configs"]}[entry["config"]]
    assert c.groups == int(_config_file(config)["groups"]) > 0
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
