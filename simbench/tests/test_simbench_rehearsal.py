"""A whole run through the harness's functions on the CPU at a tiny batch:
set-up, the window, the check, the result line; and a traced run."""

import json
import time

import pytest
import torch

from simbench import cells
from simbench.run import _quantiles, run_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def one_thread():
    """A tiny batch gains nothing from threads, and a CPU shared with other
    test workers would slow each round many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, trace, seconds=0.5, groups=6, seed=2 ** 31 + 9):
    c = cells.find_cell(cell)
    return c, run_cell(c, seed, seconds, trace, "cpu", time.perf_counter(),
                       groups=groups)


@pytest.mark.parametrize("cell", CELLS)
def test_window_run(cell):
    # long enough for an epaxos episode to execute commands
    c, out = _run(cell, False, seconds=2.0)
    r = out.result
    assert list(r)[:5] == KEYS and list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0 and r["attempted"] % 6 == 0
    assert set(r["metrics"]) == {m.name for m in c.end_to_end}
    for m in r["metrics"].values():
        assert m["value"] > 0, (r, out.info)
    assert {n.name for n in out.numbers} == set(r["check"])
    assert all(n.value == 0 and n.limit == 0 for n in out.numbers)
    json.dumps(r)


def test_traced_run():
    c, out = _run("epaxos5_conflict_ff", True, groups=4)
    r = out.result
    assert r["correct"] is True
    # two whole episodes: the device pass and the layer pass
    assert r["attempted"] == 2 * c.rounds * 4
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "busy_s" in r["device"] and r["device"]["window_s"] > 0
    # no device here: the device readers find nothing and say nothing
    assert r["metrics"] == {}


def test_quantiles():
    assert _quantiles([]) == []
    assert _quantiles(list(range(1, 11))) == [1] + list(range(1, 11))
