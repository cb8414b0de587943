"""The check must fail its control and a run whose timed path is broken.

The control is the plain reference in the program's place with every
quorum cut to one replica; the faults break the port's timed path under a
whole harness run (the look for a card skipped): a step that returns its
state unchanged, half of the batch left out with the command total
doubled, a command total altered where it is made, a state plane altered
in one group.  The card's own control runs at the cells' sizes are
``-m gpu``."""

import dataclasses
import time

import pytest
import torch

from simbench import cells
from simbench.control import control_numbers
from simbench.run import run_cell

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = cells.find_cell(cell)
    c.config["check"]["groups"] = 5
    numbers, _ = control_numbers(c, 31, "cpu", groups=16)
    assert not all(n.ok for n in numbers)
    assert {n.name: n for n in numbers}["state_mismatch"].value > 0


def _unchanged(step, metrics):
    def bad(state, inbox, ctx):
        return state, step(state, inbox, ctx)[1]
    return bad, metrics


def _half_batch(step, metrics):
    def bad(state, inbox, ctx):
        new, out = step(state, inbox, ctx)
        g = next(iter(state.values())).shape[-1] // 2
        return {k: torch.cat([v[..., :g], state[k][..., g:]], dim=-1)
                for k, v in new.items()}, out

    def mean_of_half(state, cfg):
        g = next(iter(state.values())).shape[-1] // 2
        half = metrics({k: v[..., :g] for k, v in state.items()}, cfg)
        return {k: v * 2 for k, v in half.items()}
    return bad, mean_of_half


def _total_altered(step, metrics):
    def bad(state, cfg):
        return {k: v + 1 for k, v in metrics(state, cfg).items()}
    return step, bad


def _plane_altered(step, metrics):
    def bad(state, inbox, ctx):
        new, out = step(state, inbox, ctx)
        plane = "execute" if "execute" in new else "xcount"
        changed = new[plane].clone()
        changed[..., 0] += 1
        return dict(new, **{plane: changed}), out
    return bad, metrics


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "total_altered": _total_altered, "plane_altered": _plane_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import paxi_tpu_torch.protocols as registry
    real = registry.sim_protocol

    def broken(name):
        proto = real(name)
        step, metrics = FAULTS[fault](proto.step, proto.metrics)
        return dataclasses.replace(proto, step=step, metrics=metrics)

    monkeypatch.setattr(registry, "sim_protocol", broken)
    c = cells.find_cell(cell)
    out = run_cell(c, 2 ** 32 + 5, 0.3, False, "cpu", time.perf_counter(),
                   groups=8)
    assert out.result["correct"] is False


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_at_cell_size(cell, card):
    c = cells.find_cell(cell)
    for seed in (3_000_000_201, 3_000_000_202, 3_000_000_203):
        numbers, _ = control_numbers(c, seed, card)
        assert {n.name: n for n in numbers}["state_mismatch"].value > 0
