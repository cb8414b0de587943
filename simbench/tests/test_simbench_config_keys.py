"""A configuration may state any field of the port's ``SimConfig``, a
workload object among them, and its reference may give its own control:
built here as dicts, on the CPU at a tiny batch."""

import dataclasses
import time
import types

import pytest
import torch

from paxi_tpu_torch.workload import Workload
from simbench import cells, check
from simbench.program import Program, sample_groups
from simbench.reference import paxos as paxos_ref
from simbench.run import run_cell

# every extra of SimConfig away from its default; the paxos kernels read
# none of them, so the reference still agrees with the port
EXTRAS = {"n_zones": 3, "n_objects": 4, "steal_threshold": 5, "grid_q2": 2,
          "locality": 0.5, "fast_quorum": False, "n_proxies": 3,
          "grid_rows": 3, "grid_cols": 1, "batch_max": 2, "sw_window": 8,
          "sw_down_start": 4, "sw_down_period": 10, "sw_down_for": 2}
WORKLOAD = {"name": "zipf99", "dist": "zipf", "theta": 0.99,
            "read_frac": 0.1}
SEED = 2 ** 33 + 501


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(sim, traffic="bench_all_fuzz", rounds=12):
    config = {"name": "test_config", "protocol": "paxos",
              "sim": dict(n_replicas=3, n_slots=16, **sim),
              "groups": 64, "episode_rounds": rounds,
              "commands": "committed_slots", "warmup_rounds": 9,
              "check": {"groups": 8, "episodes": 1, "whole_batch": True}}
    return cells.Cell(
        name="test_cell", chips=1, config=config,
        traffic=cells.load_json(cells.HERE / "traffic" / f"{traffic}.json"),
        end_to_end=[], per_layer=[])


@pytest.fixture
def geometries(monkeypatch):
    """Every geometry the check hands the reference's round loop."""
    seen = []
    real = check.run_episode

    def spy(ref, geo, *args, **kw):
        seen.append(geo)
        return real(ref, geo, *args, **kw)

    monkeypatch.setattr(check, "run_episode", spy)
    return seen


def test_extra_keys_reach_both_sides_and_run_correct(geometries):
    cell = _cell(EXTRAS)
    prog = Program(cell, "cpu")
    for k, v in EXTRAS.items():
        assert getattr(prog.cfg, k) == v and getattr(prog.geo, k) == v, k
    out = run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert out.result["correct"] is True, out.result
    assert out.result["attempted"] > 0
    assert geometries and all(g == prog.geo for g in geometries)


def test_workload_object_reaches_both_sides():
    cell = _cell({"workload": WORKLOAD})
    prog = Program(cell, "cpu")
    assert isinstance(prog.cfg.workload, Workload)
    assert prog.cfg.workload == Workload.from_dict(WORKLOAD)
    assert type(prog.geo.workload) is dict and prog.geo.workload == WORKLOAD
    out = run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter())
    assert out.result["attempted"] > 0
    # the paxos reference runs no workload model: the check refuses to
    # pass a configuration whose reference does not follow its workload
    # (such a configuration names its own under ``reference``)
    numbers = {n.name: n.value for n in out.numbers}
    assert numbers["state_mismatch"] > 0 and out.result["correct"] is False


def test_a_configuration_names_its_reference():
    assert cells.reference({"protocol": "paxos"}) is paxos_ref
    assert cells.reference({"protocol": "wpaxos",
                            "reference": "paxos"}) is paxos_ref


def _control_geometries(prog, geometries):
    lanes = sample_groups(SEED, prog.groups, 8)
    check.control_window(prog, SEED, lanes)
    return list(geometries)


def test_control_uses_the_references_own_geometry(geometries):
    prog = Program(_cell({}, traffic="fault_free", rounds=6), "cpu")
    own = dataclasses.replace(prog.geo, n_zones=3, grid_q2=3)
    standin = types.ModuleType("standin")
    standin.__dict__.update(
        {k: v for k, v in vars(paxos_ref).items() if not k.startswith("__")})
    standin.control_geometry = lambda geo: own if geo == prog.geo else None
    prog.ref = standin
    assert _control_geometries(prog, geometries) == [own]


def test_control_without_its_own_geometry_cuts_quorums_to_one(geometries):
    prog = Program(_cell(EXTRAS, traffic="fault_free", rounds=6), "cpu")
    assert not hasattr(prog.ref, "control_geometry")
    (geo,) = _control_geometries(prog, geometries)
    assert isinstance(geo, check.QuorumOfOne)
    assert geo.majority == geo.fast_size == 1
    assert dataclasses.asdict(geo) == dataclasses.asdict(prog.geo)
