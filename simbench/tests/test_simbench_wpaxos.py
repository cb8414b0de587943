"""The WPaxos reference against the port on the CPU, at the widths of
``wpaxos9_grid_100k`` (9 replicas in 3 zones, 6 objects, 16 slots) and a
tiny batch: on sampled groups it equals the port's whole-batch run plane
by plane, over the whole batch its command total and exchange counters
equal the port's, in runs that complete steals; its control geometry
breaks the grid quorums, and the check finds the control not correct.

With instant delivery every zone mostly acks a proposal in the same
round, so a fault-free run commits next to nothing cross-zone (none at
this batch): the cross-zone path is held to the port under
``bench_all_fuzz``."""

import dataclasses

import numpy as np
import pytest
import torch

from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig
from paxi_tpu_torch.sim.runner import make_run
from simbench import cells, check
from simbench.program import Program, episode_words, port_config, \
    sample_groups
from simbench.reference import wpaxos
from simbench.reference.common import Faults, Geometry, StepCtx
from simbench.reference.runner import run_episode

CONFIG = cells.load_json(cells.HERE / "configs" / "wpaxos9_grid_100k.json")
SIM = CONFIG["sim"]
CELL = "wpaxos9_grid_ff"
TRAFFIC = ["fault_free", "bench_all_fuzz"]
ROUNDS = 30


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fuzz(traffic):
    return cells.load_json(cells.HERE / "traffic" / f"{traffic}.json")["fuzz"]


def _port(traffic, seed, episode, groups, rounds=ROUNDS):
    run = make_run(sim_protocol("wpaxos"), port_config(SIM),
                   FuzzConfig(**_fuzz(traffic)), device="cpu")
    key = torch.tensor(episode_words(seed, episode), dtype=torch.int64)
    return run(key, groups, rounds)


def _reference(traffic, seed, episode, lanes, groups, geo=None,
               rounds=ROUNDS):
    return run_episode(wpaxos, geo or Geometry(**SIM),
                       Faults(**_fuzz(traffic)), episode_words(seed, episode),
                       lanes, groups, rounds, "cpu")


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_reference_equals_port_on_sampled_groups(traffic):
    groups, seed = 12, 2 ** 33 + 77
    state, _, viols = _port(traffic, seed, 3, groups)
    lanes = sample_groups(seed, groups, 5)
    want, ref_viol, _ = _reference(traffic, seed, 3, lanes, groups)
    got = {k: v[torch.as_tensor(lanes)] for k, v in state.items()}
    assert set(got) == set(want)
    assert check.mismatch(got, {k: torch.movedim(v, -1, 0)
                                for k, v in want.items()}) == 0
    assert int(viols) == 0 and int(ref_viol.sum()) == 0
    # the sample completed steals and committed zone-local slots (and,
    # under faults, cross-zone ones), so those paths were compared
    assert int(want["steals"].sum()) > 0
    assert int(want["m_lat_local_n"].sum()) > 0
    if _fuzz(traffic)["p_drop"] > 0:
        assert int(want["m_lat_cross_n"].sum()) > 0


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_reference_counts_equal_ports_over_the_batch(traffic):
    groups, seed = 10, 2 ** 35 + 11
    _, metrics, _ = _port(traffic, seed, 1, groups)
    state, _, counts = _reference(traffic, seed, 1, np.arange(groups),
                                  groups)
    ref_metrics = wpaxos.metrics(state, Geometry(**SIM))
    assert int(metrics["committed_slots"]) == int(
        wpaxos.command_count(state, "committed_slots")) > 0
    assert {k: int(v) for k, v in ref_metrics.items()} == \
        {k: int(metrics[k]) for k in ref_metrics}
    assert int(metrics["steals"]) > 0
    got = {k: int(metrics[check.NET_PREFIX + k]) for k in counts}
    assert got == {k: int(v.sum()) for k, v in counts.items()}
    assert got["msgs_sent"] > 0


def test_grid_quorums_are_the_papers():
    geo = wpaxos.grid(Geometry(**SIM))
    assert (geo.zone_majority, geo.phase1_zones, geo.phase2_zones) == \
        (2, 3, 1)
    acks = torch.tensor([0b000_000_011, 0b000_011_011, 0b101_010_001],
                        dtype=torch.int32)
    assert wpaxos.zone_quorums(acks, geo).tolist() == [1, 2, 1]


def test_control_cuts_every_quorum_to_one_replica_in_one_zone():
    prog = Program(cells.find_cell(CELL), "cpu", groups=16)
    geo = check.control_geometry(prog)
    assert isinstance(geo, wpaxos.OneReplicaOneZone)
    assert (geo.zone_majority, geo.phase1_zones, geo.phase2_zones) == \
        (1, 1, 1)
    assert {f.name: getattr(geo, f.name)
            for f in dataclasses.fields(Geometry)} == \
        dataclasses.asdict(prog.geo)
    # the same key under the control's geometry gives another result
    lanes = sample_groups(7, 16, 4)
    sound, _, _ = _reference("fault_free", 7, 0, lanes, 16)
    cut, _, _ = _reference("fault_free", 7, 0, lanes, 16, geo=geo)
    assert check.mismatch(cut, sound) > 0
    win = check.control_window(prog, 7, lanes)
    numbers, _ = check.judge(prog, win, 7, lanes, episodes=1)
    assert not all(n.ok for n in numbers)


def test_a_workload_is_refused():
    geo = dataclasses.replace(Geometry(**SIM), workload={"name": "zipf99"})
    with pytest.raises(ValueError, match="workload"):
        wpaxos.init_state(geo, None, 4)
    state = wpaxos.init_state(Geometry(**SIM), None, 4)
    with pytest.raises(ValueError, match="workload"):
        wpaxos.step(state, {}, StepCtx(None, 0, geo))
