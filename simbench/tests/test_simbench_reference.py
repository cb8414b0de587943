"""The plain reference against the port on the CPU at a tiny batch: for
both configurations, fault-free and fuzzed, the reference worked out for a
sample of the groups equals the port's whole-batch run at those groups,
plane by plane; worked out for the whole batch, its command total and
exchange counters equal the port's; and its draws are the batch's
draws."""

import dataclasses

import numpy as np
import pytest
import torch

from paxi_tpu_torch import random as port_random
from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig, SimConfig
from paxi_tpu_torch.sim.runner import make_run
from simbench import cells, check
from simbench.program import episode_words, port_config, sample_groups
from simbench.reference import prng
from simbench.reference.common import Faults, Geometry
from simbench.reference.runner import run_episode

CASES = [("paxos5_100k", "fault_free", 24), ("paxos5_100k", "bench_all_fuzz", 30),
         ("epaxos5_conflict_100k", "fault_free", 18),
         ("epaxos5_conflict_100k", "bench_all_fuzz", 14)]


def _config(name):
    return cells.load_json(cells.HERE / "configs" / f"{name}.json")


def _traffic(name):
    return cells.load_json(cells.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("config,traffic,rounds", CASES)
def test_reference_equals_port_on_sampled_groups(config, traffic, rounds):
    cfg_file, fuzz = _config(config), _traffic(traffic)["fuzz"]
    groups, seed = 12, 2 ** 33 + 77
    proto = sim_protocol(cfg_file["protocol"])
    run = make_run(proto, port_config(cfg_file["sim"]), FuzzConfig(**fuzz),
                   device="cpu")
    key = torch.tensor(episode_words(seed, 3), dtype=torch.int64)
    state, _, viols = run(key, groups, rounds)
    lanes = sample_groups(seed, groups, 5)
    ref = cells.reference(cfg_file)
    want, ref_viol, _ = run_episode(ref, Geometry(**cfg_file["sim"]),
                                 Faults(**fuzz), episode_words(seed, 3),
                                 lanes, groups, rounds, "cpu")
    got = {k: v[torch.as_tensor(lanes)] for k, v in state.items()}
    want = {k: torch.movedim(v, -1, 0) for k, v in want.items()}
    assert set(got) == set(want)
    assert check.mismatch(got, want) == 0
    assert int(viols) == 0 and int(ref_viol.sum()) == 0


@pytest.mark.parametrize("config,traffic,rounds", CASES)
def test_reference_counts_equal_ports_over_the_batch(config, traffic,
                                                     rounds):
    cfg_file, fuzz = _config(config), _traffic(traffic)["fuzz"]
    groups, seed = 10, 2 ** 35 + 11
    proto = sim_protocol(cfg_file["protocol"])
    run = make_run(proto, port_config(cfg_file["sim"]), FuzzConfig(**fuzz),
                   device="cpu")
    key = torch.tensor(episode_words(seed, 1), dtype=torch.int64)
    _, metrics, _ = run(key, groups, rounds)
    ref = cells.reference(cfg_file)
    state, _, counts = run_episode(ref, Geometry(**cfg_file["sim"]),
                                   Faults(**fuzz), episode_words(seed, 1),
                                   np.arange(groups), groups, rounds, "cpu")
    command = cfg_file["commands"]
    assert int(metrics[command]) == int(ref.command_count(state, command))
    assert int(metrics[command]) > 0
    got = {k: int(metrics[check.NET_PREFIX + k]) for k in counts}
    assert got == {k: int(v.sum()) for k, v in counts.items()}
    assert got["msgs_sent"] > 0
    if fuzz["p_drop"] > 0:
        assert got["msgs_dropped"] > 0 and got["msgs_delayed"] > 0
    if fuzz["p_dup"] > 0:
        assert got["msgs_duplicated"] > 0


def test_geometry_defaults_are_the_ports():
    port = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert {f.name: f.default for f in dataclasses.fields(Geometry)} == port
    faults = {f.name: f.default for f in dataclasses.fields(FuzzConfig)}
    for f in dataclasses.fields(Faults):
        assert f.default == faults[f.name], f.name


@pytest.mark.parametrize("shape", [(7,), (3, 11), (2, 5, 9)])
def test_lane_draws_are_the_batch_draws(shape):
    words = prng.key_words(2 ** 40 + 3)
    key = torch.tensor(words, dtype=torch.int64)
    lanes = np.array([0, 2, shape[-1] - 1])
    lk = prng.LaneKey(*words, torch.as_tensor(lanes), shape[-1])
    sub = tuple(shape[:-1]) + (len(lanes),)
    assert torch.equal(prng.random_bits(lk, sub),
                       port_random.random_bits(key, shape)[..., lanes])
    assert torch.equal(prng.randint(lk, sub, 1, 4),
                       port_random.randint(key, shape, 1, 4)[..., lanes])
    assert torch.equal(prng.bernoulli(lk, 0.1, sub),
                       port_random.bernoulli(key, 0.1, shape)[..., lanes])
    a, b = prng.fold_words(*words, 17)
    assert [a, b] == port_random.fold_in(key, 17).tolist()
    assert [list(w) for w in prng.split_words(*words, 4)] == \
        port_random.split(key, 4).tolist()


def test_seeds_past_32_bits_differ():
    assert episode_words(2 ** 32 + 1, 0) != episode_words(1, 0)
    assert episode_words(5, 0) != episode_words(5, 1)
