"""The WPaxos plain reference (``simbench/reference/wpaxos.py``) against
the port's lane-major kernel on the CPU, at the widths of the benchmark's
``wpaxos9_grid_100k`` (9 replicas in 3 zones, 6 objects, 16 slots) under
``bench_all_fuzz``: five sampled groups worked out alone equal the port's
12-group run at those groups, plane by plane, in a run whose sample
completes steals and commits zone-local and cross-zone slots."""

import torch

from paxi_tpu_torch.protocols import sim_protocol
from paxi_tpu_torch.sim import FuzzConfig
from paxi_tpu_torch.sim.runner import make_run
from simbench import cells, check
from simbench.program import episode_words, port_config, sample_groups
from simbench.reference import wpaxos
from simbench.reference.common import Faults, Geometry
from simbench.reference.runner import run_episode


def test_reference_equals_port_on_sampled_groups_fuzzed():
    sim = cells.load_json(
        cells.HERE / "configs" / "wpaxos9_grid_100k.json")["sim"]
    fuzz = cells.load_json(
        cells.HERE / "traffic" / "bench_all_fuzz.json")["fuzz"]
    groups, rounds, seed = 12, 16, 2 ** 33 + 77
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run = make_run(sim_protocol("wpaxos"), port_config(sim),
                       FuzzConfig(**fuzz), device="cpu")
        state, _, viols = run(torch.tensor(episode_words(seed, 3),
                                           dtype=torch.int64),
                              groups, rounds)
        lanes = sample_groups(seed, groups, 5)
        want, ref_viol, _ = run_episode(
            wpaxos, Geometry(**sim), Faults(**fuzz), episode_words(seed, 3),
            lanes, groups, rounds, "cpu")
    finally:
        torch.set_num_threads(n)
    got = {k: v[torch.as_tensor(lanes)] for k, v in state.items()}
    assert set(got) == set(want)
    assert check.mismatch(got, {k: torch.movedim(v, -1, 0)
                                for k, v in want.items()}) == 0
    assert int(viols) == 0 and int(ref_viol.sum()) == 0
    for plane in ("steals", "m_lat_local_n", "m_lat_cross_n"):
        assert int(want[plane].sum()) > 0, plane
