"""The sharded path: the port's ``make_sharded_run`` over four CPU ranks
(``parallel.launch.spawn``, gloo), gathered with ``gather_state``, against
``paxi_tpu.parallel.make_sharded_run`` over four virtual JAX devices on the
same seed, bit for bit — every gathered state plane, every summed metric
including the net_* counters, and the violations — for paxos fault-free,
fuzzed and padded (10 groups over 4 ranks), paxos under zipf99 (each
rank's global group ids), paxos_pg fuzzed under zipf99 and padded (10
groups, pads masked out), epaxos fuzzed, and the dry run's wpaxos and
sdpaxos cases; the per-group runs also against one device; a sharded
pinned replay of a recorded paxos_pg schedule against ``make_pinned_run``
and ``trace.replay(mesh=...)`` against ``trace.replay``; world 1 against a
one-device mesh; the
port's ``dryrun_multichip`` against the JAX runs it mirrors; the ring
shift's plain version against the reference's stand-in, a roll of the
gathered axis, and ``shift.many`` over a state's planes; and the shift's
layout code (receive-buffer offsets, copy units, channel keys)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.random as jr  # noqa: E402
import torch  # noqa: E402

from paxi_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from paxi_tpu.parallel import make_sharded_run as jax_sharded  # noqa: E402
from paxi_tpu.protocols import sim_protocol as jax_protocol  # noqa: E402
from paxi_tpu.sim import FuzzConfig as JFuzz  # noqa: E402
from paxi_tpu.sim import SimConfig as JCfg  # noqa: E402
from paxi_tpu.workload import named_workload as jax_workload  # noqa: E402

import _torch_ranks  # noqa: E402
from _torch_parity import assert_tree_equal  # noqa: E402
from paxi_tpu_torch import dryrun  # noqa: E402
from paxi_tpu_torch import random as tr  # noqa: E402
from paxi_tpu_torch.ops import exchange as pexchange  # noqa: E402
from paxi_tpu_torch.ops.exchange import make_remote_lane_shift  # noqa: E402
from paxi_tpu_torch.parallel import (gather_state, make_mesh,  # noqa: E402
                                     make_sharded_pinned_run,
                                     make_sharded_run)
from paxi_tpu_torch.parallel.launch import spawn  # noqa: E402
from paxi_tpu_torch.protocols import sim_protocol  # noqa: E402
from paxi_tpu_torch.sim import FuzzConfig, SimConfig, runner  # noqa: E402

WORLD = 4
WL_PAXOS = dict(n_replicas=3, n_slots=16, n_keys=64)
DRY_FUZZ = dict(p_drop=0.15, max_delay=2)
DRY = {name: cfg.__dict__ for name, cfg in dryrun.CASES}
# label: (protocol, config, fuzz, groups, steps, seed)
CASES = {
    "paxos_fault_free": ("paxos", DRY["paxos"], {}, 8, 40, 3),
    # the dry run's paxos case: fuzzed, 2 x world groups, key 0
    "paxos_fuzz": ("paxos", DRY["paxos"], DRY_FUZZ, 8, 40, 0),
    "paxos_pad": ("paxos", dict(n_replicas=5, n_slots=16),
                  dict(p_drop=0.1, max_delay=3), 10, 30, 3),
    "epaxos_fuzz": ("epaxos", dict(n_replicas=5, n_slots=16, n_keys=4),
                    dict(p_drop=0.1, max_delay=3), 8, 20, 3),
    "wpaxos_dryrun": ("wpaxos", DRY["wpaxos"], DRY_FUZZ, 8, 40, 0),
    "sdpaxos_dryrun": ("sdpaxos", DRY["sdpaxos"], DRY_FUZZ, 8, 40, 0),
    "paxos_zipf99": ("paxos", WL_PAXOS, {}, 8, 40, 3, "zipf99"),
    "paxos_pg_pad": ("paxos_pg", WL_PAXOS, dict(p_drop=0.1, max_delay=3),
                     10, 40, 3, "zipf99"),
}
PER_GROUP = ("paxos_pg_pad",)
# a recorded paxos_pg schedule replayed as group PIN of 10 over the ranks
PIN = dict(name="paxos_pg", cfg_kw=WL_PAXOS, fuzz_kw=dict(
    p_drop=0.15, max_delay=3, p_partition=0.2, window=8), n_groups=10,
    seed=5, group=6, steps=30, workload="flash")
DRYRUN_CASES = {"paxos": "paxos_fuzz", "wpaxos": "wpaxos_dryrun",
                "sdpaxos": "sdpaxos_dryrun"}
# per-rank shift inputs: group-major (g_local, R, S) and lane-major
# (R, S, g_local)
SHIFT_SHAPES = ((3, 5, 16), (5, 16, 3))


def _jax_run(name, cfg_kw, fuzz_kw, n_groups, n_steps, seed, workload=None,
             n_dev=WORLD):
    cfg = JCfg(**cfg_kw)
    if workload:
        cfg = cfg.with_(workload=jax_workload(workload))
    state, metrics, viol = jax_sharded(
        jax_protocol(name), cfg, JFuzz(**fuzz_kw),
        mesh=jax_make_mesh(n_dev))(jr.PRNGKey(seed), n_groups, n_steps)
    return jax.device_get((state, metrics, viol))


def _pin_record():
    """The one-device record run of PIN and its traced group's schedule."""
    cfg = _torch_ranks.sim_config(PIN["cfg_kw"], PIN["workload"])
    rec = runner.make_recorded_run(
        sim_protocol(PIN["name"]), cfg, FuzzConfig(**PIN["fuzz_kw"]),
        device="cpu")(tr.PRNGKey(PIN["seed"]), PIN["n_groups"], PIN["steps"])

    def group(x):
        if isinstance(x, dict):
            return {k: group(v) for k, v in x.items()}
        return x[:, PIN["group"]].numpy()
    return rec, group(rec[4])


@pytest.fixture(scope="module")
def pin_trace(tmp_path_factory):
    """A capture of PIN's group, saved: ``(trace, path)``."""
    from paxi_tpu_torch import trace
    t = trace.capture(sim_protocol(PIN["name"]),
                      _torch_ranks.sim_config(PIN["cfg_kw"], PIN["workload"]),
                      FuzzConfig(**PIN["fuzz_kw"]), PIN["seed"],
                      PIN["n_groups"], PIN["steps"], group=PIN["group"],
                      device="cpu")
    path = trace.save(str(tmp_path_factory.mktemp("pin") / "pg"), t)
    return t, path


@pytest.fixture(scope="module")
def ranks(pin_trace):
    """Every rank's results of the one spawn of this file."""
    pinned = {"pg": (PIN["name"], PIN["cfg_kw"], PIN["fuzz_kw"],
                     PIN["n_groups"], PIN["seed"], PIN["group"],
                     _pin_record()[1], PIN["workload"])}
    return spawn(WORLD, _torch_ranks.all_cases, CASES, SHIFT_SHAPES,
                 pinned, (pin_trace[1],), device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    return {label: _jax_run(*case) for label, case in CASES.items()}


@pytest.mark.parametrize("label", CASES)
def test_sharded_run_equals_jax(ranks, jax_runs, label):
    j_state, j_metrics, j_viol = jax_runs[label]
    p_state, p_metrics, p_viol = ranks[0]["cases"][label]
    assert_tree_equal(j_state, p_state, "state")
    assert_tree_equal(j_metrics, p_metrics, "metrics")
    assert_tree_equal(j_viol, p_viol, "violations")
    assert int(p_viol) == 0
    assert any(k.startswith("net_") for k in p_metrics)


@pytest.mark.parametrize("label", CASES)
def test_every_rank_holds_the_same_sums_and_state(ranks, label):
    for r in range(1, WORLD):
        assert_tree_equal(ranks[0]["cases"][label], ranks[r]["cases"][label],
                          f"rank {r}")


@pytest.mark.parametrize("label", PER_GROUP)
def test_per_group_sharded_run_equals_one_device(ranks, label):
    """A per-group kernel's sharded run is the single-device run: every
    group keeps its key, so state, metrics and violations are equal."""
    name, cfg_kw, fuzz_kw, g, t, seed, wl = CASES[label]
    want = runner.make_run(sim_protocol(name),
                           _torch_ranks.sim_config(cfg_kw, wl),
                           FuzzConfig(**fuzz_kw), device="cpu")(
        tr.PRNGKey(seed), g, t)
    assert_tree_equal(want, ranks[0]["cases"][label], label)


def test_sharded_pinned_replay_equals_the_pinned_run(ranks):
    rec, sched = _pin_record()
    cfg = _torch_ranks.sim_config(PIN["cfg_kw"], PIN["workload"])
    want = runner.make_pinned_run(
        sim_protocol(PIN["name"]), cfg, FuzzConfig(**PIN["fuzz_kw"]),
        PIN["group"], device="cpu")(tr.PRNGKey(PIN["seed"]),
                                    PIN["n_groups"], sched)
    for r in range(WORLD):
        assert_tree_equal(want, ranks[r]["pinned"]["pg"], f"rank {r}")
    # an unedited record pins to the recorded run itself
    assert_tree_equal(rec[:3], want[:3], "pinned == recorded")


def test_sharded_trace_replay_equals_replay(ranks, pin_trace):
    from paxi_tpu_torch import trace
    trace_, _ = pin_trace
    want = trace.replay(trace_, device="cpu")
    assert want.state_hash == trace_.meta["capture_state_hash"]
    for r in range(WORLD):
        h, viols, steps, metrics, hist = ranks[r]["replays"][0]
        assert h == want.state_hash
        assert viols == want.violations
        np.testing.assert_array_equal(steps, want.viol_steps)
        assert metrics == want.metrics
        assert hist == want.lat_hist


def test_pad_groups_are_excluded_from_protocol_metrics(ranks):
    """At 10 groups over 4 ranks the two pad groups end in their initial
    state before the sums: summed protocol metrics equal the metrics of
    the gathered (trimmed) state."""
    state, metrics, _ = ranks[0]["cases"]["paxos_pad"]
    assert state["execute"].shape[0] == 10
    lane = {k: torch.movedim(torch.from_numpy(v), 0, -1)
            for k, v in state.items()}
    again = sim_protocol("paxos").metrics(lane, SimConfig(n_replicas=5,
                                                          n_slots=16))
    for k, v in again.items():
        assert int(metrics[k]) == int(v), k


def test_world_one_equals_a_one_device_mesh():
    name, cfg_kw, fuzz_kw, g, t, seed = CASES["paxos_pad"]
    want = _jax_run(name, cfg_kw, fuzz_kw, g, t, seed, n_dev=1)
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    state, metrics, viol = make_sharded_run(
        sim_protocol(name), SimConfig(**cfg_kw), FuzzConfig(**fuzz_kw),
        mesh)(tr.PRNGKey(seed), g, t)
    assert_tree_equal(want, (gather_state(state, mesh, g), metrics, viol),
                      "world 1")


@pytest.mark.parametrize("name", DRYRUN_CASES)
def test_dryrun_multichip_sums_equal_jax(ranks, jax_runs, name):
    got = ranks[0]["dryrun"][name]
    _, j_metrics, j_viol = jax_runs[DRYRUN_CASES[name]]
    assert got["violations"] == int(j_viol) == 0
    assert got["metrics"] == {k: int(v) for k, v in j_metrics.items()}
    assert got["metrics"]["committed_slots"] > 0


@pytest.mark.parametrize("shape", SHIFT_SHAPES)
@pytest.mark.parametrize("dtype", ["int32", "bool"])
def test_shift_plain_over_four_ranks(ranks, shape, dtype):
    """On rank r the output is rank r - 1's input; gathered, the outputs
    are the inputs rolled by one shard along the leading axis."""
    pairs = [ranks[r]["shift"][(shape, dtype)] for r in range(WORLD)]
    for r in range(WORLD):
        assert pairs[r][1].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(pairs[r][1], pairs[r - 1][0])
    gathered_in = np.concatenate([x for x, _ in pairs])
    gathered_out = np.concatenate([y for _, y in pairs])
    np.testing.assert_array_equal(
        np.asarray(jnp.roll(gathered_in, shape[0], axis=0)), gathered_out)


@pytest.mark.parametrize("shape", SHIFT_SHAPES)
def test_shift_plain_at_world_one(shape):
    mesh = make_mesh(device="cpu")
    shift = make_remote_lane_shift(mesh)
    for x in _torch_ranks.shift_inputs(0, shape):
        got = shift(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), x)
        np.testing.assert_array_equal(
            np.asarray(jnp.roll(x, shape[0], axis=0)), got.numpy())


def test_shift_many_plain_over_four_ranks(ranks):
    """``shift.many`` over a state's planes (mixed shapes and dtypes, odd-
    sized bool planes): on rank r every plane is rank r - 1's."""
    for r in range(WORLD):
        ins, outs = ranks[r]["many"]
        left_ins = ranks[r - 1]["many"][0]
        assert len(outs) == len(ins)
        for x, y, want in zip(ins, outs, left_ins):
            assert y.dtype == x.dtype and y.shape == x.shape
            np.testing.assert_array_equal(y, want)


def test_shift_many_plain_at_world_one():
    mesh = make_mesh(device="cpu")
    shift = make_remote_lane_shift(mesh)
    xs = [torch.from_numpy(x) for x in _torch_ranks.state_planes(3)]
    got = shift.many(xs)
    assert len(got) == len(xs)
    for x, y in zip(xs, got):
        assert torch.equal(x, y) and y.data_ptr() != x.data_ptr()
        assert torch.equal(y, pexchange.lane_shift_plain(x, mesh))
    assert shift.many([]) == []
    assert torch.equal(shift(xs[1]), xs[1])


def test_shift_many_needs_a_kernel_device():
    shift = make_remote_lane_shift(make_mesh(device="cpu"))
    with pytest.raises(ValueError, match="device meta"):
        shift.many([torch.zeros(3, device="meta")])
    with pytest.raises(ValueError, match="no lane-shift kernel"):
        shift.many([torch.zeros(3), torch.zeros(3, device="meta")])


LAYOUT_KEYS = {
    "state": (((5, 16, 7), torch.int32), ((7,), torch.bool),
              ((3, 333), torch.bool), ((1,), torch.uint8),
              ((4, 5), torch.int32)),
    "one_plane": (((256,), torch.int32),),
    "empty_plane": (((0,), torch.bool), ((17,), torch.uint8)),
    "epaxos_like": tuple(((5, 16, 25_000), dt)
                         for dt in (torch.int32, torch.bool) * 4),
}


@pytest.mark.parametrize("label", LAYOUT_KEYS)
def test_shift_layout_offsets_units_and_tails(label):
    key = LAYOUT_KEYS[label]
    lay = pexchange.shift_layout(key)
    want = [int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
            for shape, dt in key]
    assert list(lay.nbytes) == want
    align = pexchange.SEGMENT_ALIGN
    assert all(o % align == 0 for o in lay.offsets) and lay.offsets[0] == 0
    ends = [o + b for o, b in zip(lay.offsets, lay.nbytes)]
    assert all(e <= o for e, o in zip(ends, lay.offsets[1:]))
    assert lay.flags_off % align == 0 and lay.flags_off >= max(ends)
    assert lay.flags_off >= align
    unit = pexchange.UNIT_BYTES
    assert lay.unit0[0] == 0 and len(lay.unit0) == len(key) + 1
    for i, b in enumerate(lay.nbytes):
        units = lay.unit0[i + 1] - lay.unit0[i]
        assert units == -(-b // unit)
        if units:                      # the last unit holds the byte tail
            tail = b - unit * (units - 1)
            assert 1 <= tail <= unit and tail == (b % unit or unit)


def test_shift_layout_of_an_odd_bool_plane():
    lay = pexchange.shift_layout((((7,), torch.bool), ((3,), torch.int32)))
    assert lay.nbytes == (7, 12) and lay.offsets == (0, 256)
    assert lay.unit0 == (0, 1, 2) and lay.flags_off == 512


def test_channel_key_is_shapes_and_dtypes_in_order():
    xs = [torch.zeros(3, dtype=torch.int32), torch.zeros((2, 2), dtype=bool)]
    assert pexchange.channel_key(xs) == (((3,), torch.int32),
                                         ((2, 2), torch.bool))
    assert pexchange.channel_key(xs[::-1]) != pexchange.channel_key(xs)
    assert pexchange.channel_key(xs) != pexchange.channel_key(
        [xs[0].to(torch.int64), xs[1]])


def test_pinned_replay_rejects_lane_major():
    """As tests/test_parallel.py holds for the reference."""
    with pytest.raises(NotImplementedError, match="lane-major"):
        make_sharded_pinned_run(sim_protocol("paxos"),
                                SimConfig(n_replicas=3, n_slots=16),
                                FuzzConfig(), group=0,
                                mesh=make_mesh(device="cpu"))


def test_per_group_kernels_wait_for_their_slice(ranks):
    """The per-group slice is here: a padded paxos_pg run over four ranks
    reports the real groups only — its summed metrics equal the metrics of
    the gathered (trimmed) state, and its pads add no counters."""
    name, cfg_kw, fuzz_kw, g, t, seed, wl = CASES["paxos_pg_pad"]
    state, metrics, _ = ranks[0]["cases"]["paxos_pg_pad"]
    assert state["execute"].shape[0] == g
    cfg = _torch_ranks.sim_config(cfg_kw, wl)
    again = sim_protocol(name).metrics(
        {k: torch.from_numpy(v) for k, v in state.items()}, cfg)
    for k, v in again.items():
        assert int(metrics[k]) == int(v.sum()), k
    assert state["wl_gid"].tolist() == list(range(g))
    one = runner.make_run(sim_protocol(name), cfg, FuzzConfig(**fuzz_kw),
                          device="cpu")(tr.PRNGKey(seed), g, t)[1]
    assert all(int(metrics[k]) == int(v) for k, v in one.items()
               if k.startswith("net_"))


def test_mesh_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 says"):
        spawn(2, _torch_ranks.fail_on_rank_one, device="cpu")
