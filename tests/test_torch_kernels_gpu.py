"""The CUDA kernels against their plain versions, on the card: the two
exchange kernels, the transitive closure and the ring shift (at world 1
and over four ranks sharing the card), the EPaxos, SDPaxos and WPaxos
paths on the card against the same runs on the CPU, and a sharded run of
four ranks on the card against the same ranks on the CPU.

Run on a machine with a CUDA card:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Every test skips where ``torch.cuda.is_available()`` is false (decided in
a fixture, never at import).  Imports no JAX.
"""

import pytest
import torch

from paxi_tpu_torch.ops import closure as pc
from paxi_tpu_torch.ops import exchange as px
from paxi_tpu_torch.protocols.paxos.sim import mailbox_spec
from paxi_tpu_torch.sim import mailbox as pmb
from paxi_tpu_torch.sim.types import SimConfig

pytestmark = pytest.mark.gpu

R = 5
SPEC = mailbox_spec(SimConfig(n_replicas=R))
GROUPS = {"small": 8, "main_path": 100_000}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(card, d, g, seed, spec=SPEC, r=R):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=card,
                             dtype=torch.int32)

    out = []
    for fields in spec.values():
        F = 1 + len(fields)
        w = ints((d, F, r, r, g), 1000)
        w[:, 0] = ints((d, r, r, g), 2)
        ob = ints((F, r, r, g), 1000)
        ob[0] = ints((r, r, g), 2)
        out.append((w, ob, ints((r, r, g), 2).bool(),
                    ints((r, r, g), d) + 1, ints((r, r, g), 2).bool()))
    return out


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("size", GROUPS)
def test_deliver_kernel_equals_plain(card, d, size):
    for w, *_ in _blocks(card, d, GROUPS[size], d):
        before = px.wheel_deliver.launches
        got = px.deliver_launch(w)
        assert px.wheel_deliver.launches == before + 1
        want = pmb.deliver_planes(w)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("size", GROUPS)
def test_insert_kernel_equals_plain(card, d, size):
    for block in _blocks(card, d, GROUPS[size], 10 + d):
        before = px.wheel_insert.launches
        got = px.insert_launch(*block)
        assert px.wheel_insert.launches == before + 1
        want = pmb.insert_planes(*block)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


# the wpaxos mailbox under the wan3z scenario: 9 replicas, 5 message
# types, a wheel of 5 + 1 slots (the witness and scenario paths)
WAN_R = 9
WAN_CFG = dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
               steal_threshold=3, locality=0.8)


@pytest.mark.parametrize("size", GROUPS)
def test_exchange_kernels_at_wheel_depth_six(card, size):
    from paxi_tpu_torch.protocols.wpaxos.sim import mailbox_spec as wspec
    spec = wspec(SimConfig(**WAN_CFG))
    for block in _blocks(card, 6, GROUPS[size], 66, spec, WAN_R):
        got = px.deliver_launch(block[0])
        want = pmb.deliver_planes(block[0])
        got_ins = px.insert_launch(*block)
        want_ins = pmb.insert_planes(*block)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(got_ins, want_ins)


def test_scenario_capture_on_card_equals_cpu(card):
    """The thin-Q1 geo capture at the hunt's 16 groups: the card's record
    run (through the kernels, one launch a type a step) equals the CPU's
    plane for plane, and so does the trace."""
    from paxi_tpu_torch import random as tr
    from paxi_tpu_torch import trace
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.scenarios import NAMED
    from paxi_tpu_torch.sim import FuzzConfig
    from paxi_tpu_torch.sim.runner import make_recorded_run
    proto = sim_protocol("wpaxos_thinq1")
    cfg = SimConfig(n_replicas=9, n_zones=3, n_objects=4, n_slots=16,
                    steal_threshold=2, locality=0.3)
    fuzz = FuzzConfig(p_drop=0.05, scenario=NAMED["wan3z"])
    px.reset_launches()
    on_card = make_recorded_run(proto, cfg, fuzz)(
        tr.PRNGKey(0), 16, 40)
    assert px.wheel_deliver.launches == px.wheel_insert.launches == 40 * 5
    on_cpu = make_recorded_run(proto, cfg, fuzz, device="cpu")(
        tr.PRNGKey(0), 16, 40)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}.{k}")
        else:
            yield path, tree

    for (k, a), (_, b) in zip(leaves(on_cpu[4]), leaves(on_card[4])):
        assert torch.equal(a, b.cpu()), k
    assert torch.equal(on_cpu[3], on_card[3].cpu())
    for k in on_cpu[1]:
        assert int(on_cpu[1][k]) == int(on_card[1][k]), k
    a = trace.capture(proto, cfg, fuzz, 0, 16, 40, device="cpu")
    b = trace.capture(proto, cfg, fuzz, 0, 16, 40)
    assert a is not None and a.meta == b.meta
    r = trace.replay(b)
    assert r.state_hash == b.meta["capture_state_hash"]
    assert r.counters == b.meta["capture_counters"]


def test_wrappers_reject_bad_arguments(card):
    w, ob, eff, delay, dup = _blocks(card, 3, 8, 0)[0]
    with pytest.raises(TypeError):
        px.deliver_launch(w.to(torch.int64))
    with pytest.raises(ValueError):
        px.insert_launch(w, ob[:, :, :, :4], eff, delay, dup)


def test_main_path_goes_through_the_kernels(card):
    from paxi_tpu_torch.sim import FuzzConfig, simulate
    from paxi_tpu_torch.protocols import sim_protocol
    cfg = SimConfig(n_replicas=R, n_slots=16)
    px.reset_launches()
    res = simulate(sim_protocol("paxos"), cfg, 64, 12,
                   FuzzConfig(p_drop=0.1, max_delay=3), seed=0)
    assert px.wheel_deliver.launches == px.wheel_insert.launches == 12 * 5
    assert int(res.violations) == 0


# ---- the transitive closure -----------------------------------------------

CLOSURE_SHAPES = {"small": [(b, n) for b in (1, 5, 7, 300)
                            for n in (1, 2, 5, 16, 23, 31, 32, 33, 48, 80,
                                      97, 112, 130, 256)],
                  "main_path": [(500_000, 80)],
                  "n130": [(50_000, 130)],
                  "n256": [(20_000, 256)]}


def _closure_err(a, chunk_bytes=1_300_000_000):
    """Max abs difference of the kernel and the plain version on ``a``,
    the plain version taken in chunks (its float32 operands)."""
    got = pc.closure_launch(a)
    n = a.shape[-1]
    chunk = max(1, chunk_bytes // (4 * n * n))
    err = 0
    for s in range(0, a.shape[0], chunk):
        want = pc.closure_plain(a[s:s + chunk])
        err = max(err, int((got[s:s + chunk].to(torch.int32)
                            - want.to(torch.int32)).abs().max()))
    return err


@pytest.mark.parametrize("p", [0.02, 0.1])
@pytest.mark.parametrize("size", CLOSURE_SHAPES)
def test_closure_kernel_equals_plain(card, size, p):
    gen = torch.Generator(device=card)
    gen.manual_seed(int(p * 1000))
    for b, n in CLOSURE_SHAPES[size]:
        a = torch.rand((b, n, n), generator=gen, device=card) < p
        before = pc.transitive_closure.launches
        assert _closure_err(a) == 0, (b, n, p)
        assert pc.transitive_closure.launches == before + 1
        del a
    torch.cuda.empty_cache()


def test_closure_odd_offset_and_special_graphs(card):
    """A slice at an odd byte offset (``adj_big[1:]`` for N = 5 starts 25
    bytes in), and empty, full, self-loop and ring graphs, at a batch
    that is no multiple of a block's graphs."""
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    big = torch.rand((301, 5, 5), generator=gen, device=card) < 0.3
    assert big[1:].data_ptr() % 2 == 1
    assert _closure_err(big[1:]) == 0
    for n in (1, 2, 31, 32, 33, 80, 130, 256):
        eye = torch.eye(n, dtype=torch.bool, device=card)
        a = torch.stack([torch.zeros_like(eye), torch.ones_like(eye), eye,
                         torch.roll(eye, 1, dims=1), eye])
        before = pc.transitive_closure.launches
        assert _closure_err(a) == 0, n
        assert pc.transitive_closure.launches == before + 1


def test_closure_chain_and_cycle(card):
    a = torch.zeros((1, 6, 6), dtype=torch.bool, device=card)
    for i in range(3):
        a[0, i, i + 1] = True
    a[0, 4, 5] = a[0, 5, 4] = True
    got = pc.transitive_closure(a)[0].cpu()
    assert got[0, 3] and got[1, 3] and not got[3, 0]
    assert got[4, 4] and got[5, 5] and not got.diagonal()[:4].any()


def test_closure_rejects_bad_arguments(card):
    with pytest.raises(ValueError, match="N <= 256"):
        pc.closure_launch(torch.zeros((1, 257, 257), dtype=torch.bool,
                                      device=card))
    with pytest.raises(TypeError):
        pc.closure_launch(torch.zeros((1, 5, 5), dtype=torch.uint8,
                                      device=card))
    with pytest.raises(ValueError, match="contiguous"):
        pc.closure_launch(torch.zeros((1, 5, 5), dtype=torch.bool,
                                      device=card).transpose(1, 2))


# ---- the EPaxos path ------------------------------------------------------

def test_epaxos_card_equals_cpu(card):
    from paxi_tpu_torch.convert import state_to_numpy
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, simulate
    cfg = SimConfig(n_replicas=R, n_slots=16, n_keys=4)
    for fuzz in (FuzzConfig(), FuzzConfig(p_drop=0.1, max_delay=3)):
        a = simulate(sim_protocol("epaxos"), cfg, 64, 40, fuzz, seed=2,
                     device="cpu")
        pc.reset_launches()
        b = simulate(sim_protocol("epaxos"), cfg, 64, 40, fuzz, seed=2)
        assert pc.transitive_closure.launches == 40
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and (sa[k] == sb[k]).all(), k
        for k in a.metrics:
            assert int(a.metrics[k]) == int(b.metrics[k]), k
        assert int(a.violations) == int(b.violations) == 0


# ---- the ring shift (make_remote_lane_shift) ------------------------------

SHIFT_CASES = [((5, 16, 3), torch.int32), ((7,), torch.bool),
               ((1_000_003,), torch.uint8), ((5, 5, 16, 5, 4096), torch.int32)]


def test_shift_kernel_equals_plain_at_world_one(card):
    from paxi_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    assert mesh.world == 1 and mesh.device.type == "cuda"
    shift = px.make_remote_lane_shift(mesh)
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    for epoch in range(3):
        for shape, dtype in SHIFT_CASES:
            x = torch.randint(0, 2 if dtype == torch.bool else 100, shape,
                              generator=gen, device=card).to(dtype)
            before = px.make_remote_lane_shift.launches
            got = shift(x)
            assert px.make_remote_lane_shift.launches == before + 1
            want = px.lane_shift_plain(x, mesh)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(got, x), \
                (epoch, shape)
    shift.check()
    shift.close()


def test_shift_many_equals_plain_at_world_one(card):
    """One launch a call for a state's planes of mixed shapes and dtypes
    (odd-sized bool planes, a plane at an odd byte offset), each equal to
    the plain version; more than MAX_SEGMENTS planes go that many a
    launch."""
    import _torch_ranks
    from paxi_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    shift = px.make_remote_lane_shift(mesh)
    xs = [torch.from_numpy(x).to(card) for x in _torch_ranks.state_planes(0)]
    odd = torch.arange(40, dtype=torch.uint8, device=card)[3:20]
    xs.append(odd)                          # contiguous, 3 bytes in
    before = px.make_remote_lane_shift.launches
    got = shift.many(xs)
    assert px.make_remote_lane_shift.launches == before + 1
    torch.cuda.synchronize()
    for a, x in zip(got, xs):
        assert torch.equal(a, px.lane_shift_plain(x, mesh))
    lots = [torch.full((i + 1,), i, dtype=torch.int32, device=card)
            for i in range(px.MAX_SEGMENTS + 3)]
    before = px.make_remote_lane_shift.launches
    got = shift.many(lots)
    assert px.make_remote_lane_shift.launches == before + 2
    assert all(torch.equal(a, x) for a, x in zip(got, lots))
    shift.close()


def test_shift_wrapper_rejects_bad_arguments(card):
    from types import SimpleNamespace
    from paxi_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    x = torch.zeros((4, 6), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        px.lane_shift_launch([torch.zeros((6, 4), dtype=torch.int32,
                                          device=card).t()], mesh)
    with pytest.raises(ValueError, match="CUDA"):
        px.lane_shift_launch([x, x.cpu()], mesh)
    with pytest.raises(ValueError, match="planes"):
        px.lane_shift_launch([x] * (px.MAX_SEGMENTS + 1), mesh)
    with pytest.raises(ValueError, match="channel"):
        px.lane_shift_launch([x], mesh, SimpleNamespace(
            key=px.channel_key([x.to(torch.int64)])))
    with pytest.raises(ValueError, match="device cpu"):
        px.make_remote_lane_shift(mesh).many([x, x.cpu()])


def test_shift_broken_ring_raises(card):
    """A wait that never ends times out and raises instead of hanging: of
    two ranks sharing the card, rank 1 leaves the ring after one call, so
    rank 0's receive side waits for a shard that never comes."""
    import _torch_ranks
    from paxi_tpu_torch.parallel.launch import spawn
    seen = spawn(2, _torch_ranks.shift_broken_ring, 0.5, backend="gloo",
                 device="cuda", timeout=300)
    assert len(seen[0]) == 2 and seen[1] == []
    assert all("timed out" in m for m in seen[0])


def test_shift_ring_over_four_ranks_on_one_card(card):
    """Four ranks on the one card (gloo): ten epochs of new data each,
    every rank's output equal to its left neighbour's input — the free
    flag holds a sender until its last shard was copied out."""
    import _torch_ranks
    from paxi_tpu_torch.parallel.launch import spawn
    results = spawn(4, _torch_ranks.shift_ring_on_card, 10, (5, 16, 777),
                    backend="gloo", device="cuda", timeout=600)
    for equal, launches in results:
        assert equal == [True] * 10
        assert launches == 2 * 10               # send and receive a call


def test_shift_many_over_four_ranks_on_one_card(card):
    """``shift.many`` over a state's planes on four ranks sharing the card:
    exact on every plane, two launches a call whatever the planes."""
    import _torch_ranks
    from paxi_tpu_torch.parallel.launch import spawn
    results = spawn(4, _torch_ranks.shift_many_on_card, 6, backend="gloo",
                    device="cuda", timeout=600)
    for equal, launches in results:
        assert equal == [True] * 6
        assert launches == 2 * 6


# ---- the sdpaxos and wpaxos paths, and the sharded path --------------------

@pytest.mark.parametrize("name, cfg", [
    ("sdpaxos", dict(n_replicas=5, n_slots=16, n_keys=8)),
    ("wpaxos", dict(n_replicas=9, n_zones=3, n_objects=6, n_slots=16,
                    steal_threshold=3, locality=0.8))])
def test_card_equals_cpu(card, name, cfg):
    from paxi_tpu_torch.convert import state_to_numpy
    from paxi_tpu_torch.protocols import sim_protocol
    from paxi_tpu_torch.sim import FuzzConfig, simulate
    for fuzz in (FuzzConfig(), FuzzConfig(p_drop=0.1, max_delay=3)):
        a = simulate(sim_protocol(name), SimConfig(**cfg), 64, 40, fuzz,
                     seed=2, device="cpu")
        px.reset_launches()
        b = simulate(sim_protocol(name), SimConfig(**cfg), 64, 40, fuzz,
                     seed=2)
        n_types = len(sim_protocol(name).mailbox_spec(SimConfig(**cfg)))
        assert px.wheel_deliver.launches == 40 * n_types
        sa, sb = state_to_numpy(a.state), state_to_numpy(b.state)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and (sa[k] == sb[k]).all(), k
        for k in a.metrics:
            assert int(a.metrics[k]) == int(b.metrics[k]), k
        assert int(a.violations) == int(b.violations) == 0


def test_sharded_run_on_card_equals_cpu(card):
    import _torch_ranks
    from paxi_tpu_torch.parallel.launch import spawn
    case = ("paxos", dict(n_replicas=5, n_slots=16),
            dict(p_drop=0.1, max_delay=3), 10, 30, 3)
    on_cpu = spawn(4, _torch_ranks.sharded_case, *case, device="cpu")
    on_card = spawn(4, _torch_ranks.sharded_case, *case, backend="gloo",
                    device="cuda", timeout=600)
    for a, b in zip(on_cpu, on_card):
        for k in a[0]:
            assert a[0][k].dtype == b[0][k].dtype, k
            assert (a[0][k] == b[0][k]).all(), k
        assert {k: int(v) for k, v in a[1].items()} \
            == {k: int(v) for k, v in b[1].items()}
        assert int(a[2]) == int(b[2]) == 0
