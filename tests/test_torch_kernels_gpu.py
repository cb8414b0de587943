"""The two CUDA exchange kernels against their plain versions, on the card.

Run on a machine with a CUDA card:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Every test skips where ``torch.cuda.is_available()`` is false (decided in
a fixture, never at import).  Imports no JAX.
"""

import pytest
import torch

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


def _blocks(card, d, g, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=card,
                             dtype=torch.int32)

    out = []
    for fields in SPEC.values():
        F = 1 + len(fields)
        w = ints((d, F, R, R, g), 1000)
        w[:, 0] = ints((d, R, R, g), 2)
        ob = ints((F, R, R, g), 1000)
        ob[0] = ints((R, R, g), 2)
        out.append((w, ob, ints((R, R, g), 2).bool(),
                    ints((R, R, g), d) + 1, ints((R, R, g), 2).bool()))
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
