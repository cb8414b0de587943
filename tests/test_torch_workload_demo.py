"""``python -m paxi_tpu_torch.workload.demo`` against the JAX package's
``workload/demo.py`` on the CPU: each stage's JSON line equal to the
reference ``main()``'s; and ``host_sampler`` equal to the reference's draw
for draw (the key, the write flag and the key class) over every named
spec, streams and op indices, with and without the flash-crowd surge and
at several migration epochs."""

import json

import pytest

pytest.importorskip("jax")

from paxi_tpu.workload import compile as jwc  # noqa: E402
from paxi_tpu.workload import demo as jdemo  # noqa: E402
from paxi_tpu_torch.workload import NAMED, host_sampler  # noqa: E402
from paxi_tpu_torch.workload import compile as pwc  # noqa: E402
from paxi_tpu_torch.workload import demo  # noqa: E402

STAGES = ("catalog", "sim-lowering-parity", "host-sim-agreement",
          "wpaxos-steal-contrast")


@pytest.fixture(scope="module")
def lines():
    """{stage: (reference line, port line)}, each ``main()``'s stdout."""
    import contextlib
    import io

    out = {}
    for key, fn in (("ref", jdemo.main),
                    ("port", lambda: demo.main(["--device", "cpu"]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn() == 0
        out[key] = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert [x["stage"] for x in out["ref"]] == list(STAGES)
    return {s: (r, p) for s, r, p in zip(STAGES, out["ref"], out["port"])}


@pytest.mark.parametrize("stage", STAGES)
def test_stage_line_equals_reference(lines, stage):
    want, got = lines[stage]
    assert got == want


@pytest.mark.parametrize("name", sorted(NAMED))
@pytest.mark.parametrize("n_keys", [16, 64])
def test_host_sampler_equals_reference(name, n_keys):
    jwl = jwc.named_workload(name)
    pwl = pwc.named_workload(name)
    for stream in (0, 2, 7):
        want = jwc.host_sampler(jwl, n_keys, stream=stream)
        got = host_sampler(pwl, n_keys, stream=stream)
        for i in range(200):
            for surge in (False, True):
                for epoch in (0, 1, 3):
                    assert got(i, surge=surge, epoch=epoch) \
                        == want(i, surge=surge, epoch=epoch), \
                        (name, stream, i, surge, epoch)


def test_host_sampler_matches_the_sim_planes():
    """The sampler's draw is the sim's (group, slot) draw of its stream:
    key and read flag equal ``key_plane``/``read_plane`` (the demo's
    stage 3, over every named spec)."""
    import torch
    slots = torch.arange(64)
    for name in sorted(NAMED):
        wl = pwc.named_workload(name)
        keys = pwc.key_plane(wl, 64, 5, slots).tolist()
        reads = pwc.read_plane(wl, 5, slots).tolist()
        sample = host_sampler(wl, 64, stream=5)
        for i in range(64):
            _, write, _ = sample(i)
            epoch = i // wl.migrate_every if wl.migrate_every > 0 else 0
            assert sample(i, epoch=epoch)[0] == keys[i], (name, i)
            assert write == (not reads[i]), (name, i)
