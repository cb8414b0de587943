"""The port's host twins against the JAX package's, on the CPU.

Every host twin the hunt and ``scenario run -host`` drive besides the
paxos and switchpaxos ones (``tests/test_torch_switchpaxos_host.py``,
``tests/test_torch_host_runtime.py``): bpaxos and its ``bpaxos_noread``
seeded twin, the ``relay_churn`` demo, wankeeper, wpaxos (with
``core/policy.py``), epaxos, sdpaxos, chain, kpaxos, abd, dynamo and
blockchain.

- Each twin's module data equals the reference's: its message classes and
  their fields, ``TRACE_MSG_MAP``, ``SIM_STATE_MAP``, hunt hooks and
  ``TWIN_OF``; the codec resolves every class name within its own
  package.
- Each twin replays one fault-free and one faulted ``SeqSchedule``
  through ``hunt.classify.replay_schedule`` in both packages, each on its
  own virtual-clock fabric, under one logical clock for the twins' wall
  timers (``_torch_host_twins``): equal ``HostOutcome`` JSON, span
  timelines and per-replica counters.
- ``bpaxos_noread`` and ``relay_churn`` witnesses built by hand classify
  ``reproduced`` in both packages, and the real bpaxos stays safe under
  noread's schedule.
"""

import asyncio
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("jax")

import _torch_host_twins as H  # noqa: E402

NEW_TWINS = ("bpaxos", "bpaxos_noread", "relay_churn", "wankeeper",
             "wpaxos", "epaxos", "sdpaxos", "chain", "kpaxos", "abd",
             "dynamo", "blockchain")


def host_module(pkg, name):
    registry = importlib.import_module(f"{pkg}.protocols")
    return importlib.import_module(registry._HOST_MODULES[name])


def _rel(pkg, module_name):
    return module_name.removeprefix(pkg + ".")


# ---- module data ---------------------------------------------------------
def _message_classes(pkg, module):
    codec = H.mod(pkg, "host.codec")
    out = {}
    for cls, tag in codec._TAGS.items():
        if cls.__module__ == module.__name__:
            out[tag] = [(f.name, str(f.type)) for f in dataclasses.fields(cls)]
    return out


def _hooks(pkg, name):
    m = host_module(pkg, name)
    base = importlib.import_module(getattr(m, "TWIN_OF", m.__name__))
    return {
        "module": _rel(pkg, m.__name__),
        "twin_of": _rel(pkg, getattr(m, "TWIN_OF", "")),
        "messages": _message_classes(pkg, base),
        "trace_msg_map": dict(m.TRACE_MSG_MAP),
        "sim_state_map": dict(getattr(m, "SIM_STATE_MAP", {})),
        "tail_steps": getattr(m, "HUNT_TAIL_STEPS", None),
        "hooks": sorted(k for k in ("HUNT_ORACLE", "HUNT_DRIVER",
                                    "HUNT_FABRIC_SETUP") if hasattr(m, k)),
        "factory": m.new_replica.__qualname__,
    }


@pytest.mark.parametrize("name", NEW_TWINS)
def test_twin_module_data_equals_reference(name):
    got, want = _hooks("paxi_tpu_torch", name), _hooks("paxi_tpu", name)
    assert got == want
    assert got["trace_msg_map"] and got["messages"]


# every module that registers wire classes in either package: the twins,
# the node, the switch, both demo_hosts and the serving modules
REGISTERING = ("host.node", "host.http", "host.client", "switchnet.switch",
               "trace.demo_host", "scenarios.demo_host")


def _codec_view(pkg):
    codec = H.mod(pkg, "host.codec")
    by_tag = {}
    for cls, tag in codec._TAGS.items():
        if not cls.__module__.startswith(pkg + "."):
            continue
        by_tag.setdefault(tag, set()).add(_rel(pkg, cls.__module__))
        assert codec.registered(tag).__module__.startswith(pkg + "."), tag
    return {t: sorted(ms) for t, ms in by_tag.items()}


def codec_views():
    """Both packages' tag -> module views, taken once each package has
    imported the same registering modules: the fixed list, every host
    twin, and every module the other package's view names (another test
    file may have imported one of them in one package only)."""
    for pkg in H.PKGS:
        registry = importlib.import_module(f"{pkg}.protocols")
        for module in registry._HOST_MODULES.values():
            importlib.import_module(module)
        for rel in REGISTERING:
            importlib.import_module(f"{pkg}.{rel}")
    named = {m for pkg in H.PKGS for ms in _codec_view(pkg).values()
             for m in ms}
    for pkg in H.PKGS:
        for rel in sorted(named):
            importlib.import_module(f"{pkg}.{rel}")
    return {pkg: _codec_view(pkg) for pkg in H.PKGS}


def test_codec_resolves_each_class_in_its_own_package():
    """Every twin imported in both packages: one tag per class name in
    each package (``Seq`` is the two demos' both), and each tag resolves
    to the same module of its own package as in the reference (classes
    that other test files register are left out)."""
    for pkg in H.PKGS:
        for name in NEW_TWINS:
            host_module(pkg, name)
    views = codec_views()
    assert views["paxi_tpu_torch"] == views["paxi_tpu"]
    assert views["paxi_tpu_torch"]["Accept"] == ["protocols.epaxos.host"]
    assert views["paxi_tpu_torch"]["SwitchVote"] == ["switchnet.switch"]


def test_codec_views_equal_after_a_jax_only_import():
    """The order that once broke the comparison: a fresh interpreter
    imports the JAX package's switchnet.switch (as
    tests/test_switchpaxos_host.py does) before the views are taken."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("import paxi_tpu.switchnet.switch\n"
            "import test_torch_host_twins as t\n"
            "v = t.codec_views()\n"
            "assert v['paxi_tpu_torch'] == v['paxi_tpu'], v\n"
            "assert 'SwitchSnap' in v['paxi_tpu_torch']\n")
    tests = Path(__file__).resolve().parent
    r = subprocess.run([sys.executable, "-c", code], cwd=tests.parent,
                       env={**__import__("os").environ,
                            "PYTHONPATH": f"{tests}:{tests.parent}",
                            "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


def _policy_run(pkg):
    policy = H.mod(pkg, "core.policy")
    c = policy.new_policy("consecutive", 3)
    out = [[c.hit(z) for z in (1, 1, 2, 2, 2, 2, 1)]]
    for threshold in (0.6, 4):
        m = policy.new_policy("majority", threshold)
        out.append([m.hit(z, now=t) for z, t in
                    ((1, 0.0), (1, 0.2), (2, 0.5), (1, 1.1), (2, 1.2),
                     (2, 1.5), (2, 2.3), (1, 2.4))])
    with pytest.raises(KeyError, match="unknown policy"):
        policy.new_policy("nope", 1)
    out.append(type(policy.new_policy("ema", 2)).__name__)
    return out


def test_policy_equals_reference():
    got = _policy_run("paxi_tpu_torch")
    assert got == _policy_run("paxi_tpu")
    assert got[0] == [None, None, None, None, 2, None, None]


# ---- replays -------------------------------------------------------------
def drop(src, dst, msg, k):
    return (src, dst, msg, k, "drop", 0)


def delay(src, dst, msg, k, steps):
    return (src, dst, msg, k, "delay", steps)


# the replica count of each twin's hunt geometry (hunt/cases.py), a fault
# schedule whose drops, delays and crash windows each fire, and the
# replay's keywords.  Blockchain's ops wait for a confirmed block, which
# the last ops of any replay never get: its op timeout is cut to 1 s.
REPLAYS = {
    "bpaxos": (dict(replicas=7), [drop("1.1", "1.4", "BP2a", 2),
                                  delay("1.2", "1.1", "BP2b", 1, 3)], {}),
    "bpaxos_noread": (dict(replicas=7),
                      [drop("1.1", "1.4", "BP2a", 2)], {}),
    "relay_churn": (dict(replicas=3), [], {"crashed": {"1.1": range(6, 16)}}),
    "wankeeper": (dict(replicas=6, zones=2),
                  [drop("2.1", "1.1", "TReq", 1),
                   delay("1.1", "2.1", "Grant", 2, 3),
                   delay("1.2", "1.1", "ZAck", 1, 2),
                   drop("2.1", "2.2", "ZWrite", 0)], {}),
    "wpaxos": (dict(replicas=6, zones=2),
               [drop("1.1", "2.1", "WP2a", 0),
                delay("2.1", "1.1", "WP2b", 1, 3),
                drop("1.2", "1.1", "WP1b", 0)], {}),
    "epaxos": (dict(replicas=5),
               [drop("1.1", "1.2", "PreAccept", 0),
                drop("1.1", "1.3", "PreAccept", 0),
                delay("1.2", "1.1", "PreAcceptReply", 1, 3)],
               {"crashed": {"1.5": range(10, 17)}}),
    "sdpaxos": (dict(replicas=5),
                [drop("1.1", "1.2", "CAccept", 0),
                 drop("1.1", "1.3", "OAccept", 1),
                 delay("1.2", "1.1", "OAck", 0, 3)], {}),
    "chain": (dict(replicas=3), [delay("1.1", "1.2", "Propagate", 1, 3),
                                 delay("1.3", "1.1", "Ack", 0, 2)], {}),
    "kpaxos": (dict(replicas=3), [drop("1.1", "1.2", "KP2a", 1),
                                  drop("1.3", "1.1", "KP2b", 0),
                                  delay("1.1", "1.3", "KP3", 0, 3)], {}),
    "abd": (dict(replicas=5), [drop("1.1", "1.2", "Store", 0),
                               drop("1.3", "1.1", "QueryReply", 1),
                               delay("1.2", "1.4", "Query", 0, 2)],
            {"crashed": {"1.5": range(13, 18)}}),
    "dynamo": (dict(replicas=5), [drop("1.1", "1.2", "RWrite", 0),
                                  delay("1.2", "1.3", "RWrite", 0, 3)],
               {"crashed": {"1.4": range(3, 12)}}),
    "blockchain": (dict(replicas=5, op_timeout=1.0),
                   [drop("1.1", "1.2", "BlockMsg", 0),
                    delay("1.2", "1.3", "BlockMsg", 1, 3)], {}),
}
STEPS = 30


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["fault_free", "faulted"])
@pytest.mark.parametrize("name", NEW_TWINS)
def test_replay_equals_reference(name, faulted):
    kw, faults, sched = REPLAYS[name]
    if not faulted:
        faults, sched = [], {}
    out, spans, counters = H.both(name, STEPS, faults, **kw, **sched)
    stats = out["fabric_stats"]
    assert out["steps"] == STEPS and stats["submitted"] > 0
    assert sorted(counters) == sorted(
        str(i) for i in H.mod("paxi_tpu_torch", "host.simulation")
        .chan_config(kw["replicas"], zones=kw.get("zones", 1)).ids)
    if name != "relay_churn":     # the demo serves no client ops
        assert out["ops_ok"] > 0 and len(spans) == out["span_count"] > 0
    fired = (stats["dropped_fault"] + stats["delayed_fault"]
             + stats["dropped_crash"])
    assert (fired > 0) == faulted
    if faulted:
        assert stats["dropped_fault"] + stats["dropped_crash"] > 0 \
            or name == "chain"
    # the seeded bugs show, on the host too, under their schedules
    assert (out["oracle_violations"] > 0) == (
        faulted and name in ("bpaxos_noread", "relay_churn"))


def test_noread_diverges_where_bpaxos_holds():
    kw, faults, _ = REPLAYS["bpaxos_noread"]
    real = H.replay("paxi_tpu_torch", "bpaxos", STEPS, faults, **kw)[0]
    noread = H.replay("paxi_tpu_torch", "bpaxos_noread", STEPS, faults,
                      **kw)[0]
    assert real["oracle_violations"] == 0 < noread["oracle_violations"]
    assert real["fabric_stats"]["dropped_fault"] == 1


# ---- hand-sized witnesses ------------------------------------------------
def hand_trace(pkg, protocol, replicas, n_steps, mailbox, drops=(),
               crashed=()):
    """A single-group trace of ``pkg``'s classes: ``drops`` (t, i, j) on
    ``mailbox``'s plane, ``crashed`` (t, i)."""
    if pkg == "paxi_tpu":
        from paxi_tpu.sim import FuzzConfig, SimConfig
        from paxi_tpu.trace.format import Trace, make_meta
    else:
        from paxi_tpu_torch.sim import FuzzConfig, SimConfig
        from paxi_tpu_torch.trace.format import Trace, make_meta
    R, T = replicas, n_steps
    planes = {"drop": np.zeros((T, R, R), bool),
              "delay": np.ones((T, R, R), np.int32),
              "dup": np.zeros((T, R, R), bool)}
    for t, i, j in drops:
        planes["drop"][t, i, j] = True
    crash = np.zeros((T, R), bool)
    for t, i in crashed:
        crash[t, i] = True
    sched = {"conn": np.ones((T, R, R), bool), "crashed": crash,
             "faults": {mailbox: planes}}
    return Trace(meta=make_meta(protocol, SimConfig(n_replicas=R),
                                FuzzConfig(p_drop=0.25, max_delay=2), 0, 1,
                                0, group_violations=1), sched=sched)


WITNESSES = {
    # takeover recovery without the column read: one BP2a lost on each of
    # two edges from the first proxy
    "bpaxos_noread": dict(replicas=7, n_steps=30, mailbox="p2a",
                          drops=[(3, 0, 2), (3, 0, 4)]),
    # the sequencer crashed for ten steps: the takeover's skipped number
    "relay_churn": dict(replicas=3, n_steps=16, mailbox="seq",
                        crashed=[(t, 0) for t in range(6, 16)]),
}


@pytest.mark.parametrize("protocol", sorted(WITNESSES))
def test_hand_witness_classifies_reproduced(protocol):
    from paxi_tpu.hunt import classify_witness as jcw
    from paxi_tpu_torch.hunt import classify_witness as pcw
    kw = WITNESSES[protocol]
    got = pcw(hand_trace("paxi_tpu_torch", protocol, **kw))
    want = jcw(hand_trace("paxi_tpu", protocol, **kw))
    assert got.to_json() == want.to_json()
    assert got.outcome == "reproduced"
    assert got.host["oracle_violations"] > 0 and got.coverage["exact"]


def test_noread_witness_on_the_real_bpaxos_stays_safe():
    from paxi_tpu_torch.hunt import replay_witness
    t = hand_trace("paxi_tpu_torch", "bpaxos", **WITNESSES["bpaxos_noread"])
    out = asyncio.run(replay_witness(t))
    assert out.oracle_violations == 0 and out.ops_ok > 0
    assert out.fabric_stats["dropped_fault"] == 2


@pytest.mark.slow
def test_noread_campaign_equals_reference(tmp_path):
    """The reference's end-to-end acceptance (its ``bpaxos_noread``
    campaign, slow there too): a captured witness shrunk and replayed on
    the host classifies ``reproduced``, with state and report equal to
    the JAX package's apart from wall times."""
    import json

    from paxi_tpu.hunt import Campaign as JCampaign
    from paxi_tpu_torch.hunt import Campaign

    def no_wall(x):
        if isinstance(x, dict):
            return {k: no_wall(v) for k, v in x.items() if k != "wall_s"}
        if isinstance(x, list):
            return [no_wall(v) for v in x]
        return x

    kw = dict(protocols=["bpaxos_noread"], budget=1, quick=True,
              log=lambda m: None, traces_dir=str(tmp_path / "none"))
    rj = JCampaign(tmp_path / "jax", **kw).run()
    rp = Campaign(tmp_path / "port", device="cpu", **kw).run()
    assert no_wall(rp) == no_wall(rj)
    for name in ("state.json", "HUNT_REPORT.json"):
        a = json.loads((tmp_path / "port" / name).read_text())
        b = json.loads((tmp_path / "jax" / name).read_text())
        assert no_wall(a) == no_wall(b), name
    t = rp["summary"]["totals"]
    assert t["witnesses"] >= 1 and t["reproduced"] >= 1
    assert t["unclassified"] == 0
