"""The in-fabric consensus tier on the port's host runtime against the JAX
package's: the switchnet register and sequencer units, the tier on the
virtual-clock fabric, and the switchpaxos replica's fast-commit,
gap-agreement, failover and overflow paths, and the nogap twin's
divergence.

Every case runs the same schedule through both packages, each with its
own ``SeqSchedule``, ``SwitchTier``, ``VirtualClockFabric`` and
``Cluster``, and asserts equal delivery logs, stamp logs, tier stats and
replica counters, besides the JAX package's own assertions on the
port's run.  All on the CPU, in logical steps (no wall clocks).
"""

import asyncio
import importlib

import pytest

pytest.importorskip("jax")

PKGS = ("paxi_tpu", "paxi_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def sched_of(pkg, n_steps, faults=()):
    """``faults``: (src, dst, msg_type, occurrence, action, delay)."""
    h = mod(pkg, "trace.host")
    return h.SeqSchedule(n_steps=n_steps, faults=[
        h.SeqFault(s, d, mt, occurrence=k, action=a, delay_steps=x)
        for s, d, mt, k, a, x in faults])


def tier_of(pkg, window=16, n=3, churn=None):
    sw = mod(pkg, "switchnet")
    ch = None
    if churn is not None:
        ch = mod(pkg, "scenarios.spec").SwitchChurn(*churn)
    return sw.SwitchTier(window=window, churn=ch, n_replicas=n)


# ---- switchnet units ---------------------------------------------------------
def _acceptor_run(pkg):
    acc = mod(pkg, "switchnet").SwitchAcceptor(window=4)
    out = []
    r = acc.vote(10, 2, ["a"])
    out.append((r.vbal, r.vcmd))
    acc.promise(20)
    out.append(acc.vote(15, 3, ["b"]))
    out.append(acc.vote(30, 99, ["c"]))
    out.append(acc.overflows)
    r.seq = 7
    r2 = acc.vote(30, 2, ["d"])
    out.append((r2 is r, r2.vbal, r2.vcmd, r2.seq))
    acc.evict(2)
    out.append((acc.base, acc.reg_at(2).vbal))
    acc.evict(10)
    out.append((acc.base, acc.snapshot()))
    return out


def test_acceptor_promise_vote_overflow_evict():
    got = _acceptor_run("paxi_tpu_torch")
    assert got == _acceptor_run("paxi_tpu")
    assert got == [(10, ["a"]), None, None, 1, (True, 30, ["d"], -1),
                   (2, 30), (10, {})]


class Frame:
    switchnet_role = "p2a"

    def __init__(self, ballot, slot, cmds=None):
        self.ballot, self.slot = ballot, slot
        self.cmds = [["k", b"v", "c", 1]] if cmds is None else cmds
        self.sess = self.seq = -1


def _stamp_run(pkg):
    tier = tier_of(pkg, window=8, n=3)
    f = Frame(5, 0)
    a = tier.on_send(0, "1.1", "1.2", f)
    b = tier.on_send(0, "1.1", "1.3", f)
    f2 = Frame(5, 0)
    c = tier.on_send(3, "1.1", "1.2", f2)
    g = Frame(5, 1)
    tier.on_send(1, "1.1", "1.2", g)
    return ([x[0] for x in a], (f.sess, f.seq), b, c, f2.seq, g.seq,
            list(tier.stamp_log), dict(tier.stats))


def test_tier_stamps_once_and_dedups_broadcast_copies():
    got = _stamp_run("paxi_tpu_torch")
    assert got == _stamp_run("paxi_tpu")
    inj, stamp, dup, retrans, seq2, seq3, log, _ = got
    assert inj == ["1.1"] and stamp == (0, 0)
    assert dup == [] and retrans == [] and seq2 == 0 and seq3 == 1
    assert [s[2] for s in log] == [0, 1]


def _churn_run(pkg):
    tier = tier_of(pkg, window=8, churn=(4, 10, 3))
    downs = [tier.down(t) for t in range(20)]
    sess = [tier.session(t) for t in range(20)]
    f = Frame(5, 0, cmds=[])
    a = tier.on_send(5, "1.1", "1.2", f)
    g = Frame(5, 0, cmds=[])
    b = tier.on_send(8, "1.1", "1.2", g)
    return downs, sess, a, f.seq, len(b), (g.sess, g.seq), dict(tier.stats)


def test_tier_down_windows_and_session_bumps():
    got = _churn_run("paxi_tpu_torch")
    assert got == _churn_run("paxi_tpu")
    downs, sess, passed, fseq, n_inj, gstamp, stats = got
    assert not downs[3] and downs[4] and downs[6] and not downs[7]
    assert sess[6] == 0 and sess[7] == 1 and sess[17] == 2
    assert passed == [] and fseq == -1 and stats["passed_down"] == 1
    assert n_inj == 1 and gstamp == (1, 0)


@pytest.mark.parametrize("args", [(5, 0, 4), (-1, 10, 4), (4, 10, 3),
                                  (0, 7, 1)])
def test_switch_schedule_arms_match(args):
    pj = mod("paxi_tpu", "scenarios.schedule")
    pp = mod("paxi_tpu_torch", "scenarios.schedule")
    for t in range(40):
        assert pp.switch_down_at(*args, t) == pj.switch_down_at(*args, t)
        assert pp.switch_session_at(*args, t) \
            == pj.switch_session_at(*args, t)
    for t in range(30):
        assert pp.switch_down_at(5, 0, 4, t) == (5 <= t < 9)
        assert pp.switch_session_at(5, 0, 4, t) == (1 if t >= 9 else 0)


# ---- the switchpaxos replica on the fabric -----------------------------------
def run_cluster(pkg, n_steps=30, faults=(), *, window=16, churn=None,
                n=3, ops_every=2, protocol="switchpaxos"):
    """Boot a ``protocol`` cluster of ``pkg`` on its virtual-clock fabric
    with its tier interposed, drive a deterministic KV workload, return
    (replica counters, stamp log, tier stats, overflows, delivery log,
    fabric stats)."""
    command = mod(pkg, "core.command")
    fabric_mod = mod(pkg, "host.fabric")
    History = mod(pkg, "host.history").History
    sim = mod(pkg, "host.simulation")
    oracle = mod(pkg, "protocols.switchpaxos.host").HUNT_ORACLE
    sched = sched_of(pkg, n_steps, faults)
    tier = tier_of(pkg, window=window, n=n, churn=churn)

    async def main():
        fab = fabric_mod.VirtualClockFabric(sched)
        fab.install_switch(tier)
        c = sim.Cluster(protocol, cfg=sim.chan_config(n, tag="swx"),
                        http=False, fabric=fab)
        await c.start()
        history = History()
        ids = sorted(c.ids)
        ops = []

        async def one_op(replica, key, value, i):
            fut = asyncio.get_running_loop().create_future()
            c[replica].handle_client_request(command.Request(
                command=command.Command(key, value, "t", i), reply_to=fut))
            try:
                rep = await asyncio.wait_for(fut, 5.0)
            except asyncio.TimeoutError:
                return
            if rep.err is None and value:
                history.add(key, value, None, i, i + 0.5)

        def issue(t_):
            if t_ % ops_every:
                return
            i = t_ // ops_every
            ops.append(asyncio.ensure_future(
                one_op(ids[i % len(ids)], i % 4, b"w%d" % t_, i)))

        fab.on_step(issue)
        await fab.run(n_steps, drain=True)
        fab.sched = None
        await fab.run(10, drain=True)
        if ops:
            await asyncio.wait(ops, timeout=5.0)
        out = {
            "anomalies": history.linearizable(),
            "oracle": oracle(c),
            "fast_commits": {str(i): c[i].fast_commits for i in c.ids},
            "gap_events": sum(c[i].gap_events for i in c.ids),
            "commits": max(c[i].execute for i in c.ids),
            "db": {str(i): sorted(c[i].db._data.items()) for i in c.ids},
        }
        await c.stop()
        return (out, list(tier.stamp_log), dict(tier.stats),
                tier.acceptor.overflows, list(fab.delivery_log),
                dict(fab.stats))
    return asyncio.run(main())


def both(*args, **kw):
    """The port's run, held equal to the JAX package's."""
    got = run_cluster("paxi_tpu_torch", *args, **kw)
    want = run_cluster("paxi_tpu", *args, **kw)
    assert got == want
    return got


def test_fast_path_commits_through_switch_votes():
    out, _, stats, _, _, _ = both(30)
    assert out["anomalies"] == 0 and out["oracle"] == 0
    assert out["commits"] > 0 and stats["votes"] > 0
    assert sum(out["fast_commits"].values()) > 0
    assert out["gap_events"] == 0


def test_ordered_multicast_two_replays_byte_identical_stamps():
    faults = [("1.1", "1.2", "OmP2a", 2, "delay", 2)]
    a = both(24, faults)
    b = run_cluster("paxi_tpu_torch", 24, faults)
    assert a == b
    assert len(a[1]) > 0 and a[0]["anomalies"] == 0


GAP_DROPS = [("1.1", "1.2", mt, k, "drop", 0)
             for k in range(2, 5) for mt in ("OmP2a", "OmP3")]


def test_gap_agreement_heals_dropped_frames():
    out, _, _, _, _, _ = both(40, GAP_DROPS)
    assert out["gap_events"] > 0
    assert out["anomalies"] == 0 and out["oracle"] == 0
    assert out["commits"] > 0


def test_gap_agreement_under_mid_epoch_sequencer_kill():
    faults = [("1.1", "1.3", "OmP2a", k, "drop", 0) for k in range(1, 4)]
    out, stamps, stats, _, _, _ = both(50, faults, churn=(10, 0, 8))
    assert out["anomalies"] == 0 and out["oracle"] == 0
    assert out["commits"] > 0 and stats["passed_down"] > 0
    assert any(s[1] == 1 for s in stamps), \
        "no frame stamped in the post-failover session"


def test_register_overflow_falls_back_to_majority():
    out, _, _, overflows, _, _ = both(30, window=1)
    assert out["anomalies"] == 0 and out["oracle"] == 0
    assert out["commits"] > 0 and overflows > 0


def test_nogap_twin_diverges_on_host_too():
    out, _, _, _, _, _ = both(40, GAP_DROPS, protocol="switchpaxos_nogap")
    assert out["oracle"] > 0
    # the same schedule on the real replica stays safe (above)
    assert run_cluster("paxi_tpu_torch", 40, GAP_DROPS)[0]["oracle"] == 0
