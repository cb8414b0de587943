"""Cross-shard 2PC of the port (``paxi_tpu_torch/shard/txn.py``) against
the JAX package's, on the CPU.

Each scenario runs in both packages on a ``VirtualClockFabric`` that
sequences every group's deliveries in one logical clock, with the router's
``/tpc`` hop collapsed (``_torch_shard``), and every coordinator at
``lease_s=0``, so no wall-clock sleep steers a run: the two packages'
``TxnOutcome``s, recovered outcomes, fabric steps, every replica's store,
``_staged``, ``_decided`` and migration state, and the traced runs'
exported span timelines are held equal, and the atomicity oracle clean.

- commit across groups, and a conflict vote that aborts, then commits
  once the blocker aborts;
- every ``SHARD_ROUTER_CASES`` row (the coordinator killed at a scripted
  point, a fresh party recovering): recovery commits after the decide
  record and aborts before it;
- the same rows traced: one stitched tree over at least two groups, no
  orphans, equal span exports;
- recovery racing a finished coordinator adopts the commit;
- the fault tables equal the JAX package's.
"""

import asyncio
import dataclasses

import pytest

pytest.importorskip("jax")

import _torch_shard as T  # noqa: E402

pytestmark = pytest.mark.host


def test_shard_case_tables_equal_reference():
    got, want = T.mod("paxi_tpu_torch", "hunt.cases"), \
        T.mod("paxi_tpu", "hunt.cases")
    assert got.SHARD_ROUTER_CASES == want.SHARD_ROUTER_CASES
    assert got.SHARD_MIGRATION_CASES == want.SHARD_MIGRATION_CASES
    assert len(got.SHARD_ROUTER_CASES) == 4
    assert len(got.SHARD_MIGRATION_CASES) == 4


def test_shard_exports_equal_reference():
    got, want = T.mod("paxi_tpu_torch", "shard"), T.mod("paxi_tpu", "shard")
    assert got.__all__ == want.__all__
    for name in got.__all__:
        assert getattr(got, name).__module__.startswith("paxi_tpu_torch.")
    assert [f.name for f in dataclasses.fields(got.TxnOutcome)] \
        == [f.name for f in dataclasses.fields(want.TxnOutcome)]
    assert got.ShardCoordinator.FINISH_RETRIES \
        == want.ShardCoordinator.FINISH_RETRIES


def _commit_and_conflict(pkg):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, tag="txnfab")
        await sc.start()
        try:
            submit = T.tpc_submit(pkg, sc)
            coord = shard.ShardCoordinator(submit, lease_s=0.0)
            seen = []
            parts = T.fresh_parts(sc.map.span, 2, 100)
            out = (await T.drive(fab, coord.run_txn(
                parts, txid="tx-commit"))).result()
            assert out.committed and all(v == [b""]
                                         for v in out.values.values())
            pairs = T.applied_pairs(sc, parts)
            assert shard.atomic_check(pairs)
            assert all(o == w for ps in pairs.values() for w, o in ps)
            seen.append((dataclasses.asdict(out), fab.step))
            # another in-flight txn already staged the group-0 key
            parts = T.fresh_parts(sc.map.span, 2, 200)
            blocked = parts[0][0][0]
            ok, payload = (await T.drive(fab, submit(
                0, blocked, {"kind": "prepare", "txid": "blocker",
                             "ops": [(blocked, b"held")]}))).result()
            assert ok and payload.startswith(b"yes:")
            out = (await T.drive(fab, coord.run_txn(
                parts, txid="tx-conflict"))).result()
            assert not out.committed and "abort" in out.err
            pairs = T.applied_pairs(sc, parts)
            assert shard.atomic_check(pairs)
            assert not any(o == w for ps in pairs.values() for w, o in ps)
            seen.append((dataclasses.asdict(out), fab.step))
            # the blocker aborts; the same ops commit under a new txid
            assert (await T.drive(fab, submit(
                0, blocked, {"kind": "abort",
                             "txid": "blocker"}))).result()[0]
            out = (await T.drive(fab, coord.run_txn(
                parts, txid="tx-retry"))).result()
            assert out.committed
            assert shard.atomic_check(T.applied_pairs(sc, parts))
            seen.append((dataclasses.asdict(out), fab.step))
            return seen, T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


def test_commit_and_conflict_abort_equal_reference():
    T.both(_commit_and_conflict)


def _kill_row(pkg, point, groups, n, seed):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, groups, n, tag="txnfab")
        await sc.start()
        try:
            submit = T.tpc_submit(pkg, sc)
            coord = shard.ShardCoordinator(submit, lease_s=0.0)
            parts = T.fresh_parts(sc.map.span, groups, 300 + seed)
            task = await T.drive(fab, coord.run_txn(
                parts, txid=f"tx-{point}-{seed}", crash_at=point))
            exc = task.exception()
            assert isinstance(exc, shard.CoordinatorKilled), exc
            killed = (exc.txid, exc.point, exc.parts, fab.step)
            rec = shard.ShardCoordinator(submit, lease_s=0.0, tag="r")
            outcome = (await T.drive(fab, rec.recover(
                exc.txid, parts))).result()
            want = "c" if point in ("after_decide", "mid_commit") else "a"
            assert outcome == want, (point, outcome)
            pairs = T.applied_pairs(sc, parts)
            assert shard.atomic_check(pairs), (point, pairs)
            assert all(o == w for ps in pairs.values() for w, o in ps) \
                == (outcome == "c")
            return killed, outcome, fab.step, T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


ROUTER_CASES = T.mod("paxi_tpu_torch", "hunt.cases").SHARD_ROUTER_CASES


@pytest.mark.parametrize("point,groups,n,seeds", ROUTER_CASES,
                         ids=[c[0] for c in ROUTER_CASES])
def test_coordinator_kill_row_equals_reference(point, groups, n, seeds):
    for seed in seeds:
        T.both(_kill_row, point, groups, n, seed)


def _traced_kill_run(pkg, point, groups, n, seed):
    shard, obs = T.mod(pkg, "shard"), T.mod(pkg, "obs")

    async def main():
        fab, sc = T.fabric_cluster(pkg, groups, n, tag="txnfab")
        await sc.start()
        try:
            submit = T.tpc_submit(pkg, sc, traced=True)
            col = obs.SpanCollector(node="client", fabric=fab)
            cspans = obs.SpanCollector(node="coord", fabric=fab)
            rspans = obs.SpanCollector(node="rec", fabric=fab)
            coord = shard.ShardCoordinator(submit, lease_s=0.0,
                                           spans=cspans)
            parts = T.fresh_parts(sc.map.span, groups, 500 + seed)
            root = col.start("txn", obs.TraceCtx(f"t2pc-{point}"))
            exc = (await T.drive(fab, coord.run_txn(
                parts, txid=f"tx-{point}", crash_at=point,
                trace=root.child()))).exception()
            assert isinstance(exc, shard.CoordinatorKilled), exc
            rec = shard.ShardCoordinator(submit, lease_s=0.0, tag="r",
                                         spans=rspans)
            outcome = (await T.drive(fab, rec.recover(
                exc.txid, parts, trace=root.child()))).result()
            col.finish(root)
            lists = [cspans.export(), rspans.export(), col.export()]
            for g in range(groups):
                lists.append(obs.label_group(
                    [d for r in sc.group(g).replicas.values()
                     for d in r.spans.export()], g))
            return outcome, obs.merge(lists)
        finally:
            await sc.stop()
    return asyncio.run(main())


@pytest.mark.parametrize("point,groups,n,seeds", ROUTER_CASES,
                         ids=[c[0] for c in ROUTER_CASES])
def test_kill_row_span_trees_equal_reference(point, groups, n, seeds):
    outcome, spans = T.both(_traced_kill_run, point, groups, n, seeds[0])
    obs = T.mod("paxi_tpu_torch", "obs")
    want = "c" if point in ("after_decide", "mid_commit") else "a"
    trace = f"t2pc-{point}"
    assert outcome == want
    assert obs.orphans(spans) == []
    assert trace in obs.stitched_traces(spans)
    assert len(obs.groups_of(spans, trace)) >= 2
    kinds = {d["kind"] for d in spans if d["trace"] == trace}
    assert "tpc" in kinds and ("commit" if want == "c" else "abort") in kinds


def _recover_after_commit(pkg):
    shard = T.mod(pkg, "shard")

    async def main():
        fab, sc = T.fabric_cluster(pkg, tag="txnfab")
        await sc.start()
        try:
            submit = T.tpc_submit(pkg, sc)
            coord = shard.ShardCoordinator(submit, lease_s=0.0)
            parts = T.fresh_parts(sc.map.span, 2, 400)
            out = (await T.drive(fab, coord.run_txn(
                parts, txid="tx-done"))).result()
            assert out.committed
            rec = shard.ShardCoordinator(submit, lease_s=0.0)
            got = (await T.drive(fab, rec.recover("tx-done",
                                                  parts))).result()
            assert got == "c"
            assert all(o == w for ps in T.applied_pairs(sc, parts).values()
                       for w, o in ps)
            return got, fab.step, T.replica_states(sc)
        finally:
            await sc.stop()
    return asyncio.run(main())


def test_recovery_after_commit_equals_reference():
    T.both(_recover_after_commit)


def test_partition_ops_and_atomic_check_equal_reference():
    got, want = T.mod("paxi_tpu_torch", "shard"), T.mod("paxi_tpu", "shard")
    ops = [(k, f"v{k}".encode()) for k in (5, 600_000, 7, 1_048_000,
                                           300_000, -3)]
    for g in (1, 2, 3, 4):
        assert got.partition_ops(got.ShardMap.static(g), ops) \
            == want.partition_ops(want.ShardMap.static(g), ops)
    for pairs in ({0: [(b"a", b"a")], 1: [(b"b", b"b")]},
                  {0: [(b"a", b"a")], 1: [(b"b", b"")]},
                  {0: [(b"a", b"x")], 1: [(b"b", b"")]}, {}):
        assert got.atomic_check(pairs) == want.atomic_check(pairs)
