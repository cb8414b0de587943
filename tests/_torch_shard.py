"""Helpers of the sharded-tier parity tests (``tests/test_torch_shard*.py``).

Each helper takes the package (``paxi_tpu`` or ``paxi_tpu_torch``) so one
scenario runs the same way in both.  The fabric transports collapse the
router's ``/tpc`` and ``/mig`` hops: a 2PC or migration record packs to
its wire form and goes straight to a group's entry replica, while a
``VirtualClockFabric`` sequences every group's consensus deliveries in
one logical clock.  ``replica_states`` reads what the parity tests hold
equal: every replica's store, its 2PC ``_staged``/``_decided`` and its
migration state.
"""

from __future__ import annotations

import asyncio
import importlib

def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def both(fn, *args):
    """``fn(pkg, *args)`` for the port, held equal to the JAX package's;
    returns the port's."""
    got, want = fn("paxi_tpu_torch", *args), fn("paxi_tpu", *args)
    assert got == want
    return got


def outcome(f, *args):
    """``f(*args)``'s JSON form (or the value itself), or its ValueError."""
    try:
        out = f(*args)
    except ValueError as e:
        return ("ValueError", str(e))
    return out.to_json() if hasattr(out, "to_json") else out


def _record_submit(pkg, sc, pack, traced=False):
    command = mod(pkg, "core.command")
    obs = mod(pkg, "obs")

    async def submit(group, key, rec):
        value = pack(command, rec)
        fut = asyncio.get_running_loop().create_future()
        node = sc.leader_node(group)
        props, sp = {}, None
        if traced:
            sp = node.spans.start("tpc", obs.TraceCtx.decode(rec.get("trace")),
                                  record=rec["kind"], txid=rec["txid"])
            if sp is not None:
                props = {obs.TRACE_PROP: sp.child().encode()}

        def cb(rep, _fut=fut):
            if traced:
                node.spans.finish(sp)
            if not _fut.done():
                _fut.set_result((not rep.err, rep.value
                                 or (rep.err or "").encode()))
        node.handle_client_request(command.Request(
            command=command.Command(int(key), value), properties=props,
            reply_to=cb))
        return await fut
    return submit


def _pack_tpc(command, rec):
    return command.pack_tpc(rec["kind"], rec["txid"], ops=rec.get("ops"),
                            outcome=rec.get("outcome", ""))


def _pack_mig(command, rec):
    return command.pack_mig(rec["kind"], rec["mid"], lo=rec.get("lo", 0),
                            hi=rec.get("hi", 0), span=rec.get("span", 0),
                            items=rec.get("items"),
                            cursor=rec.get("cursor", -1),
                            limit=rec.get("limit", 0))


def tpc_submit(pkg, sc, traced=False):
    """The 2PC coordinator's transport on the fabric; ``traced`` adds the
    router's participant hop (a ``tpc`` span on the entry node, its child
    context in the request's properties)."""
    return _record_submit(pkg, sc, _pack_tpc, traced)


def mig_submit(pkg, sc):
    """The migration coordinator's transport on the fabric."""
    return _record_submit(pkg, sc, _pack_mig)


async def drive(fab, aw, max_steps=2000, tick_s=0.0):
    """Run ``aw`` while stepping the fabric's logical clock; returns the
    finished task (its result or its exception kept)."""
    task = asyncio.ensure_future(aw)
    for _ in range(max_steps):
        if task.done():
            break
        await fab.run(1)
        if tick_s:
            await asyncio.sleep(tick_s)
    assert task.done(), "fabric steps exhausted"
    return task


def fabric_cluster(pkg, groups=2, n=3, tag="shardfab"):
    fab = mod(pkg, "host.fabric").VirtualClockFabric()
    sc = mod(pkg, "shard").ShardedCluster("paxos", groups=groups, n=n,
                                          http=False, fabric=fab, tag=tag)
    return fab, sc


async def fput(pkg, fab, node, key, value, cid="mseed", cmd_id=1):
    command = mod(pkg, "core.command")
    fut = asyncio.get_running_loop().create_future()
    node.handle_client_request(command.Request(
        command=command.Command(key, value, cid, cmd_id), reply_to=fut))
    rep = (await drive(fab, fut)).result()
    assert rep.err is None, rep.err


def fresh_parts(span, groups, base):
    gsize = span // groups
    return {g: [(g * gsize + base, f"v{g}:{base}".encode())]
            for g in range(groups)}


def applied_pairs(sc, parts):
    """The atomicity oracle's readback at every replica of every group."""
    pairs = {}
    for g, ops in parts.items():
        for r in sc.group(g).replicas.values():
            for k, v in ops:
                pairs.setdefault(g, []).append((v, r.db.get(k) or b""))
    return pairs


def _plain(x):
    """JSON-able, order-fixed form of a replica's state dicts."""
    if isinstance(x, dict):
        return sorted((repr(k), _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(_plain(v) for v in x)
    return x


def replica_states(sc) -> dict:
    """Every replica's store, 2PC participant state and migration state."""
    out = {}
    for g, c in enumerate(sc.clusters):
        for i, r in sorted(c.replicas.items(), key=lambda kv: str(kv[0])):
            db = r.db
            out[f"{g}/{i}"] = {
                "data": sorted(db._data.items()),
                "staged": _plain(db._staged), "decided": _plain(db._decided),
                "migration": _plain(db.migration_state()),
                "execute": r.execute,
            }
    return out
