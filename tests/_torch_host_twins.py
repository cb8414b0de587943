"""Shared harness of the host-twin parity tests (``test_torch_host_twins*``).

One ``SeqSchedule`` is replayed by each package's ``replay_schedule``, each
on its own virtual-clock fabric and ``Cluster``, and the run's
``HostOutcome`` JSON, merged span timeline and per-replica counters (every
int attribute of every replica, and its key-value store) come back for the
test to hold equal.

Several twins keep wall-clock timers: watchdogs that sleep on the event
loop (epaxos, wankeeper, sdpaxos, dynamo, the blockchain miner), a
``call_later`` fallback (epaxos) and ages read off ``time.monotonic``
(epaxos, dynamo).  On the fabric those fire after however much real time a
replay happens to take, so two replays of one schedule could differ.  Here
both packages' twin modules run on one logical clock instead: a timer of
``d`` seconds wakes at the ``ceil(d / STEP_S)``-th fabric step after it was
armed (the ``step_s`` the trace projection gives a sim step), and the
modules' ``time`` reads ``step * STEP_S``.  The twins' code is unchanged;
the same substitution goes into both packages, so a difference left is a
difference of the twins.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import heapq
import importlib
import math
import time

STEP_S = 0.05
PKGS = ("paxi_tpu", "paxi_tpu_torch")
# the twin modules that read a clock or arm a timer
TIMED = ("protocols.epaxos.host", "protocols.dynamo.host",
         "protocols.bpaxos.host", "protocols.wankeeper.host",
         "protocols.sdpaxos.host", "protocols.blockchain.host",
         "core.policy")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class StepClock:
    """The logical clock of one package's twins during one replay."""

    def __init__(self):
        self.fabric = None
        self._due: list = []
        self._seq = 0

    def attach(self, fabric) -> None:
        self.fabric, self._due = fabric, []
        fabric.on_step(self._tick)

    def now(self) -> float:
        return 0.0 if self.fabric is None else self.fabric.step * STEP_S

    def _push(self, delay: float, fire) -> None:
        step = 0 if self.fabric is None else self.fabric.step
        at = step + max(1, math.ceil(delay / STEP_S - 1e-9))
        heapq.heappush(self._due, (at, self._seq, fire))
        self._seq += 1

    def _tick(self, t: int) -> None:
        while self._due and self._due[0][0] <= t:
            heapq.heappop(self._due)[2]()

    async def sleep(self, delay, result=None):
        if delay <= 0:
            return await asyncio.sleep(0, result)
        fut = asyncio.get_running_loop().create_future()
        self._push(delay, lambda: fut.done() or fut.set_result(None))
        await fut
        return result

    def call_later(self, delay, fn, *args):
        loop = asyncio.get_running_loop()
        handle = asyncio.Handle(fn, args, loop)

        def fire():
            if not handle.cancelled():
                loop.call_soon(fn, *args)
        self._push(delay, fire)
        return handle


class _Proxy:
    """A module stand-in: ``overrides`` first, then ``base``."""

    def __init__(self, base, **overrides):
        self._base = base
        self.__dict__.update(overrides)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _clock_proxies(clock: StepClock):
    def running_loop():
        return _Proxy(asyncio.get_running_loop(),
                      call_later=clock.call_later)
    aio = _Proxy(asyncio, sleep=clock.sleep, get_running_loop=running_loop)
    tm = _Proxy(time, time=clock.now, monotonic=clock.now)
    return aio, tm


def _factory_cells(module):
    """The closure cells of ``module``'s dataclass constructors that hold a
    wall-clock ``default_factory`` (``born: float =
    field(default_factory=time.monotonic)``)."""
    out = []
    for obj in vars(module).values():
        if not (isinstance(obj, type) and dataclasses.is_dataclass(obj)
                and obj.__module__ == module.__name__):
            continue
        init = obj.__init__
        for name, cell in zip(init.__code__.co_freevars,
                              init.__closure__ or ()):
            if name.startswith("__dataclass_dflt_") and \
                    cell.cell_contents in (time.monotonic, time.time):
                out.append(cell)
    return out


@contextlib.contextmanager
def step_clock(pkg: str, snapshots: list):
    """Put ``pkg``'s timed twins on a ``StepClock`` that every new fabric
    drives, and append each stopping cluster's per-replica counters to
    ``snapshots``."""
    clock = StepClock()
    aio, tm = _clock_proxies(clock)
    fabric_cls = mod(pkg, "host.fabric").VirtualClockFabric
    cluster_cls = mod(pkg, "host.simulation").Cluster
    saved = []
    cells = []
    for name in TIMED:
        m = mod(pkg, name)
        for attr, value in (("asyncio", aio), ("time", tm)):
            if hasattr(m, attr):
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, value)
        for cell in _factory_cells(m):
            cells.append((cell, cell.cell_contents))
            cell.cell_contents = clock.now
    init, stop = fabric_cls.__init__, cluster_cls.stop

    def fabric_init(self, *a, **kw):
        init(self, *a, **kw)
        clock.attach(self)

    async def cluster_stop(self):
        snapshots.append(counters(self))
        await stop(self)

    fabric_cls.__init__, cluster_cls.stop = fabric_init, cluster_stop
    try:
        yield clock
    finally:
        fabric_cls.__init__, cluster_cls.stop = init, stop
        for m, attr, value in saved:
            setattr(m, attr, value)
        for cell, value in cells:
            cell.cell_contents = value


def counters(cluster) -> dict:
    """Every replica's int attributes and its key-value store."""
    out = {}
    for i in sorted(cluster.ids):
        r = cluster[i]
        ints = {k: v for k, v in sorted(vars(r).items())
                if type(v) in (int, bool)}
        ints["db"] = sorted(r.db._data.items())
        out[str(i)] = ints
    return out


def schedule(pkg: str, n_steps: int, faults=(), crashed=None, cut=None):
    """``faults``: (src, dst, msg_type, occurrence, action, delay_steps)."""
    h = mod(pkg, "trace.host")
    return h.SeqSchedule(
        n_steps=n_steps,
        faults=[h.SeqFault(s, d, m, occurrence=k, action=a, delay_steps=x)
                for s, d, m, k, a, x in faults],
        crashed={i: list(ts) for i, ts in (crashed or {}).items()},
        cut={e: list(ts) for e, ts in (cut or {}).items()})


def replay(pkg: str, algorithm: str, n_steps: int, faults=(), *,
           crashed=None, cut=None, replicas: int = 3, zones: int = 1,
           seed: int = 0, tail_steps=None, op_timeout: float = 5.0,
           **sim_kw):
    """One replay of the schedule by ``pkg``: (``HostOutcome`` JSON, span
    timeline, per-replica counters)."""
    sim = mod(pkg, "sim")
    scfg = sim.SimConfig(n_replicas=replicas, n_zones=zones, **sim_kw)
    cfg = mod(pkg, "host.simulation").chan_config(replicas, zones=zones,
                                                  tag="twin")
    sched = schedule(pkg, n_steps, faults, crashed, cut)
    classify = mod(pkg, "hunt.classify")
    snaps: list = []
    with step_clock(pkg, snaps):
        out = asyncio.run(classify.replay_schedule(
            algorithm, scfg, sched, cfg=cfg, seed=seed,
            tail_steps=tail_steps, op_timeout=op_timeout))
    (snap,) = snaps
    return out.to_json(), out.spans, snap


def both(algorithm: str, n_steps: int, faults=(), **kw):
    """The port's replay, held equal to the JAX package's; returns the
    port's (outcome JSON, spans, counters)."""
    got = replay("paxi_tpu_torch", algorithm, n_steps, faults, **kw)
    want = replay("paxi_tpu", algorithm, n_steps, faults, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    return got
