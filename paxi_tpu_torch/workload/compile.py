"""Compile Workloads onto the sim kernels, and the named-workload registry
(the port's copy of the JAX package's ``workload/compile.py``, sim half).

A workload rides inside the ``SimConfig`` (``apply_workload``).  Kernels
derive each command's key id, read flag and key class from counter-based
draws: an integer hash of (spec seed, global group id, absolute slot or
step, channel).  Nothing is drawn ahead and nothing is shaped over the
batch, so the lane-major and per-group lowerings of one spec give the same
command planes, and a sharded run re-derives its slice exactly (each rank
offsets its local group ids to global ones).

The popularity distribution is lowered once per (spec, key count) into a
quantized inverse-CDF rank table (``icdf_table``, pure Python); the table
lives on the device once per (spec, key count, device).  A draw is hash ->
quantile -> table -> popularity rank; hot-key migration then rotates rank
-> key id by epoch.  Key classes (hot/warm/cold) are rank ranges.

The hash is uint32 arithmetic.  Torch has no uint32 shifts, products or
compares on every device, so the words are held in int64 and masked; a
product with a constant of 2**31 or more would pass 2**63, so such
constants multiply in 16-bit halves (every partial product stays under
2**48).  ``host_sampler`` is the same draw in Python ints, for a client
that generates requests off the device, and ``surge_steps``/``host_rates``
lower a FlashCrowd onto the host generator's rate ramp.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.workload.spec import CLASSES, FlashCrowd, Workload

# quantized inverse-CDF resolution: draws use the hash's top _QBITS bits
_QBITS = 12
Q = 1 << _QBITS
_QSHIFT = 32 - _QBITS

# draw channels: each derived quantity hashes a distinct channel; wpaxos
# demand adds the replica index to CH_DEMAND
CH_KEY = 0x000      # key-popularity rank
CH_READ = 0x100     # read-vs-write coin
CH_GATE = 0x200     # flash-crowd demand duty cycle
CH_DEMAND = 0x300   # wpaxos per-replica object demand (+ replica idx)
CH_FOCUS = 0x400    # host: surge hot-focus coin
CH_HOT = 0x500      # host: surge hot-rank choice

# mix multipliers (odd 32-bit constants)
_C_GID = 0x9E3779B1
_C_SLOT = 0x85EBCA77
_C_CHAN = 0xC2B2AE3D
_C_SEED = 0x27D4EB2F
_M32 = 0xFFFFFFFF


# ---- the popularity table (pure Python) ----------------------------------

@functools.lru_cache(maxsize=None)
def icdf_table(wl: Workload, n_keys: int) -> Tuple[int, ...]:
    """Quantized inverse CDF: ``table[q]`` is the popularity rank drawn at
    quantile ``(q + 0.5) / Q``.  Rank 0 is the most popular."""
    K = max(int(n_keys), 1)
    if wl.dist == "zipf":
        w = [1.0 / math.pow(r + 1, wl.theta) for r in range(K)]
    elif wl.dist == "hotset":
        h = min(wl.hot_keys, K)
        if h >= K:
            w = [1.0] * K
        else:
            hw = wl.hot_weight
            w = [hw / h] * h + [(1.0 - hw) / (K - h)] * (K - h)
    else:
        w = [1.0] * K
    total = sum(w)
    acc, cdf = 0.0, []
    for x in w:
        acc += x / total
        cdf.append(acc)
    table = []
    r = 0
    for q in range(Q):
        target = (q + 0.5) / Q
        while r < K - 1 and cdf[r] < target:
            r += 1
        table.append(r)
    return tuple(table)


def rank_pmf(wl: Workload, n_keys: int) -> Tuple[float, ...]:
    """The per-rank probability the quantized table realizes."""
    counts = [0] * max(int(n_keys), 1)
    for r in icdf_table(wl, n_keys):
        counts[r] += 1
    return tuple(c / Q for c in counts)


def class_cuts(wl: Workload, n_keys: int) -> Tuple[int, int]:
    """Rank thresholds of the hot/warm/cold split: ranks below ``n_hot``
    are hot, below ``n_warm`` warm, the rest cold."""
    K = max(int(n_keys), 1)
    if wl.dist == "hotset":
        n_hot = min(wl.hot_keys, K)
    else:
        n_hot = min(max(1, math.ceil(wl.hot_cut * K)), K)
    n_warm = min(max(n_hot, math.ceil(wl.warm_cut * K)), K)
    return n_hot, n_warm


def class_of_rank(wl: Workload, n_keys: int, rank: int) -> int:
    n_hot, n_warm = class_cuts(wl, n_keys)
    return 0 if rank < n_hot else (1 if rank < n_warm else 2)


@functools.lru_cache(maxsize=None)
def obj_class_table(wl: Workload, n_keys: int,
                    n_objects: int) -> Tuple[int, ...]:
    """Key class per wpaxos object: demand maps key -> object by ``key %
    n_objects``, so object ``o``'s most popular resident at epoch 0 is
    rank ``o`` and its class labels the object."""
    return tuple(class_of_rank(wl, n_keys, min(o, n_keys - 1))
                 for o in range(n_objects))


def _frac_thr(frac: float) -> int:
    """uint32 threshold with P(u < thr) = frac (clamped)."""
    return max(0, min(int(frac * 4294967296.0), 0xFFFFFFFF))


@functools.lru_cache(maxsize=64)
def _table_on(table: Tuple[int, ...], device) -> torch.Tensor:
    """A table as an int32 tensor on ``device``, built once (a copy to the
    card each step would wait for the card)."""
    return torch.tensor(table, dtype=torch.int32, device=device)


def obj_class_plane(wl: Workload, n_keys: int, n_objects: int,
                    device) -> torch.Tensor:
    """``obj_class_table`` as an int32 ``(O,)`` tensor on ``device``."""
    return _table_on(obj_class_table(wl, n_keys, n_objects),
                     torch.device(device))


# ---- the sim lowering (int64-held uint32 words) --------------------------

def _u32(x):
    """``x`` as a uint32 word: a tensor in int64, or a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x, c: int):
    """``x * c mod 2**32`` for a uint32 word ``x`` and a constant ``c <
    2**32``: the constant in 16-bit halves, so no product reaches 2**49."""
    if not isinstance(x, torch.Tensor):
        return (x * c) & _M32
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _h32(x):
    """lowbias32-style avalanche on uint32 words (int64 tensors)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _draw_u(wl: Workload, gid, slot, chan):
    """One uint32 (held in int64) per (spec seed, group id, slot or step,
    channel): the counter-based draw every derived plane starts from.
    ``gid``/``slot``/``chan`` are tensors or Python ints and broadcast."""
    x = (_mul32(_u32(gid), _C_GID) ^ _mul32(_u32(slot), _C_SLOT)
         ^ _mul32(_u32(chan), _C_CHAN)
         ^ (((wl.seed & _M32) * _C_SEED) & _M32))
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int64)
    return _h32(x)


def rank_plane(wl: Workload, n_keys: int, gid, slot, chan=CH_KEY):
    """Popularity ranks (int32) drawn at (group, absolute slot)."""
    u = _draw_u(wl, gid, slot, chan)
    table = _table_on(icdf_table(wl, n_keys), u.device)
    return table[u >> _QSHIFT]


def key_plane(wl: Workload, n_keys: int, gid, slot, chan=CH_KEY):
    """Key ids (int32) at (group, absolute slot): the rank draw, then the
    hot-key migration (the rank -> key rotation advances one hot-set width
    every ``migrate_every`` steps, derived from the absolute slot)."""
    rank = rank_plane(wl, n_keys, gid, slot, chan)
    if wl.migrate_every <= 0:
        return rank
    if isinstance(slot, torch.Tensor):
        epoch = torch.div(slot.to(torch.int32), wl.migrate_every,
                          rounding_mode="floor")
    else:                        # a host step: no tensor, no copy
        epoch = int(slot) // wl.migrate_every
    n_hot, _ = class_cuts(wl, n_keys)
    return torch.remainder(rank + epoch * n_hot, n_keys)


def _shape(gid, slot):
    return torch.broadcast_shapes(tuple(getattr(gid, "shape", ())),
                                  tuple(getattr(slot, "shape", ())))


def read_plane(wl: Workload, gid, slot):
    """Read flags (bool) at (group, absolute slot)."""
    if wl.read_frac <= 0.0 or wl.read_frac >= 1.0:
        dev = next((x.device for x in (gid, slot)
                    if isinstance(x, torch.Tensor)), None)
        fill = torch.zeros if wl.read_frac <= 0.0 else torch.ones
        return fill(_shape(gid, slot), dtype=torch.bool, device=dev)
    u = _draw_u(wl, gid, slot, CH_READ)
    return u < _frac_thr(wl.read_frac)


def class_plane(wl: Workload, n_keys: int, gid, slot, chan=CH_KEY):
    """Key-class ids (int32; 0/1/2 = hot/warm/cold) of the commands at
    (group, absolute slot): the rank-range label."""
    rank = rank_plane(wl, n_keys, gid, slot, chan)
    n_hot, n_warm = class_cuts(wl, n_keys)
    return ((rank >= n_hot).to(torch.int32)
            + (rank >= n_warm).to(torch.int32))


def flash_on(wl: Workload, t):
    """Is sim step ``t`` inside a surge window?  A Python bool for a Python
    int ``t``, a bool tensor for a tensor; None for a flashless spec.
    Floor semantics for ``t < start``, as the reference's."""
    fl = wl.flash
    if fl is None:
        return None
    if isinstance(t, torch.Tensor):
        t = t.to(torch.int32)
        if fl.period > 0:
            ph = torch.remainder(t - fl.start, fl.period)
            return (t >= fl.start) & (ph < fl.duration)
        return (t >= fl.start) & (t < fl.start + fl.duration)
    t = int(t)
    if fl.period > 0:
        return t >= fl.start and (t - fl.start) % fl.period < fl.duration
    return fl.start <= t < fl.start + fl.duration


def demand_gate(wl: Workload, gid, t, chan=CH_GATE):
    """Flash-crowd lowering for the sim's closed proposer loop: outside
    surge windows new proposals run a ``1/mult`` duty cycle (a counter
    coin per (group, step)); a surge lifts the gate.  None when the spec
    has no flash component."""
    fl = wl.flash
    if fl is None:
        return None
    u = _draw_u(wl, gid, t, chan)
    duty = u < _frac_thr(1.0 / fl.mult)
    return duty | flash_on(wl, t)


def class_hist_planes(state, cls, newly, dt):
    """A lane-major kernel's per-key-class latency planes after a step's
    commits (and its ``wl_gid`` passed through): each newly committed cell
    bins its delta ``dt`` into its class's histogram.  ``cls`` holds the
    classes, broadcasting against ``newly``; the group axis is last."""
    out = {}
    axes = tuple(range(newly.ndim - 1))
    for ci, nm in enumerate(CLASSES):
        mask = newly & (cls == ci)
        out[f"m_wl_hist_{nm}"] = lathist.hist_update(
            state[f"m_wl_hist_{nm}"], dt, mask)
        out[f"m_wl_sum_{nm}"] = state[f"m_wl_sum_{nm}"] + torch.sum(
            torch.where(mask, dt, 0), dim=axes, dtype=torch.int32)
    out["wl_gid"] = state["wl_gid"]
    return out


# ---- host lowering (python ints; the same hash family) --------------------

def _h32i(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def _draw_ui(wl: Workload, stream: int, i: int, chan: int) -> int:
    return _h32i((stream * _C_GID) ^ (i * _C_SLOT) ^ (chan * _C_CHAN)
                 ^ ((wl.seed & 0xFFFFFFFF) * _C_SEED))


def host_sampler(wl: Workload, n_keys: int, stream: int = 0):
    """The per-op draw of a request generator: ``sample(i, surge=...,
    epoch=...)`` -> ``(key, write, key_class)`` for the i-th op of stream
    ``stream``, deterministic in (spec, stream, i) and equal to the sim's
    (group, slot) draws of group ``stream``.  ``surge`` applies the
    FlashCrowd ``focus`` re-aim; ``epoch`` is the migration epoch."""
    K = max(int(n_keys), 1)
    table = icdf_table(wl, K)
    n_hot, n_warm = class_cuts(wl, K)
    fl = wl.flash
    focus_thr = _frac_thr(fl.focus) if fl is not None else 0
    read_thr = _frac_thr(wl.read_frac)
    always_read = wl.read_frac >= 1.0
    never_read = wl.read_frac <= 0.0

    def sample(i: int, surge: bool = False,
               epoch: int = 0) -> Tuple[int, bool, str]:
        rank = table[_draw_ui(wl, stream, i, CH_KEY) >> _QSHIFT]
        if surge and focus_thr \
                and _draw_ui(wl, stream, i, CH_FOCUS) < focus_thr:
            rank = _draw_ui(wl, stream, i, CH_HOT) % n_hot
        key = rank
        if wl.migrate_every > 0 and epoch:
            key = (rank + epoch * n_hot) % K
        if always_read:
            write = False
        elif never_read:
            write = True
        else:
            write = _draw_ui(wl, stream, i, CH_READ) >= read_thr
        cls = CLASSES[0 if rank < n_hot else (1 if rank < n_warm else 2)]
        return key, write, cls

    return sample


def surge_steps(wl: Workload, n_steps: int) -> Tuple[bool, ...]:
    """FlashCrowd window membership per host ramp step (``flash_on`` over
    step indices 0..n_steps-1, in Python)."""
    fl = wl.flash
    if fl is None:
        return tuple(False for _ in range(n_steps))
    out = []
    for t in range(n_steps):
        if t < fl.start:
            out.append(False)
        elif fl.period > 0:
            out.append((t - fl.start) % fl.period < fl.duration)
        else:
            out.append(t < fl.start + fl.duration)
    return tuple(out)


def host_rates(wl: Workload, rates: Sequence[float]) -> Tuple[float, ...]:
    """The effective offered-rate ramp: surge steps multiply the target
    rate by ``mult`` (the host half of the flash lowering; the Poisson
    arrival process itself is the generator's)."""
    fl = wl.flash
    if fl is None:
        return tuple(float(r) for r in rates)
    on = surge_steps(wl, len(rates))
    return tuple(float(r) * (fl.mult if s else 1.0)
                 for r, s in zip(rates, on))


# ---- SimConfig plumbing --------------------------------------------------

def apply_workload(cfg, wl: Optional[Workload]):
    """The SimConfig that serves ``wl``'s traffic (validated against the
    config's key space).  No-op for ``wl=None``."""
    if wl is None:
        return cfg
    return cfg.with_(workload=wl.validate(cfg.n_keys))


def class_split(state) -> Dict[str, Dict]:
    """Fold the kernels' per-class ``m_wl_hist_*``/``m_wl_sum_*`` planes (a
    group-leading final state, tensors or numpy) into per-class latency
    summaries.  Empty dict when the run was workloadless."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    out: Dict[str, Dict] = {}
    if not isinstance(state, dict):
        return out
    for nm in CLASSES:
        h = state.get(f"m_wl_hist_{nm}")
        if h is None:
            continue
        counts = lathist.plane_total(host(h))
        sums = int(host(state.get(f"m_wl_sum_{nm}", 0))
                   .astype(np.int64).sum())
        out[nm] = lathist.summarize(counts, sums)
    return out


# ---- named workloads -----------------------------------------------------
# All entries share the read mix, so the distribution is the only axis
# that moves between a row and its uniform control.
UNIFORM = Workload(name="uniform", dist="uniform", read_frac=0.5)

ZIPF99 = Workload(name="zipf99", dist="zipf", theta=0.99, read_frac=0.5)

# zipf skew + periodic surges that re-aim half the host draws at the hot
# ranks (the celebrity-event shape)
FLASH = Workload(name="flash", dist="zipf", theta=0.99, read_frac=0.5,
                 flash=FlashCrowd(start=30, period=60, duration=12,
                                  mult=4.0, focus=0.5))

# explicit hot set: the ownership-steal stress shape
HOTRANGE = Workload(name="hotrange", dist="hotset", hot_keys=8,
                    hot_weight=0.9, read_frac=0.2)

# zipf whose popular key ids rotate mid-run: the migration adversary
MIGRATE = Workload(name="migrate", dist="zipf", theta=0.99,
                   read_frac=0.5, migrate_every=40)

NAMED: Dict[str, Workload] = {w.name: w for w in (
    UNIFORM, ZIPF99, FLASH, HOTRANGE, MIGRATE)}


def named_workload(name: str) -> Workload:
    if name not in NAMED:
        raise KeyError(f"unknown workload {name!r}; "
                       f"have {sorted(NAMED)}")
    return NAMED[name]


def describe(wl: Workload, n_keys: int = 64) -> Dict:
    """One-line-able summary of a spec."""
    n_hot, n_warm = class_cuts(wl, n_keys)
    out: Dict = {"name": wl.name, "dist": wl.dist,
                 "read_frac": wl.read_frac,
                 "classes": {"hot_ranks": n_hot,
                             "warm_ranks": n_warm - n_hot,
                             "at_keys": n_keys}}
    if wl.dist == "zipf":
        out["theta"] = wl.theta
    if wl.dist == "hotset":
        out["hot_keys"] = wl.hot_keys
        out["hot_weight"] = wl.hot_weight
    if wl.flash is not None:
        out["flash"] = dataclasses.asdict(wl.flash)
    if wl.migrate_every:
        out["migrate_every"] = wl.migrate_every
    return out
