"""ABD (Attiya-Bar-Noy-Dolev) atomic register as a lane-major sim kernel
(torch twin of the JAX package's ``protocols/abd/sim.py``).

A crash-only linearizable multi-writer register without consensus: a read
queries a majority, takes the max-timestamp value and writes it back to a
majority; a write queries a majority for the current timestamp and writes
``ts + 1`` (writer id as tiebreak).  As in the reference:

- Every replica is a closed-loop client alternating writes and reads on
  hashed keys; each op is a masked state machine (``phase`` 0 idle,
  1 query, 2 store) with a bit-packed int32 ack mask.
- ``ts = round * stride + writer``; values are a deterministic function of
  ``ts``, so a corrupt register is checkable every step.
- The atomicity oracle is built in: each key's max completed-op timestamp
  is tracked, an op snapshots it at start, and completing with a smaller
  timestamp is a violation.

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim.ballot_ring import popcount
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.ring import dst_major, require_packable
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

IDLE, QUERY, STORE = 0, 1, 2
I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        "query": ("key", "tag"),
        "query_r": ("tag", "ts", "val"),
        "store": ("key", "tag", "ts", "val"),
        "store_r": ("tag",),
    }


def encode_val(ts):
    """Deterministic register payload for a write with timestamp ts."""
    return ts * 7 + 13


def op_key_for(ridx, seq, n_keys):
    """Each op's key: a hash of (replica, seq)."""
    return fib_key(seq * 31 + ridx, n_keys)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, K, G = cfg.n_replicas, cfg.n_keys, n_groups
    del rng
    require_packable(R)
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    return dict(
        store_ts=torch.zeros((R, K, G), **i32),
        store_val=torch.zeros((R, K, G), **i32),
        phase=torch.zeros((R, G), **i32),
        op_read=torch.zeros((R, G), dtype=torch.bool, device=device),
        op_key=torch.zeros((R, G), **i32),
        op_tag=torch.zeros((R, G), **i32),
        op_ts=torch.zeros((R, G), **i32),
        op_val=torch.zeros((R, G), **i32),
        op_snap=torch.zeros((R, G), **i32),    # oracle snapshot at op start
        op_age=torch.zeros((R, G), **i32),     # steps in the current phase
        acks=torch.zeros((R, G), **i32),       # bit-packed ack mask
        best_ts=torch.zeros((R, G), **i32),
        best_val=torch.zeros((R, G), **i32),
        seq=torch.zeros((R, G), **i32),        # per-replica op counter
        reads_done=torch.zeros((R, G), **i32),
        writes_done=torch.zeros((R, G), **i32),
        done_max_ts=torch.zeros((K, G), **i32),  # oracle: max completed ts
        atomic_viol=torch.zeros((G,), **i32),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, K = cfg.n_replicas, cfg.n_keys
    MAJ, STRIDE = cfg.majority, cfg.ballot_stride
    dev = state["phase"].device
    ridx, kidx = iota(R, dev), iota(K, dev)
    bits = torch.ones_like(ridx) << ridx
    self_bit = bits[:, None]                          # (R, 1) for (R, G)
    src_bit = bits[:, None, None]                     # (src, 1, 1)

    T = dst_major          # mailbox (src, dst, G) -> (me=dst, src, G)

    def key_read(plane, key):
        """out[r, g] = plane[r, key[r, g], g] as a one-hot masked sum."""
        oh = kidx[None, :, None] == key[:, None, :]   # (R, K, G)
        return i32sum(torch.where(oh, plane, 0), 1)

    store_ts, store_val = state["store_ts"], state["store_val"]
    phase = state["phase"]
    acks = state["acks"]
    best_ts, best_val = state["best_ts"], state["best_val"]
    G = phase.shape[-1]
    RRG = (R, R, G)

    # ------------- serve "query": reply with local (ts, val) -------------
    m = inbox["query"]
    qv = T(m["valid"])                      # (me, src, G)
    qkey = torch.clamp(T(m["key"]), 0, K - 1)
    qoh = kidx[None, None, :, None] == qkey[:, :, None, :]   # (me,src,K,G)
    out_query_r = {
        "valid": qv,
        "tag": T(m["tag"]),
        "ts": i32sum(torch.where(qoh, store_ts[:, None], 0), 2),
        "val": i32sum(torch.where(qoh, store_val[:, None], 0), 2),
    }

    # ------------- serve "store": apply the max-ts write a key, ack ------
    m = inbox["store"]
    sv = T(m["valid"])                      # (me, src, G)
    skey, sts, sval = T(m["key"]), T(m["ts"]), T(m["val"])
    hit = sv[:, :, None] & (kidx[None, None, :, None]
                            == skey[:, :, None, :])          # (me,src,K,G)
    sts_h = torch.where(hit, sts[:, :, None, :], -1)
    cand_ts = torch.amax(sts_h, dim=1)                       # (me, K, G)
    # the max-ts sender's value, unrolled over the small src axis
    cand_val = torch.zeros_like(cand_ts)
    for s in range(R):
        cand_val = torch.where(sts_h[:, s] == cand_ts,
                               sval[:, s, None, :], cand_val)
    newer = cand_ts > store_ts
    store_ts = torch.where(newer, cand_ts, store_ts)
    store_val = torch.where(newer, cand_val, store_val)
    out_store_r = {"valid": sv, "tag": T(m["tag"])}

    # ------------- collect replies for my in-flight op -------------------
    m = inbox["query_r"]
    ok = (T(m["valid"]) & (T(m["tag"]) == state["op_tag"][:, None, :])
          & (phase == QUERY)[:, None, :])                    # (me, src, G)
    r_ts = torch.where(ok, T(m["ts"]), -1)
    in_best = torch.amax(r_ts, dim=1)                        # (me, G)
    in_val = torch.zeros_like(in_best)
    rv = T(m["val"])
    for s in range(R):
        in_val = torch.where((r_ts[:, s] == in_best) & (in_best >= 0),
                             rv[:, s], in_val)
    better = in_best > best_ts
    best_val = torch.where(better, in_val, best_val)
    best_ts = torch.maximum(best_ts, in_best)
    acks = acks | i32sum(torch.where(ok.transpose(0, 1), src_bit, 0), 0)

    m = inbox["store_r"]
    ok2 = (T(m["valid"]) & (T(m["tag"]) == state["op_tag"][:, None, :])
           & (phase == STORE)[:, None, :])
    acks = acks | i32sum(torch.where(ok2.transpose(0, 1), src_bit, 0), 0)

    n_acks = popcount(acks, R)

    # ------------- phase 1 -> 2: choose (ts, val), broadcast store -------
    q_done = (phase == QUERY) & (n_acks >= MAJ)
    w_ts = (torch.div(best_ts, STRIDE, rounding_mode="floor") + 1) \
        * STRIDE + ridx[:, None]                             # write: bump
    op_ts = torch.where(q_done,
                        torch.where(state["op_read"], best_ts, w_ts),
                        state["op_ts"])
    op_val = torch.where(q_done,
                         torch.where(state["op_read"], best_val,
                                     encode_val(w_ts)),
                         state["op_val"])
    # the write-back / write applies to my own store at once (self-ack)
    oh = q_done[:, None, :] & (kidx[None, :, None]
                               == state["op_key"][:, None, :])
    upd = oh & (op_ts[:, None, :] > store_ts)
    store_ts = torch.where(upd, op_ts[:, None, :], store_ts)
    store_val = torch.where(upd, op_val[:, None, :], store_val)
    phase = torch.where(q_done, STORE, phase)
    acks = torch.where(q_done, self_bit, acks)
    n_acks = popcount(acks, R)

    # ------------- phase 2 done: the op completes, oracle check ----------
    s_done = (phase == STORE) & (n_acks >= MAJ) & ~q_done
    # atomicity: a completing op must not carry a ts older than any op
    # that completed before it started
    viol = i32sum(s_done & (op_ts < state["op_snap"]), 0)   # (G,)
    atomic_viol = state["atomic_viol"] + viol
    reads_done = state["reads_done"] + (s_done & state["op_read"])
    writes_done = state["writes_done"] + (s_done & ~state["op_read"])
    dhit = s_done[:, None, :] & (kidx[None, :, None]
                                 == state["op_key"][:, None, :])
    done_max_ts = torch.maximum(
        state["done_max_ts"],
        torch.amax(torch.where(dhit, op_ts[:, None, :], -1), dim=0))
    phase = torch.where(s_done, IDLE, phase)

    # ------------- idle: start the next op (alternate write/read) --------
    start = phase == IDLE
    seq = state["seq"] + start
    new_read = torch.remainder(seq, 2) == 0
    new_key = op_key_for(ridx[:, None], seq, K)
    new_tag = seq * R + ridx[:, None]  # unique a op
    op_read = torch.where(start, new_read, state["op_read"])
    op_keyv = torch.where(start, new_key, state["op_key"])
    op_tag = torch.where(start, new_tag, state["op_tag"])
    snap_at_key = i32sum(
        torch.where(kidx[None, :, None] == new_key[:, None, :],
                    state["done_max_ts"][None], 0), 1)       # (R, G)
    op_snap = torch.where(start, snap_at_key, state["op_snap"])
    # my own contribution to the query round
    self_ts = key_read(store_ts, op_keyv)
    self_val = key_read(store_val, op_keyv)
    best_ts = torch.where(start, self_ts, best_ts)
    best_val = torch.where(start, self_val, best_val)
    acks = torch.where(start, self_bit, acks)
    phase = torch.where(start, QUERY, phase)
    op_ts = torch.where(start, 0, op_ts)
    op_val = torch.where(start, 0, op_val)

    # ------------- emit my round's broadcast (with fuzz retry) -----------
    op_age = torch.where(start | q_done | s_done, 0, state["op_age"] + 1)
    resend = op_age >= cfg.retry_timeout
    op_age = torch.where(resend, 0, op_age)
    send_q = (phase == QUERY) & (start | resend)
    send_s = (phase == STORE) & (q_done | resend)
    out_query = {
        "valid": send_q[:, None, :].expand(RRG),
        "key": op_keyv[:, None, :].expand(RRG),
        "tag": op_tag[:, None, :].expand(RRG),
    }
    out_store = {
        "valid": send_s[:, None, :].expand(RRG),
        "key": op_keyv[:, None, :].expand(RRG),
        "tag": op_tag[:, None, :].expand(RRG),
        "ts": op_ts[:, None, :].expand(RRG),
        "val": op_val[:, None, :].expand(RRG),
    }

    new_state = dict(
        store_ts=store_ts, store_val=store_val, phase=phase,
        op_read=op_read, op_key=op_keyv, op_tag=op_tag, op_ts=op_ts,
        op_val=op_val, op_snap=op_snap, op_age=op_age, acks=acks,
        best_ts=best_ts, best_val=best_val, seq=seq,
        reads_done=reads_done, writes_done=writes_done,
        done_max_ts=done_max_ts, atomic_viol=atomic_viol,
    )
    outbox = {"query": out_query, "query_r": out_query_r,
              "store": out_store, "store_r": out_store_r}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    done = state["reads_done"] + state["writes_done"]
    return {
        "ops_done": i32sum(done),
        "reads_done": i32sum(state["reads_done"]),
        "writes_done": i32sum(state["writes_done"]),
        # the runner's and bench rows' uniform metric name
        "committed_slots": i32sum(done),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Atomicity (the in-kernel oracle's new violations); 2. register
    timestamps never regress; 3. register (ts, val) pairs match the
    writer encoding.  Each group's violations, ``(G,)`` int32."""
    v_atomic = new["atomic_viol"] - old["atomic_viol"]
    v_mono = group_sum(new["store_ts"] < old["store_ts"])
    held = new["store_ts"] > 0
    v_consist = group_sum(held & (new["store_val"]
                                  != encode_val(new["store_ts"])))
    return v_atomic + v_mono + v_consist


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="abd",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
