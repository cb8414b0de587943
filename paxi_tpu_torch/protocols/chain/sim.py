"""Chain replication as a lane-major sim kernel (torch twin of the JAX
package's ``protocols/chain/sim.py``).

A static chain: writes enter the head (replica 0), propagate down, the
tail (replica ``R - 1``) applies last, and reads are served at the tail.
As in the reference:

- The head is the closed-loop client: one deterministic write a step
  (``val = f(seq)``), under window flow control (``applied - committed <
  S``), so every entry in flight anywhere is ring-resident.
- The log is a ring over absolute sequence numbers (``seq % S``).
- Forwarding is an optimistic go-back-N pointer a replica with cumulative
  acks (``ack`` carries the sender's applied count and the tail-applied
  count, the commit frontier); a stalled successor rewinds the pointer,
  and a separate ``rep`` plane retransmits the oldest unacked entry.
- Commit = tail-applied, learned upstream through the acks.

The ack's validity plane is the same for every group, ``(src, dst, 1)``,
as in the reference: its fault draws are shaped so, and the runner
broadcasts it to the full edge shape for the exchange
(``sim/mailbox.full_edges``).

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, and no input plane is written in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.ops.hashing import fib_key
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.lanes import group_sum, i32sum, iota
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

I32 = torch.int32


def _seq_at(applied, S: int):
    """The absolute sequence number ring cell ``c`` holds at a replica
    with ``applied`` entries: the newest ``a < applied`` congruent to
    ``c`` (mod S); negative = never written.  ``(R, S, G)``."""
    sidx = iota(S, applied.device)
    last = applied[:, None, :] - 1
    return last - torch.remainder(last - sidx[None, :, None], S)


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    return {
        "prop": ("seq", "key", "val"),
        # go-back-N repair: the oldest entry the successor has not
        # cumulatively acked, every step, on a plane of its own
        "rep": ("seq", "key", "val"),
        "ack": ("applied", "tail_n"),
    }


def encode_val(seq):
    """Deterministic write payload (the oracle recomputes it)."""
    return seq * 11 + 5


def key_for(seq, n_keys):
    return fib_key(seq, n_keys)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    R, S, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    del rng
    device = resolve_device(device)
    i32 = dict(dtype=I32, device=device)
    return dict(
        log_key=torch.zeros((R, S, G), **i32),
        log_val=torch.zeros((R, S, G), **i32),
        applied=torch.zeros((R, G), **i32),     # in-order applied prefix
        committed=torch.zeros((R, G), **i32),   # known tail-applied
        known_succ=torch.zeros((R, G), **i32),  # optimistic succ progress
        seen_succ=torch.zeros((R, G), **i32),   # last acked succ applied
        stall=torch.zeros((R, G), **i32),
        kv=torch.zeros((R, K, G), **i32),
        reads_done=torch.zeros((R, G), **i32),
        # measurement planes (never read by protocol logic): each write's
        # head-append step at its ring cell, the append -> commit
        # histogram and the in-scan spot-check count
        m_prop_t=torch.zeros((R, S, G), **i32),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=torch.zeros((G,), **i32),
        m_inscan_viol=torch.zeros((G,), **i32),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, S, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    dev = state["applied"].device
    ridx, sidx, kidx = iota(R, dev), iota(S, dev), iota(K, dev)
    is_head = (ridx == 0)[:, None]
    is_tail = (ridx == R - 1)[:, None]

    applied = state["applied"]
    log_key, log_val = state["log_key"], state["log_val"]
    kv = state["kv"]
    G = applied.shape[-1]
    RRG = (R, R, G)

    def edge(plane, src):
        """plane[src[r], r, :] — the (src -> me) mailbox edge, unrolled
        over the small R axis."""
        acc = torch.zeros(plane.shape[1:], dtype=plane.dtype, device=dev)
        for s in range(R):
            acc = torch.where((src == s)[:, None], plane[s], acc)
        return acc

    def write_ring(plane, do, seq, value):
        """Masked write of ``value (R, G)`` at ring position seq % S."""
        oh = do[:, None, :] & (sidx[None, :, None]
                               == torch.remainder(seq, S)[:, None, :])
        return torch.where(oh, value[:, None, :], plane)

    # ------------- receive prop/repair from the predecessor --------------
    pred = torch.clamp(ridx - 1, 0, R - 1)
    for box in ("prop", "rep"):
        m = inbox[box]
        pv = edge(m["valid"], pred) & ~is_head       # only the chain edge
        pseq = edge(m["seq"], pred)
        pkey = edge(m["key"], pred)
        pval = edge(m["val"], pred)
        # next expected, in order
        take = pv & (pseq == applied)
        log_key = write_ring(log_key, take, pseq, pkey)
        log_val = write_ring(log_val, take, pseq, pval)
        ohk = take[:, None, :] & (kidx[None, :, None] == pkey[:, None, :])
        kv = torch.where(ohk, pval[:, None, :], kv)
        applied = applied + take

    # ------------- the head appends one write a step (flow control) ------
    h_seq = applied * is_head
    h_do = is_head & (applied - state["committed"] < S)
    h_key, h_val = key_for(h_seq, K), encode_val(h_seq)
    log_key = write_ring(log_key, h_do, h_seq, h_key)
    log_val = write_ring(log_val, h_do, h_seq, h_val)
    ohk = h_do[:, None, :] & (kidx[None, :, None] == h_key[:, None, :])
    kv = torch.where(ohk, h_val[:, None, :], kv)
    applied = applied + h_do
    # latency clock: the append step at the write's ring cell
    m_prop_t = write_ring(state["m_prop_t"], h_do, h_seq,
                          torch.full_like(h_seq, ctx.t))

    # ------------- receive the cumulative ack from the successor ---------
    m = inbox["ack"]
    succ = torch.clamp(ridx + 1, 0, R - 1)
    av = edge(m["valid"], succ) & ~is_tail
    a_applied = torch.where(av, edge(m["applied"], succ), -1)
    a_tail = torch.where(av, edge(m["tail_n"], succ), 0)
    progress = a_applied > state["seen_succ"]
    seen_succ = torch.maximum(state["seen_succ"], a_applied)
    committed = torch.maximum(state["committed"], a_tail)
    committed = torch.where(is_tail, applied, committed)

    # commit latency at the head: the frontier advance [old, new) bins
    # each covered write's append -> commit delta
    seq_h = _seq_at(applied, S)
    newly = (is_head[:, None, :]
             & (seq_h >= state["committed"][:, None, :])
             & (seq_h < committed[:, None, :]) & (seq_h >= 0))
    lat_dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_lat_hist = lathist.hist_update(state["m_lat_hist"], lat_dt, newly)
    m_lat_sum = state["m_lat_sum"] + i32sum(
        torch.where(newly, lat_dt, 0), (0, 1))

    # go-back-N: a stalled successor rewinds the optimistic pointer
    stall = torch.where(progress | ~av, 0, state["stall"] + av)
    rewind = stall >= cfg.retry_timeout
    known_succ = torch.where(rewind, seen_succ, state["known_succ"])
    stall = torch.where(rewind, 0, stall)

    # ------------- forward the next entry to the successor ---------------
    send = (~is_tail) & (applied > known_succ)
    s_seq = known_succ                                # absolute
    oh_s = sidx[None, :, None] == torch.remainder(s_seq, S)[:, None, :]
    s_key = i32sum(torch.where(oh_s, log_key, 0), 1)
    s_val = i32sum(torch.where(oh_s, log_val, 0), 1)
    to_succ = (ridx[None, :] == succ[:, None])[:, :, None]
    out_prop = {
        "valid": send[:, None, :] & to_succ,
        "seq": s_seq[:, None, :].expand(RRG),
        "key": s_key[:, None, :].expand(RRG),
        "val": s_val[:, None, :].expand(RRG),
    }
    known_succ = known_succ + send

    # ------------- repair: retransmit the oldest unacked entry -----------
    r_send = (~is_tail) & (applied > seen_succ)
    r_seq = seen_succ
    oh_r2 = sidx[None, :, None] == torch.remainder(r_seq, S)[:, None, :]
    out_rep = {
        "valid": r_send[:, None, :] & to_succ,
        "seq": r_seq[:, None, :].expand(RRG),
        "key": i32sum(torch.where(oh_r2, log_key, 0), 1)[:, None, :]
        .expand(RRG),
        "val": i32sum(torch.where(oh_r2, log_val, 0), 1)[:, None, :]
        .expand(RRG),
    }

    # ------------- ack upstream every step (cumulative) ------------------
    to_pred = (ridx[None, :] == pred[:, None])[:, :, None]
    out_ack = {
        "valid": (~is_head)[:, :, None] & to_pred,   # (src, dst, 1)
        "applied": applied[:, None, :].expand(RRG),
        "tail_n": committed[:, None, :].expand(RRG),
    }

    # ------------- reads are served at the tail --------------------------
    # a read looks up the latest applied write's key; counted once the
    # register holds data
    r_key = key_for(torch.clamp(applied - 1, min=0), K)
    oh_r = kidx[None, :, None] == r_key[:, None, :]
    r_val = i32sum(torch.where(oh_r, kv, 0), 1)
    served = is_tail & (applied > 0) & (r_val != 0)
    reads_done = state["reads_done"] + served

    # in-scan spot-check: applied is the execute frontier, the commit
    # frontier the base analog, log_val the committed-value plane
    old_seq, new_seq = _seq_at(state["applied"], S), _seq_at(applied, S)
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["applied"], applied, state["committed"], committed,
        old_seq, new_seq, state["log_val"], log_val,
        (old_seq >= 0) & (old_seq < state["committed"][:, None, :]),
        (new_seq >= 0) & (new_seq < committed[:, None, :]), kv=kv)

    new_state = dict(
        log_key=log_key, log_val=log_val, applied=applied,
        committed=committed, known_succ=known_succ, seen_succ=seen_succ,
        stall=stall, kv=kv, reads_done=reads_done,
        m_prop_t=m_prop_t, m_lat_hist=m_lat_hist, m_lat_sum=m_lat_sum,
        m_inscan_viol=m_inscan_viol,
    )
    return new_state, {"prop": out_prop, "rep": out_rep, "ack": out_ack}


def metrics(state, cfg: SimConfig):
    return {
        "committed_slots": i32sum(state["committed"][0]),  # head frontier
        "tail_applied": i32sum(state["applied"][cfg.n_replicas - 1]),
        "reads_done": i32sum(state["reads_done"]),
        "commit_lat_sum": i32sum(state["m_lat_sum"]),
        "commit_lat_n": i32sum(state["m_lat_hist"]),
        "inscan_violations": i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Every ring-resident applied entry matches the head's
    deterministic write; 2. applied and committed monotone; 3. applied
    nonincreasing down the chain; 4. no commit beyond the tail's applied
    prefix.  Each group's violations, ``(G,)`` int32."""
    ap = new["applied"]                               # (R, G)
    seq_at = _seq_at(ap, cfg.n_slots)
    live = seq_at >= 0
    v_det = group_sum(live & (new["log_val"] != encode_val(seq_at)))
    v_det = v_det + group_sum(
        live & (new["log_key"] != key_for(seq_at, cfg.n_keys)))
    v_mono = group_sum(ap < old["applied"])
    v_mono = v_mono + group_sum(new["committed"] < old["committed"])
    v_chain = group_sum(ap[:-1] < ap[1:])
    v_commit = group_sum(new["committed"]
                         > ap[cfg.n_replicas - 1][None])
    return v_det + v_mono + v_chain + v_commit


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=I32)


PROTOCOL = SimProtocol(
    name="chain",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
