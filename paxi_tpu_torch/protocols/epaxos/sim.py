"""EPaxos as a lane-major sim kernel (torch twin of the JAX package's
``protocols/epaxos/sim.py``).

Every replica owns an instance space ``(owner, instance)``.  A command
leader PreAccepts a command; acceptors merge conflict-derived attributes
(seq, deps); identical attributes from a fast quorum (ceil(3N/4)) commit
on the fast path, otherwise the leader runs Accept under a majority and
then Commit.  Execution orders the committed dependency graph by strongly
connected components with (seq, command id) as the tie-break.

Layout, as in the reference:
- State planes are ``(me, owner, I, G)``, deps ``(me, owner, I, R, G)``,
  with the group axis LAST; mailbox planes are ``(src, dst, G)``.  Quorum
  tallies are bit-packed int32 masks.
- Each ``(me, owner)`` instance window is a sliding ring over ABSOLUTE
  instance ids (``sim/ring.py``): position ``i`` holds ``base + i``, and
  the window slides past the globally executed prefix (the GC gossip),
  keeping the last ``I // 2`` for retransmits and prepares.  Deps hold
  absolute ids: below my window is satisfied, in-window is a graph edge,
  above my window blocks execution until the window catches up.
- Execution builds the window graph (``ops/exec_graph.dep_graph``), takes
  its reachability with ``ops/closure.transitive_closure`` and reads it
  back into masks (``ops/exec_graph.exec_masks``), a CUDA kernel each on
  the card; SCCs are ``reach & reach^T``, and a committed instance
  executes once every cross-SCC instance it reaches has executed.
- Recovery runs in the kernel: a per-cell promised ballot ``bal`` gates
  the owner's implicit ballot 0; each replica ages the uncommitted cells
  blocking its execution frontier and, past a staggered timeout, runs a
  Prepare round over the most-aged one, then commits or Accepts what the
  replies decide (see the reference's module docstring for the rule).

Every reduction the reference takes in int32 is taken with
``dtype=torch.int32`` here, no input plane is written in place (the
runner's oracle reads the old state after the step), and the per-key hash
chain wraps in int32 as ``jnp`` does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from paxi_tpu_torch.metrics import lathist
from paxi_tpu_torch.ops.closure import transitive_closure
from paxi_tpu_torch.ops.exec_graph import dep_graph, exec_masks
from paxi_tpu_torch.ops.hashing import fib_key, wrap_int32
from paxi_tpu_torch.sim import inscan
from paxi_tpu_torch.sim.ballot_ring import argmax_i32, popcount
from paxi_tpu_torch.sim.lanes import group_sum
from paxi_tpu_torch.sim.ring import (diag2, dst_major, require_packable,
                                     shift_deps, shift_window)
from paxi_tpu_torch.sim.types import (SimConfig, SimProtocol, StepCtx,
                                      resolve_device)

NO_CMD = -1
ST_NONE, ST_PRE, ST_ACC, ST_COMMIT = 0, 1, 2, 3
HASH_PRIME = 1000003
I32 = torch.int32


def mailbox_spec(cfg: SimConfig) -> Dict[str, Tuple[str, ...]]:
    R = cfg.n_replicas
    dep_fields = tuple(f"d{p}" for p in range(R))
    return {
        "pa": ("inst", "seq") + dep_fields,           # PreAccept
        "par": ("inst", "seq") + dep_fields,          # PreAcceptReply
        "acc": ("inst", "seq") + dep_fields,          # Accept
        "accr": ("inst",),                            # AcceptReply
        "cmt": ("inst", "seq", "cmd") + dep_fields,   # Commit
        # recovery planes carry ballots, apart from the owner-driven ones
        "prep": ("owner", "inst", "ballot"),          # Prepare
        "prepr": ("owner", "inst", "ballot", "stat", "cmdv", "seq",
                  "abal", "cseq") + dep_fields
                 + tuple(f"c{p}" for p in range(R)),  # PrepareReply
        "racc": ("owner", "inst", "ballot", "cmdv", "seq") + dep_fields,
        "raccr": ("owner", "inst", "ballot"),
        "rcmt": ("owner", "inst", "cmdv", "seq") + dep_fields,
        # GC gossip: each replica's executed frontier per owner column
        "gc": tuple(f"f{p}" for p in range(R)),
    }


def encode_cmd(owner, inst):
    """The command id, a pure function of (owner, absolute inst), so
    recovery repliers can compute conflict attrs for instances they never
    saw; 24 bits of instance space."""
    return (owner << 24) | (inst & 0xFFFFFF)


def cmd_key(cmd, n_keys: int):
    return fib_key(cmd, n_keys)


def _i32sum(x, dim=None):
    if dim is None:
        return torch.sum(x, dtype=I32)
    return torch.sum(x, dim=dim, dtype=I32)


def _deps_T(m, R: int, prefix: str = "d"):
    """Dep fields d0..dR-1 of a (src, dst, G) mailbox, stacked
    receiver-major as (me, src, R, G)."""
    return torch.stack([dst_major(m[f"{prefix}{p}"]) for p in range(R)],
                       dim=2)


def _deps_out(deps, R: int, shape):
    """(me, R, G) deps -> per-field (src=me, dst, G) planes broadcast over
    dst."""
    return {f"d{p}": deps[:, None, p].expand(shape) for p in range(R)}


def _bcast(x, shape):
    """(me, G) -> (src=me, dst, G), the same value to every dst."""
    return x[:, None, :].expand(shape)


def init_state(cfg: SimConfig, rng, n_groups: int, device=None):
    """The lane-major initial state on ``device`` (the card unless
    ``"cpu"`` is asked for); ``rng`` is unused (as in the reference)."""
    del rng
    device = resolve_device(device)
    R, I, K, G = cfg.n_replicas, cfg.n_slots, cfg.n_keys, n_groups
    require_packable(R)
    i32 = dict(dtype=I32, device=device)

    def zeros(*shape):
        return torch.zeros(shape, **i32)

    def fill(v, *shape):
        return torch.full(shape, v, **i32)

    return dict(
        # instance ring, (me, owner, I, G); deps (me, owner, I, R, G)
        # hold ABSOLUTE ids
        base=zeros(R, R, G),
        cmd=fill(NO_CMD, R, R, I, G),
        seq=zeros(R, R, I, G),
        deps=fill(-1, R, R, I, R, G),
        status=zeros(R, R, I, G),
        executed=torch.zeros((R, R, I, G), dtype=torch.bool, device=device),
        # promised ballot per cell (0 = the owner's implicit ballot) and
        # the ballot its attrs were accepted at
        bal=zeros(R, R, I, G),
        abal=zeros(R, R, I, G),
        age=zeros(R, R, I, G),           # steps a cell blocked my frontier
        # command-leader state (one in-flight instance each)
        cur=zeros(R, G),
        phase=zeros(R, G),               # 0 idle, 1 preaccept, 2 accept
        pa_acks=zeros(R, G),             # bit-packed
        ac_acks=zeros(R, G),
        agree=torch.ones((R, G), dtype=torch.bool, device=device),
        seq0=zeros(R, G),                # original proposed attrs
        deps0=fill(-1, R, R, G),
        mseq=zeros(R, G),                # merged attrs
        mdeps=fill(-1, R, R, G),
        stuck=zeros(R, G),
        # one in-flight recovery per replica over (rowner, rinst) at
        # rballot; rphase 0 idle / 1 prepare / 2 accept
        rphase=zeros(R, G),
        rowner=zeros(R, G),
        rinst=zeros(R, G),
        rballot=zeros(R, G),
        rstuck=zeros(R, G),
        racks=zeros(R, G),
        # per-replier recorded state + fresh conflict attrs
        rstat=zeros(R, R, G),
        rcmd=fill(NO_CMD, R, R, G),
        rseq2=zeros(R, R, G),
        rabal=zeros(R, R, G),
        rdeps2=fill(-1, R, R, R, G),
        rcseq=zeros(R, R, G),
        rcdeps=fill(-1, R, R, R, G),
        # decided attrs driven through the recovery Accept
        rdcmd=fill(NO_CMD, R, G),
        rdseq=zeros(R, G),
        rddeps=fill(-1, R, R, G),
        aacks=zeros(R, G),
        recovered=zeros(G),
        gfront=zeros(R, R, R, G),        # (me, peer, owner, G) frontiers
        ccount=zeros(R, G),              # commit events seen at me
        xcount=zeros(R, G),              # execution events at me
        # per-key execution oracle: count + order-sensitive hash chain
        kcount=zeros(R, K, G),
        khash=zeros(R, K, G),
        # measurement planes (never read by protocol logic)
        m_prop_t=zeros(R, R, I, G),
        m_commit_dt=zeros(R, R, I, G),
        m_lat_hist=lathist.empty_hist(G, device=device),
        m_lat_sum=zeros(G),
        m_inscan_viol=zeros(G),
    )


def step(state, inbox, ctx: StepCtx):
    cfg = ctx.cfg
    R, I, K = cfg.n_replicas, cfg.n_slots, cfg.n_keys
    MAJ, FAST = cfg.majority, cfg.fast_size
    # identical-preaccept threshold over a FAST-sized prepare quorum (the
    # reference's step() says why a majority rule is not enough)
    THRESH = max(2 * FAST - R, 1)
    NN = R * I
    dev = state["cur"].device
    ridx = torch.arange(R, dtype=I32, device=dev)
    iidx = torch.arange(I, dtype=I32, device=dev)
    bit = torch.ones_like(ridx) << ridx                  # (R,) 1 << r
    self_bit = bit[:, None]                              # (R, 1)
    eye_me = ridx[:, None, None, None] == ridx[None, :, None, None]

    cmd = state["cmd"]                # (me, owner, I, G)
    seq = state["seq"]
    deps = state["deps"]              # (me, owner, I, R, G)
    status = state["status"]
    executed = state["executed"]
    bal, abal, age = state["bal"], state["abal"], state["age"]
    cur, phase = state["cur"], state["phase"]
    pa_acks, ac_acks = state["pa_acks"], state["ac_acks"]
    agree = state["agree"]
    seq0, deps0 = state["seq0"], state["deps0"]
    mseq, mdeps = state["mseq"], state["mdeps"]
    rphase, rowner = state["rphase"], state["rowner"]
    rinst, rballot = state["rinst"], state["rballot"]
    rstuck, racks = state["rstuck"], state["racks"]
    rstat, rcmd = state["rstat"], state["rcmd"]
    rseq2, rabal = state["rseq2"], state["rabal"]
    rdeps2, rcseq, rcdeps = state["rdeps2"], state["rcseq"], state["rcdeps"]
    rdcmd, rdseq, rddeps = state["rdcmd"], state["rdseq"], state["rddeps"]
    aacks = state["aacks"]
    recovered = state["recovered"]
    gfront = state["gfront"]          # (me, peer, owner, G)
    base = state["base"]              # (me, owner, G) window bases
    ccount, xcount = state["ccount"], state["xcount"]
    kcount, khash = state["kcount"], state["khash"]
    G = cur.shape[-1]
    RRG = (R, R, G)
    status_in = status               # pre-step statuses (commit counting)

    T = dst_major                                    # (me, src, G)

    def ack_mask(ok):
        """OR of 1 << src over the ok edges of (me, src, G), int32."""
        return _i32sum(torch.where(ok, bit[None, :, None], 0), 1)

    def conflict_attrs(cmd_t, seq_t, status_t, new_cmd, excl_owner,
                       excl_inst):
        """Attrs (seq, deps) for ``new_cmd`` (lead dims (me, X, G)) from
        the given mid-step window table, excluding the instance itself.
        Returns seq (me, X, G), deps (me, X, R, G) as absolute ids."""
        k_tab = cmd_key(cmd_t, K)                        # (me, owner, I, G)
        recorded_tab = (status_t >= ST_PRE) & (cmd_t != NO_CMD)
        k_new = cmd_key(new_cmd, K)                      # (me, X, G)
        abs_i = base[:, None, :, None, :] \
            + iidx[None, None, None, :, None]            # (me,1,owner,I,G)
        is_self = ((ridx[None, None, :, None, None]
                    == excl_owner[:, :, None, None, :])
                   & (abs_i == excl_inst[:, :, None, None, :]))
        conflict = (recorded_tab[:, None] & ~is_self
                    & (k_tab[:, None] == k_new[:, :, None, None, :]))
        cseq = torch.amax(torch.where(conflict, seq_t[:, None], 0),
                          dim=(2, 3))
        cdep = torch.amax(torch.where(conflict, abs_i, -1), dim=3)
        return cseq + 1, cdep

    def cell_onehot(rel):
        """(me, src, G) ring positions -> (me, src, I, G) one-hot."""
        return iidx[None, None, :, None] == rel[:, :, None, :]

    # ---------------- PreAccept: record, merge conflict attrs, reply ----
    m = inbox["pa"]
    v = T(m["valid"])
    pa_inst = T(m["inst"])                               # absolute
    pa_seq = T(m["seq"])
    pa_deps = _deps_T(m, R)                              # (me, src, R, G)
    # owner == src: ring positions map against base[me, owner=src]
    pa_rel = pa_inst - base
    v = v & (pa_rel >= 0) & (pa_rel < I)   # out-of-window: ignore, no ack
    oh_cell = cell_onehot(pa_rel)
    # a recoverer's Prepare touched the cell (bal > 0): the owner's
    # ballot-0 PreAccepts are stale
    cell_free = _i32sum(torch.where(oh_cell, bal, 0), 2) == 0
    v = v & cell_free
    pa_cmd = encode_cmd(ridx[None, :, None], pa_inst)    # (me, src, G)
    # pass 1: record the proposals' presence, so two conflicting
    # PreAccepts landing here in one step see each other in pass 2
    wr = (v & (_i32sum(torch.where(oh_cell, status, 0), 2)
               < ST_PRE))[:, :, None, :] & oh_cell       # status-monotone
    cmd = torch.where(wr, pa_cmd[:, :, None, :], cmd)
    seq = torch.where(wr, pa_seq[:, :, None, :], seq)
    deps = torch.where(wr[:, :, :, None, :], pa_deps[:, :, None, :, :],
                       deps)
    status = torch.where(wr, ST_PRE, status)
    # pass 2: conflict attrs from the updated table, merge, re-record
    a_seq, a_dep = conflict_attrs(cmd, seq, status, pa_cmd,
                                  ridx[None, :, None].expand(pa_inst.shape),
                                  pa_inst)
    r_seq = torch.maximum(pa_seq, a_seq)                 # (me, src, G)
    r_deps = torch.maximum(pa_deps, a_dep)               # (me, src, R, G)
    seq = torch.where(wr, r_seq[:, :, None, :], seq)
    deps = torch.where(wr[:, :, :, None, :], r_deps[:, :, None, :, :], deps)
    out_par = {"valid": v, "inst": pa_inst, "seq": r_seq,
               **{f"d{p}": r_deps[:, :, p] for p in range(R)}}

    # ---------------- PreAcceptReply at the command leader --------------
    m = inbox["par"]
    v = T(m["valid"])
    rp_inst = T(m["inst"])
    rp_seq = T(m["seq"])
    rp_deps = _deps_T(m, R)
    ok = v & (rp_inst == cur[:, None, :]) & (phase == 1)[:, None, :]
    same = (rp_seq == seq0[:, None, :]) & torch.all(
        rp_deps == deps0[:, None], dim=2)
    agree = agree & torch.all(~ok | same, dim=1)
    mseq = torch.maximum(mseq, torch.amax(torch.where(ok, rp_seq, 0), dim=1))
    mdeps = torch.maximum(mdeps, torch.amax(
        torch.where(ok[:, :, None, :], rp_deps, -1), dim=1))
    pa_acks = pa_acks | ack_mask(ok)
    n_pa = popcount(pa_acks, R)
    fast_commit = (phase == 1) & agree & (n_pa >= FAST)
    go_accept = (phase == 1) & ~fast_commit & (n_pa >= MAJ) & (
        (~agree & (n_pa >= FAST))
        | (state["stuck"] >= cfg.retry_timeout))

    # ---------------- AcceptReply then Accept ---------------------------
    m = inbox["accr"]
    ok = (T(m["valid"]) & (T(m["inst"]) == cur[:, None, :])
          & (phase == 2)[:, None, :])
    ac_acks = ac_acks | ack_mask(ok)
    slow_commit = (phase == 2) & (popcount(ac_acks, R) >= MAJ)

    m = inbox["acc"]
    v = T(m["valid"])
    ac_inst = T(m["inst"])                               # absolute
    ac_seq = T(m["seq"])
    ac_deps = _deps_T(m, R)
    ac_rel = ac_inst - base
    v = v & (ac_rel >= 0) & (ac_rel < I)
    oh_cell = cell_onehot(ac_rel)
    cell_free = _i32sum(torch.where(oh_cell, bal, 0), 2) == 0
    v = v & cell_free
    ac_cmd = encode_cmd(ridx[None, :, None], ac_inst)
    wr = (v & (_i32sum(torch.where(oh_cell, status, 0), 2)
               < ST_ACC))[:, :, None, :] & oh_cell
    cmd = torch.where(wr, ac_cmd[:, :, None, :], cmd)
    seq = torch.where(wr, ac_seq[:, :, None, :], seq)
    deps = torch.where(wr[:, :, :, None, :], ac_deps[:, :, None, :, :],
                       deps)
    status = torch.where(wr & (status < ST_COMMIT),
                         torch.clamp(status, min=ST_ACC), status)
    out_accr = {"valid": v, "inst": ac_inst}

    # ---------------- Commit delivery (owner-driven) --------------------
    m = inbox["cmt"]
    v = T(m["valid"])
    cm_inst = T(m["inst"])                               # absolute
    cm_seq = T(m["seq"])
    cm_cmd = T(m["cmd"])
    cm_deps = _deps_T(m, R)
    cm_rel = cm_inst - base
    v = v & (cm_rel >= 0) & (cm_rel < I)
    oh_cell = cell_onehot(cm_rel)
    wr = (v & (_i32sum(torch.where(oh_cell, status, 0), 2)
               < ST_COMMIT))[:, :, None, :] & oh_cell
    cmd = torch.where(wr, cm_cmd[:, :, None, :], cmd)
    seq = torch.where(wr, cm_seq[:, :, None, :], seq)
    deps = torch.where(wr[:, :, :, None, :], cm_deps[:, :, None, :, :],
                       deps)
    status = torch.where(wr, ST_COMMIT, status)

    # ---------------- leader transitions --------------------------------
    dec_seq = torch.where(fast_commit, seq0, mseq)
    dec_deps = torch.where(fast_commit[:, None, :], deps0, mdeps)
    do_commit = fast_commit | slow_commit
    base_own = diag2(base)                               # (R, G)
    rel_cur = torch.clamp(cur - base_own, 0, I - 1)
    my_cmd = encode_cmd(ridx[:, None], cur)              # (R, G)
    oh_me = eye_me & (iidx[None, None, :, None] == rel_cur[:, None, None, :])
    wrm = do_commit[:, None, None, :] & oh_me
    cmd = torch.where(wrm, my_cmd[:, None, None, :], cmd)
    seq = torch.where(wrm, dec_seq[:, None, None, :], seq)
    deps = torch.where(wrm[:, :, :, None, :], dec_deps[:, None, None, :, :],
                       deps)
    status = torch.where(wrm, ST_COMMIT, status)
    out_cmt_new = {
        "valid": _bcast(do_commit, RRG),
        "inst": _bcast(cur, RRG),
        "seq": _bcast(dec_seq, RRG),
        "cmd": _bcast(my_cmd, RRG),
        **_deps_out(dec_deps, R, RRG),
    }

    # accept phase start
    wra = go_accept[:, None, None, :] & oh_me
    seq = torch.where(wra, mseq[:, None, None, :], seq)
    deps = torch.where(wra[:, :, :, None, :], mdeps[:, None, None, :, :],
                       deps)
    status = torch.where(wra & (status < ST_COMMIT),
                         torch.clamp(status, min=ST_ACC), status)
    ac_acks = torch.where(go_accept, self_bit, ac_acks)
    out_acc = {
        "valid": _bcast(go_accept, RRG),
        "inst": _bcast(cur, RRG),
        "seq": _bcast(mseq, RRG),
        **_deps_out(mdeps, R, RRG),
    }

    # my in-flight instance was finished by a recoverer: move on, in any
    # phase, or the owner's pipeline deadlocks on the recovered cell
    my_status0 = diag2(status)
    in_win_cur = cur - base_own < I
    ext_commit = ~do_commit & in_win_cur & (_i32sum(
        torch.where(iidx[None, :, None] == rel_cur[:, None, :],
                    my_status0, 0), 1) == ST_COMMIT)
    phase = torch.where(do_commit | ext_commit, 0,
                        torch.where(go_accept, 2, phase))
    cur = cur + (do_commit | ext_commit)
    stuck = torch.where(do_commit | go_accept | ext_commit, 0,
                        state["stuck"])

    # ---------------- propose the next command --------------------------
    # window flow control: my next instance must be ring-resident
    propose = (phase == 0) & (cur - base_own < I)
    p_inst = cur                                         # absolute
    p_rel = torch.clamp(cur - base_own, 0, I - 1)
    p_cmd = encode_cmd(ridx[:, None], p_inst)
    p_seq, p_deps = conflict_attrs(cmd, seq, status, p_cmd[:, None, :],
                                   ridx[:, None, None].expand(R, 1, G),
                                   p_inst[:, None, :])
    p_seq, p_deps = p_seq[:, 0], p_deps[:, 0]            # (R,G),(R,R,G)
    oh_p = eye_me & (iidx[None, None, :, None] == p_rel[:, None, None, :])
    # my own cell may be recovery-touched: I still record my proposal if
    # the cell is empty, and acceptors gate it
    wrp = (propose & (_i32sum(
        torch.where(iidx[None, :, None] == p_rel[:, None, :],
                    diag2(status), 0), 1) < ST_PRE)
    )[:, None, None, :] & oh_p
    cmd = torch.where(wrp, p_cmd[:, None, None, :], cmd)
    seq = torch.where(wrp, p_seq[:, None, None, :], seq)
    deps = torch.where(wrp[:, :, :, None, :], p_deps[:, None, None, :, :],
                       deps)
    status = torch.where(wrp, ST_PRE, status)
    seq0 = torch.where(propose, p_seq, seq0)
    deps0 = torch.where(propose[:, None, :], p_deps, deps0)
    mseq = torch.where(propose, p_seq, mseq)
    mdeps = torch.where(propose[:, None, :], p_deps, mdeps)
    agree = torch.where(propose, True, agree)
    pa_acks = torch.where(propose, self_bit, pa_acks)
    phase = torch.where(propose, 1, phase)

    # retransmit the in-flight phase message when stuck
    retry = stuck >= cfg.retry_timeout
    send_pa = propose | (retry & (phase == 1))
    send_acc = go_accept | (retry & (phase == 2))
    out_pa = {
        "valid": _bcast(send_pa, RRG),
        "inst": _bcast(p_inst, RRG),
        "seq": _bcast(seq0, RRG),
        **_deps_out(deps0, R, RRG),
    }
    out_acc["valid"] = _bcast(send_acc, RRG)
    stuck = torch.where(retry, 0, stuck + (phase > 0))

    # commit retransmit, round-robin over my in-window committed
    # instances, so followers whose cmt was dropped heal
    span = torch.clamp(cur - base_own, 1, I)             # (R, G)
    rr_rel = torch.clamp(cur - base_own - 1, 0, I - 1) \
        - torch.remainder(ctx.t, span)
    rr_rel = torch.clamp(rr_rel, 0, I - 1)
    rr = base_own + rr_rel                               # absolute
    oh_rr = iidx[None, :, None] == rr_rel[:, None, :]
    my_status = diag2(status)                            # (R, I, G)
    rr_cmd = _i32sum(torch.where(oh_rr, diag2(cmd), 0), 1)
    rr_seq = _i32sum(torch.where(oh_rr, diag2(seq), 0), 1)
    my_deps = diag2(deps)                                # (R, I, R, G)
    rr_deps = _i32sum(torch.where(oh_rr[:, :, None, :], my_deps, 0), 1)
    rr_committed = (_i32sum(torch.where(oh_rr, my_status, 0), 1)
                    == ST_COMMIT) & ~do_commit
    new_v = out_cmt_new["valid"]
    out_cmt = {
        "valid": new_v | rr_committed[:, None, :],
        "inst": torch.where(new_v, out_cmt_new["inst"], rr[:, None, :]),
        "seq": torch.where(new_v, out_cmt_new["seq"], rr_seq[:, None, :]),
        "cmd": torch.where(new_v, out_cmt_new["cmd"], rr_cmd[:, None, :]),
        **{f"d{p}": torch.where(new_v, out_cmt_new[f"d{p}"],
                                rr_deps[:, None, p])
           for p in range(R)},
    }

    # ================ RECOVERY =========================================
    # ---------------- Prepare: raise cell ballots, reply ----------------
    m = inbox["prep"]
    v = T(m["valid"])                                    # (me, src, G)
    pr_own = torch.clamp(T(m["owner"]), 0, R - 1)
    pr_inst = T(m["inst"])                               # absolute
    pr_bal = T(m["ballot"])
    pr_rel = pr_inst[:, :, None, :] - base[:, None, :, :]  # (me,src,own,G)
    # per-cell max prepare ballot this step (collision: max wins)
    oh5 = (v[:, :, None, None, :]
           & (ridx[None, None, :, None, None] == pr_own[:, :, None, None, :])
           & (iidx[None, None, None, :, None]
              == pr_rel[:, :, :, None, :]))              # (me,src,own,I,G)
    cell_max = torch.amax(torch.where(oh5, pr_bal[:, :, None, None, :], 0),
                          dim=1)                         # (me, own, I, G)
    bal = torch.maximum(bal, cell_max)
    # reply per edge: src gets my recorded state for its requested cell
    # iff its ballot won the cell; a request outside my window gets none
    prepr_fields = []
    for s in range(R):
        o_s, i_s, b_s = pr_own[:, s], pr_inst[:, s], pr_bal[:, s]
        base_sel = _i32sum(torch.where(ridx[None, :, None]
                                       == o_s[:, None, :], base, 0), 1)
        rel_s = i_s - base_sel                           # (me, G)
        ohc = ((ridx[None, :, None, None] == o_s[:, None, None, :])
               & (iidx[None, None, :, None] == rel_s[:, None, None, :]))

        def cell(pl):
            return _i32sum(torch.where(ohc, pl, 0), (1, 2))

        okr = v[:, s] & (b_s >= cell(bal)) & (rel_s >= 0) & (rel_s < I)
        st_s = cell(status)
        dp_s = _i32sum(torch.where(ohc[:, :, :, None, :], deps, 0), (1, 2))
        dp_s = torch.where(st_s[:, None, :] >= ST_PRE, dp_s, -1)
        # fresh conflict attrs for the cell's (deterministic) command
        fr_cmd = encode_cmd(o_s, i_s)                    # (me, G)
        f_seq, f_deps = conflict_attrs(cmd, seq, status,
                                       fr_cmd[:, None, :],
                                       o_s[:, None, :], i_s[:, None, :])
        prepr_fields.append(dict(
            ok=okr, owner=o_s, inst=i_s, ballot=b_s, stat=st_s,
            cmdv=cell(cmd), seq=cell(seq), abal=cell(abal), deps=dp_s,
            cseq=f_seq[:, 0], cdeps=f_deps[:, 0]))

    def stack_s(key):
        return torch.stack([f[key] for f in prepr_fields], dim=1)

    # out_prepr planes are (me, dst, G): me replies to each dst
    out_prepr = {
        "valid": stack_s("ok"),
        **{k: stack_s(k) for k in ("owner", "inst", "ballot", "stat",
                                   "cmdv", "seq", "abal", "cseq")},
        **{f"d{p}": torch.stack([f["deps"][:, p] for f in prepr_fields],
                                dim=1) for p in range(R)},
        **{f"c{p}": torch.stack([f["cdeps"][:, p] for f in prepr_fields],
                                dim=1) for p in range(R)},
    }

    # ---------------- PrepareReply tally at the recoverer ---------------
    m = inbox["prepr"]
    v = T(m["valid"])                                    # (me, src, G)
    ok = (v & (T(m["owner"]) == rowner[:, None, :])
          & (T(m["inst"]) == rinst[:, None, :])
          & (T(m["ballot"]) == rballot[:, None, :])
          & (rphase == 1)[:, None, :])
    racks = racks | ack_mask(ok)
    rstat = torch.where(ok, T(m["stat"]), rstat)
    rcmd = torch.where(ok, T(m["cmdv"]), rcmd)
    rseq2 = torch.where(ok, T(m["seq"]), rseq2)
    rabal = torch.where(ok, T(m["abal"]), rabal)
    rcseq = torch.where(ok, T(m["cseq"]), rcseq)
    rdeps2 = torch.where(ok[:, :, None, :], _deps_T(m, R), rdeps2)
    rcdeps = torch.where(ok[:, :, None, :], _deps_T(m, R, "c"), rcdeps)

    # ---------------- recovery decision ---------------------------------
    acked = ((racks[:, None, :] >> ridx[None, :, None]) & 1).to(torch.bool)
    # a committed reply is self-certifying; every other case needs the
    # full FAST-sized prepare quorum
    n_rep = popcount(racks, R)
    have_prep = (rphase == 1) & (n_rep >= FAST)          # (me, G)
    st_ok = torch.where(acked, rstat, ST_NONE)           # (me, rep, G)
    # 1. any committed reply
    is_com = st_ok == ST_COMMIT
    any_com = torch.any(is_com, dim=1)
    # 2. any accepted reply: max abal wins
    is_acc = st_ok == ST_ACC
    any_acc = torch.any(is_acc, dim=1)
    acc_bal = torch.amax(torch.where(is_acc, rabal, -1), dim=1)
    # 3. identical ballot-0 preaccepts >= THRESH
    is_pre = (st_ok == ST_PRE) & (rabal == 0)
    same_ij = ((rseq2[:, :, None, :] == rseq2[:, None, :, :])
               & torch.all(rdeps2[:, :, None] == rdeps2[:, None, :],
                           dim=3))                       # (me, i, j, G)
    ident_cnt = _i32sum(is_pre[:, :, None, :] & is_pre[:, None, :, :]
                        & same_ij, 2)                    # (me, i, G)
    ident_cnt = torch.where(is_pre, ident_cnt, 0)
    has_ident = torch.any(ident_cnt >= THRESH, dim=1)
    # 4. any preaccept at all (regardless of recorded ballot)
    any_pre = torch.any(st_ok == ST_PRE, dim=1)

    def first_pick(picks, fills):
        """First-match unrolled picks: for each plane of ``fills`` (a
        (me, rep, ...) source, its fill), the value at the lowest rep
        where ``picks[:, rep]``."""
        out = [torch.full_like(src[:, 0], fill) for src, fill in fills]
        for s in range(R - 1, -1, -1):
            p = picks[:, s]
            out = [torch.where(p.reshape(p.shape[:1] + (1,) * (o.ndim - 2)
                                         + p.shape[1:]), src[:, s], o)
                   for o, (src, _) in zip(out, fills)]
        return out

    # decided attrs per case
    d_cmd, d_seq, d_deps = first_pick(
        is_com, ((rcmd, NO_CMD), (rseq2, 0), (rdeps2, -1)))
    a_cmd_d, a_seq_d, a_deps_d = first_pick(
        is_acc & (rabal == acc_bal[:, None, :]),
        ((rcmd, NO_CMD), (rseq2, 0), (rdeps2, -1)))
    best_cnt = torch.amax(ident_cnt, dim=1)
    i_seq_d, i_deps_d = first_pick(
        is_pre & (ident_cnt == best_cnt[:, None, :])
        & (best_cnt >= THRESH)[:, None, :],
        ((rseq2, 0), (rdeps2, -1)))
    # union case: recorded attrs of preaccepts + fresh attrs of all acked
    pre_any = st_ok == ST_PRE
    u_seq = torch.maximum(
        torch.amax(torch.where(pre_any, rseq2, 0), dim=1),
        torch.amax(torch.where(acked, rcseq, 0), dim=1))
    u_deps = torch.maximum(
        torch.amax(torch.where(pre_any[:, :, None, :], rdeps2, -1), dim=1),
        torch.amax(torch.where(acked[:, :, None, :], rcdeps, -1), dim=1))
    # the recovered instance never depends on itself
    self_col = ridx[None, :, None] == rowner[:, None, :]  # (me, R, G)
    u_deps = torch.where(self_col & (u_deps == rinst[:, None, :]), -1,
                         u_deps)

    r_cmdv = encode_cmd(torch.clamp(rowner, 0, R - 1),
                        torch.clamp(rinst, min=0))
    dec_commit = (rphase == 1) & any_com
    dec_accept = have_prep & ~any_com & (any_acc | has_ident | any_pre)
    f_seq_d = torch.where(any_acc, a_seq_d,
                          torch.where(has_ident, i_seq_d, u_seq))
    f_deps_d = torch.where(any_acc[:, None, :], a_deps_d,
                           torch.where(has_ident[:, None, :], i_deps_d,
                                       u_deps))
    # accepted values may be NOOPs of an earlier recovery; preaccepted
    # values are always the owner's real command
    f_cmd_d = torch.where(any_acc, a_cmd_d, r_cmdv)
    dec_noop = have_prep & ~any_com & ~any_acc & ~has_ident & ~any_pre

    # commit-now path (case 1 and the NOOP case): apply + broadcast rcmt
    do_rcmt = dec_commit | dec_noop
    cm_cmd2 = torch.where(dec_commit, d_cmd, NO_CMD)
    cm_seq2 = torch.where(dec_commit, d_seq, 0)
    cm_deps2 = torch.where(dec_commit[:, None, :], d_deps, -1)
    # accept path: record decided attrs, broadcast racc at rballot
    rdcmd = torch.where(dec_accept, f_cmd_d, rdcmd)
    rdseq = torch.where(dec_accept, f_seq_d, rdseq)
    rddeps = torch.where(dec_accept[:, None, :], f_deps_d, rddeps)
    rphase = torch.where(do_rcmt, 0, torch.where(dec_accept, 2, rphase))
    aacks = torch.where(dec_accept, self_bit, aacks)
    rstuck = torch.where(do_rcmt | dec_accept, 0, rstuck)

    def winners(hits, cmdv_m, seq_m, deps_m):
        """Per cell, the fields of the lowest-src hit: ``hits`` (me, src,
        own, I, G); message planes (me, src, G) / deps (me, src, R, G)."""
        wf = torch.zeros((R, R, I, G), dtype=I32, device=dev)
        ws = torch.zeros((R, R, I, G), dtype=I32, device=dev)
        wd = torch.full((R, R, I, R, G), -1, dtype=I32, device=dev)
        for s in range(R - 1, -1, -1):
            hit = hits[:, s]
            wf = torch.where(hit, cmdv_m[:, s, None, None, :], wf)
            ws = torch.where(hit, seq_m[:, s, None, None, :], ws)
            wd = torch.where(hit[:, :, :, None, :],
                             deps_m[:, s, None, None, :, :], wd)
        return wf, ws, wd

    # ---------------- recovery Accept handling (racc) -------------------
    m = inbox["racc"]
    v = T(m["valid"])
    ra_own = torch.clamp(T(m["owner"]), 0, R - 1)
    ra_inst = T(m["inst"])                               # absolute
    ra_bal = T(m["ballot"])
    ra_rel = ra_inst[:, :, None, :] - base[:, None, :, :]  # (me,src,own,G)
    oh5 = (v[:, :, None, None, :]
           & (ridx[None, None, :, None, None] == ra_own[:, :, None, None, :])
           & (iidx[None, None, None, :, None]
              == ra_rel[:, :, :, None, :]))
    bal_b = ra_bal[:, :, None, None, :].expand(oh5.shape)
    gate = oh5 & (bal_b >= bal[:, None]) & (status[:, None] < ST_COMMIT)
    # per-cell winner: max ballot among gating raccs this step
    win_bal = torch.amax(torch.where(gate, bal_b, -1), dim=1)  # (me,own,I,G)
    any_win = win_bal >= 0
    won = gate & (bal_b == win_bal[:, None])             # (me,src,own,I,G)
    wf, ws, wd = winners(won, T(m["cmdv"]), T(m["seq"]), _deps_T(m, R))
    cmd = torch.where(any_win, wf, cmd)
    seq = torch.where(any_win, ws, seq)
    deps = torch.where(any_win[:, :, :, None, :], wd, deps)
    status = torch.where(any_win, torch.clamp(status, min=ST_ACC), status)
    abal = torch.where(any_win, win_bal, abal)
    bal = torch.where(any_win, win_bal, bal)
    # raccr to each src whose ballot won its cell
    out_raccr = {
        "valid": torch.any(won, dim=(2, 3)),
        "owner": T(m["owner"]),
        "inst": T(m["inst"]),
        "ballot": T(m["ballot"]),
    }

    # ---------------- raccr tally -> rcmt --------------------------------
    m = inbox["raccr"]
    ok = (T(m["valid"]) & (T(m["owner"]) == rowner[:, None, :])
          & (T(m["inst"]) == rinst[:, None, :])
          & (T(m["ballot"]) == rballot[:, None, :])
          & (rphase == 2)[:, None, :])
    aacks = aacks | ack_mask(ok)
    acc_done = (rphase == 2) & (popcount(aacks, R) >= MAJ)
    do_rcmt2 = do_rcmt | acc_done
    cm_cmd2 = torch.where(acc_done, rdcmd, cm_cmd2)
    cm_seq2 = torch.where(acc_done, rdseq, cm_seq2)
    cm_deps2 = torch.where(acc_done[:, None, :], rddeps, cm_deps2)
    rphase = torch.where(acc_done, 0, rphase)
    recovered = recovered + _i32sum(do_rcmt2, 0)
    out_rcmt = {
        "valid": _bcast(do_rcmt2, RRG),
        "owner": _bcast(rowner, RRG),
        "inst": _bcast(rinst, RRG),
        "cmdv": _bcast(cm_cmd2, RRG),
        "seq": _bcast(cm_seq2, RRG),
        **_deps_out(cm_deps2, R, RRG),
    }
    # apply my own recovery commit locally (ring position vs my base)
    rown_c = torch.clamp(rowner, 0, R - 1)
    rc_base = _i32sum(torch.where(ridx[None, :, None] == rown_c[:, None, :],
                                  base, 0), 1)           # (me, G)
    oh_rc = ((ridx[None, :, None, None] == rown_c[:, None, None, :])
             & (iidx[None, None, :, None]
                == (rinst - rc_base)[:, None, None, :]))
    wr = do_rcmt2[:, None, None, :] & oh_rc & (status < ST_COMMIT)
    cmd = torch.where(wr, cm_cmd2[:, None, None, :], cmd)
    seq = torch.where(wr, cm_seq2[:, None, None, :], seq)
    deps = torch.where(wr[:, :, :, None, :], cm_deps2[:, None, None, :, :],
                       deps)
    status = torch.where(wr, ST_COMMIT, status)

    # ---------------- rcmt delivery --------------------------------------
    m = inbox["rcmt"]
    v = T(m["valid"])
    rc_own = torch.clamp(T(m["owner"]), 0, R - 1)
    rc_rel = T(m["inst"])[:, :, None, :] - base[:, None, :, :]
    oh5 = (v[:, :, None, None, :]
           & (ridx[None, None, :, None, None] == rc_own[:, :, None, None, :])
           & (iidx[None, None, None, :, None]
              == rc_rel[:, :, :, None, :]))
    hit_any = torch.any(oh5, dim=1)                      # (me, own, I, G)
    wf, ws, wd = winners(oh5, T(m["cmdv"]), T(m["seq"]), _deps_T(m, R))
    wr = hit_any & (status < ST_COMMIT)
    cmd = torch.where(wr, wf, cmd)
    seq = torch.where(wr, ws, seq)
    deps = torch.where(wr[:, :, :, None, :], wd, deps)
    status = torch.where(wr, ST_COMMIT, status)

    # ---------------- execution: closure -> SCC -> ordered apply --------
    # the kernels below take contiguous planes (a no-op on the main path)
    committed = (status == ST_COMMIT).reshape(R, NN, G).contiguous()
    seq_f = seq.reshape(R, NN, G)
    cmd_f = cmd.reshape(R, NN, G)
    exec_f = executed.reshape(R, NN, G).contiguous()
    # the window graphs, closed, read back into masks: one kernel a pass on
    # the card (ops/exec_graph.py), each cube written and read once
    A, fblock = dep_graph(deps.reshape(R, NN, R, G).contiguous(),
                          base.contiguous(), committed)
    reach = transitive_closure(A)                        # (R*G, NN, NN)
    del A                       # each cube is 3.2 GB at 100k groups
    # needed (the recovery trigger below) from exec_f: exec_masks_plain
    # says why that equals the executions of this step's window
    exec_ok, needed = exec_masks(reach, committed, fblock, exec_f)
    del reach
    # above every encodable cmd id (owner <= 30, so cmd < 2^29)
    BIG = 1 << 29
    new_exec = exec_f
    kidx = torch.arange(K, dtype=I32, device=dev)
    for _ in range(cfg.exec_window):
        cand = exec_ok & ~new_exec
        any_c = torch.any(cand, dim=1)                   # (R, G)
        # replica-independent total order: (seq, cmd id) lexicographic
        mseq_e = torch.amin(torch.where(cand, seq_f, BIG), dim=1)
        cand2 = cand & (seq_f == mseq_e[:, None, :])
        mcmd_e = torch.amin(torch.where(cand2, cmd_f, BIG), dim=1)
        oh_pick = cand2 & (cmd_f == mcmd_e[:, None, :])
        c_e = mcmd_e
        k_e = cmd_key(c_e, K)
        upd = any_c & (c_e != NO_CMD)
        ohk = upd[:, None, :] & (kidx[None, :, None] == k_e[:, None, :])
        # the hash chain wraps in int32, formed in int64 and wrapped
        chained = wrap_int32(khash.to(torch.int64) * HASH_PRIME
                             + c_e[:, None, :].to(torch.int64)).to(I32)
        khash = torch.where(ohk, chained, khash)
        kcount = kcount + ohk
        new_exec = new_exec | oh_pick
    executed = new_exec.reshape(R, R, I, G)

    # ---------------- recovery trigger: age blocking cells ---------------
    # a cell is "needed" when committed-unexecuted work reaches it and it
    # is not committed: exactly the frontier blockers
    needed = needed.reshape(R, R, I, G)
    age = torch.where(needed, age + 1, 0)
    # staggered per-replica patience breaks recoverer duels
    patience = cfg.election_timeout + ridx[:, None] * cfg.backoff
    age_f = age.reshape(R, NN, G)
    worst = torch.amax(age_f, dim=1)                     # (R, G)
    fire = (rphase == 0) & (worst > patience)
    pick = argmax_i32(age_f, 1)                          # (R, G)
    f_own = pick // I
    f_pos = pick % I                                     # ring position
    f_base = _i32sum(torch.where(ridx[None, :, None] == f_own[:, None, :],
                                 base, 0), 1)
    f_inst = f_base + f_pos                              # absolute
    # ballot: above anything I have seen for the cell, tagged with my id
    oh_f = ((ridx[None, :, None, None] == f_own[:, None, None, :])
            & (iidx[None, None, :, None] == f_pos[:, None, None, :]))
    cell_bal = torch.amax(torch.where(oh_f, bal, 0), dim=(1, 2))
    new_rbal = (torch.maximum(cell_bal, rballot) // cfg.ballot_stride + 1) \
        * cfg.ballot_stride + ridx[:, None]
    rowner = torch.where(fire, f_own, rowner)
    rinst = torch.where(fire, f_inst, rinst)
    rballot = torch.where(fire, new_rbal, rballot)
    rphase = torch.where(fire, 1, rphase)
    racks = torch.where(fire, self_bit, racks)
    rstuck = torch.where(fire, 0, rstuck)
    # my own promise + self-reply into the tally
    bal = torch.where(fire[:, None, None, :] & oh_f,
                      torch.maximum(bal, new_rbal[:, None, None, :]), bal)

    def f_cell(pl):
        return _i32sum(torch.where(oh_f, pl, 0), (1, 2))

    self_stat = f_cell(status)
    self_deps = _i32sum(torch.where(oh_f[:, :, :, None, :], deps, 0),
                        (1, 2))
    self_deps = torch.where(self_stat[:, None, :] >= ST_PRE, self_deps, -1)
    sf_cmd = encode_cmd(f_own, f_inst)
    sf_seq, sf_deps = conflict_attrs(cmd, seq, status, sf_cmd[:, None, :],
                                     f_own[:, None, :], f_inst[:, None, :])
    eye = ridx[:, None, None] == ridx[None, :, None]     # (me, rep, 1)
    fe = fire[:, None, :] & eye
    rstat = torch.where(fe, self_stat[:, None, :], rstat)
    rcmd = torch.where(fe, f_cell(cmd)[:, None, :], rcmd)
    rseq2 = torch.where(fe, f_cell(seq)[:, None, :], rseq2)
    rabal = torch.where(fe, f_cell(abal)[:, None, :], rabal)
    rcseq = torch.where(fe, sf_seq[:, 0][:, None, :], rcseq)
    rdeps2 = torch.where(fe[:, :, None, :], self_deps[:, None, :, :],
                         rdeps2)
    rcdeps = torch.where(fe[:, :, None, :], sf_deps[:, 0][:, None, :, :],
                         rcdeps)

    # recovery retransmit on the retry cadence (rstuck stays monotone for
    # the give-up horizon)
    rstuck = torch.where(rphase > 0, rstuck + 1, 0)
    r_retry = (rphase > 0) & (rstuck > 0) \
        & (torch.remainder(rstuck, cfg.retry_timeout) == 0)
    give_up = rstuck >= 3 * cfg.retry_timeout
    rphase = torch.where(give_up, 0, rphase)
    out_prep = {
        "valid": _bcast(fire | (r_retry & (rphase == 1)), RRG),
        "owner": _bcast(rowner, RRG),
        "inst": _bcast(rinst, RRG),
        "ballot": _bcast(rballot, RRG),
    }
    out_racc = {
        "valid": _bcast(dec_accept | (r_retry & (rphase == 2)), RRG),
        "owner": _bcast(rowner, RRG),
        "inst": _bcast(rinst, RRG),
        "ballot": _bcast(rballot, RRG),
        "cmdv": _bcast(rdcmd, RRG),
        "seq": _bcast(rdseq, RRG),
        **_deps_out(rddeps, R, RRG),
    }

    # ---------------- cumulative counters (pre-slide layouts align) -----
    newly_c = (status == ST_COMMIT) & (status_in < ST_COMMIT)
    ccount = ccount + _i32sum(newly_c, (1, 2))
    xcount = xcount + _i32sum(new_exec & ~exec_f, 1)

    # commit latency: a cell's clock starts at its first record here; a
    # newly committed cell stores its record->commit delta for the
    # runner's deferred flush
    m_prop_t = state["m_prop_t"]
    m_prop_t = torch.where((status >= ST_PRE) & (status_in == ST_NONE)
                           & (m_prop_t == 0), ctx.t, m_prop_t)
    dt = torch.clamp(ctx.t - m_prop_t, min=0)
    m_commit_dt = torch.where(newly_c, dt, state["m_commit_dt"])
    m_lat_sum = state["m_lat_sum"] + _i32sum(torch.where(newly_c, dt, 0),
                                             (0, 1, 2))

    # ---------------- GC gossip + slide the instance rings --------------
    # my contiguous executed frontier per owner column (absolute)
    lead_exec = _i32sum(torch.cumprod(executed.to(I32), dim=2, dtype=I32),
                        2)                               # (me, owner, G)
    my_front = base + lead_exec
    m = inbox["gc"]
    got_gc = T(m["valid"])
    cols = []
    for s in range(R):
        fr_s = torch.stack([T(m[f"f{p}"])[:, s] for p in range(R)],
                           dim=1)                        # (me, owner, G)
        cols.append(torch.where(got_gc[:, s][:, None, :],
                                torch.maximum(gfront[:, s], fr_s),
                                gfront[:, s]))
    gfront = torch.stack(cols, dim=1)
    gfront = torch.where(eye_me, my_front[:, None], gfront)
    out_gc = {
        "valid": torch.ones(RRG, dtype=torch.bool, device=dev),
        **{f"f{p}": _bcast(my_front[:, p], RRG) for p in range(R)},
    }
    # recycle only past the GLOBAL minimum executed frontier (a cell a
    # replica recycles must be executed everywhere); RETAIN keeps recent
    # cells answerable for prepares and retransmits
    RETAIN = max(I // 2, 1)
    gmin = torch.amin(gfront, dim=1)                     # (me, owner, G)
    adv = torch.clamp(gmin - RETAIN - base, min=0)
    base = base + adv
    cmd = shift_window(cmd, adv, NO_CMD)
    seq = shift_window(seq, adv, 0)
    status = shift_window(status, adv, ST_NONE)
    executed = shift_window(executed, adv, False)
    bal = shift_window(bal, adv, 0)
    abal = shift_window(abal, adv, 0)
    age = shift_window(age, adv, 0)
    deps = shift_deps(deps, adv)
    m_prop_t = shift_window(m_prop_t, adv, 0)

    # in-scan spot-check: frontier plane = the per-key execution counts,
    # register plane = the per-key hash chains
    abs_in = state["base"][:, :, None, :] + iidx[None, None, :, None]
    abs_out = base[:, :, None, :] + iidx[None, None, :, None]
    m_inscan_viol = state["m_inscan_viol"] + inscan.spot_check(
        state["kcount"], kcount, state["base"], base,
        abs_in, abs_out, state["cmd"], cmd,
        state["status"] == ST_COMMIT, status == ST_COMMIT, kv=khash)

    new_state = dict(
        base=base, cmd=cmd, seq=seq, deps=deps, status=status,
        executed=executed, bal=bal, abal=abal, age=age, cur=cur,
        phase=phase, pa_acks=pa_acks, ac_acks=ac_acks, agree=agree,
        seq0=seq0, deps0=deps0, mseq=mseq, mdeps=mdeps, stuck=stuck,
        rphase=rphase, rowner=rowner, rinst=rinst, rballot=rballot,
        rstuck=rstuck, racks=racks, rstat=rstat, rcmd=rcmd, rseq2=rseq2,
        rabal=rabal, rdeps2=rdeps2, rcseq=rcseq, rcdeps=rcdeps,
        rdcmd=rdcmd, rdseq=rdseq, rddeps=rddeps, aacks=aacks,
        recovered=recovered, gfront=gfront, ccount=ccount,
        xcount=xcount, kcount=kcount, khash=khash,
        m_prop_t=m_prop_t, m_commit_dt=m_commit_dt,
        m_lat_hist=state["m_lat_hist"], m_lat_sum=m_lat_sum,
        m_inscan_viol=m_inscan_viol,
    )
    outbox = {"pa": out_pa, "par": out_par, "acc": out_acc,
              "accr": out_accr, "cmt": out_cmt, "prep": out_prep,
              "prepr": out_prepr, "racc": out_racc, "raccr": out_raccr,
              "rcmt": out_rcmt, "gc": out_gc}
    return new_state, outbox


def metrics(state, cfg: SimConfig):
    """Cumulative counters at the most advanced replica, summed over the
    trailing group axis (int32 scalars)."""
    return {
        "committed_slots": _i32sum(torch.amax(state["ccount"], dim=0)),
        "executed": _i32sum(torch.amax(state["xcount"], dim=0)),
        "recovered": _i32sum(state["recovered"]),
        "commit_lat_sum": _i32sum(state["m_lat_sum"]),
        "commit_lat_n": (_i32sum(state["m_lat_hist"])
                         + _i32sum(state["m_commit_dt"] > 0)),
        "inscan_violations": _i32sum(state["m_inscan_viol"]),
    }


def group_invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """1. Commit agreement on (cmd, seq, deps) over the base-aligned
    common window.  2. Stability: ring-resident commits never change or
    un-commit; the window only advances.  3. Executed is monotone under
    the slide and implies committed.  4. Replicas with equal per-key
    counts have equal per-key hash chains.  Returns each group's
    violations, ``(G,)`` int32 (the pair counts halve per group)."""
    base = new["base"]                                   # (me, R, G)
    align = torch.amax(base, dim=0)[None] - base

    c = shift_window(new["status"] == ST_COMMIT, align, False)
    a_cmd = shift_window(new["cmd"], align, NO_CMD)
    a_seq = shift_window(new["seq"], align, 0)
    a_deps = shift_deps(new["deps"], align)
    pair = c[:, None] & c[None, :]
    same = ((a_cmd[:, None] == a_cmd[None, :])
            & (a_seq[:, None] == a_seq[None, :])
            & torch.all(a_deps[:, None] == a_deps[None, :], dim=4))
    v_agree = group_sum(pair & ~same) // 2

    adv = base - old["base"]
    o_c = shift_window(old["status"] == ST_COMMIT, adv, False)
    o_cmd = shift_window(old["cmd"], adv, NO_CMD)
    o_seq = shift_window(old["seq"], adv, 0)
    o_deps = shift_deps(old["deps"], adv)
    n_c = new["status"] == ST_COMMIT
    v_stable = group_sum(o_c & (~n_c | (new["cmd"] != o_cmd)
                                | (new["seq"] != o_seq)
                                | torch.any(new["deps"] != o_deps, dim=3)))
    v_stable = v_stable + group_sum(adv < 0)

    o_x = shift_window(old["executed"], adv, False)
    v_exec_mono = group_sum(o_x & ~new["executed"])
    v_exec_com = group_sum(new["executed"] & ~n_c)

    eqc = new["kcount"][:, None] == new["kcount"][None, :]
    eqh = new["khash"][:, None] == new["khash"][None, :]
    v_order = group_sum(eqc & ~eqh) // 2

    return v_agree + v_stable + v_exec_mono + v_exec_com + v_order


def invariants(old, new, cfg: SimConfig) -> torch.Tensor:
    """The whole batch's violations: ``group_invariants`` summed (an int32
    scalar)."""
    return torch.sum(group_invariants(old, new, cfg), dtype=torch.int32)


PROTOCOL = SimProtocol(
    name="epaxos",
    mailbox_spec=mailbox_spec,
    init_state=init_state,
    step=step,
    metrics=metrics,
    invariants=invariants,
    group_invariants=group_invariants,
    batched=True,
)
