"""Batched replay of a round's MoveItem runs on the device (DESIGN.md §10).

The source's pipelined copy phase ships each sublist as chain-contiguous
runs of ``MSG_MOVE_ITEMS`` rows (K per round per slot). Per-channel FIFO
keeps each (src, slot) run's rows in send order inside the inbox, so the
target replays a whole run with one identity walk (find the run head's
predecessor copy) and one splice: batched node allocation
(``batch_apply.batched_alloc``), one column scatter, one relink — instead
of K serial ``replay_insert`` walks through the row loop.

The splice equals K serial replays exactly when the predecessor copy's
successor is the SubTail or older than every comp_ts of the run (the
eligibility screen below); anything else (run head's predecessor not yet
here, broken contiguity, a fresh replicate at the splice point, allocator
pressure) bounces the whole run to the serial ``h_move_item`` handler.
The reference (``src/repro/core/bg/replay.py``) has the proof.

Port notes: the round's gate is read from the host copy of the rows; the
lock-step identity walk is a host-driven loop with one early-exit read
per step, as ``traverse.probe_batch`` does; ``lexsort`` is a stable sort
(the secondary key is the lane order); ``segment_*`` are int32
``scatter_reduce``; the ``mode="drop"`` scatters are masked writes, in
place on the round's private copy of the state. The acks are built on the
device and brought to the host in the same transfer as the mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import timing
from .. import messages as M
from .. import refs
from ..batch_apply import _count_eq, _seg, batched_alloc
from ..host import to_numpy
from ..types import DiLiConfig, ST_KEY, ShardState
from .fsm import FL_MARKED, FL_ST

# bounce the pre-pass wholesale above this many move rows in one round
_MAX_LANES = 128

# alloc slack left for the serial path (it owns pool-exhaustion edges)
_ALLOC_HEADROOM = 8

_I32 = torch.int32
_IMAX = torch.iinfo(torch.int32).max
_IMIN = torch.iinfo(torch.int32).min


class ReplayOut(NamedTuple):
    state: ShardState
    handled: np.ndarray      # bool[R] on the host — rows applied here
    outbox: np.ndarray
    count: int


def replay_prepass(state: ShardState, rows, me, outbox, count,
                   cfg: DiLiConfig, *, rows_np=None) -> ReplayOut:
    """Apply the round's eligible MSG_MOVE_ITEMS runs in one sweep.

    ``rows`` is the round's [R, FIELDS] int32 tensor on the state's
    device; ``rows_np``, if given, its host copy (read for the gate). The
    state is updated in place and returned; the acks are appended to the
    host ``outbox`` in lane order."""
    if rows_np is None:
        rows_np = to_numpy(rows)
    R = rows.shape[0]
    handled = np.zeros((R,), bool)
    n_mv = int((rows_np[:, M.F_KIND] == M.MSG_MOVE_ITEMS).sum())
    k = min(R, _MAX_LANES)
    if not cfg.move_fastpath or not 0 < n_mv <= k:
        return ReplayOut(state, handled, outbox, count)

    dev = rows.device
    pool = state.pool
    cap = pool.key.shape[0]
    me_t = torch.tensor(me, dtype=_I32, device=dev)

    # compact move rows into k lanes, keeping inbox (channel) order
    is_mv = rows[:, M.F_KIND] == M.MSG_MOVE_ITEMS
    lane = torch.arange(R, dtype=_I32, device=dev)
    sel = torch.argsort((~is_mv).to(_I32) * R + lane)[:k]
    live0 = is_mv[sel]
    r0 = rows[sel]
    # group by (src, slot): per-channel FIFO makes each run contiguous in
    # inbox order once lanes are sorted (stably) by group
    gkey = torch.where(live0,
                       r0[:, M.F_SRC] * cfg.bg_slots
                       + r0[:, M.F_SLOT].clamp(0, cfg.bg_slots - 1), _IMAX)
    g, s2 = torch.sort(gkey, stable=True)
    rf = r0[s2]
    live = live0[s2]
    start_any = torch.ones((k,), dtype=torch.bool, device=dev)
    start_any[1:] = g[1:] != g[:-1]
    sid_g = (torch.cumsum(start_any.to(_I32), 0) - 1).to(torch.int64)

    # contiguity: every non-head lane's predecessor identity must be the
    # previous lane's item identity
    psid, pts = rf[:, M.F_X2], rf[:, M.F_X3]
    isid, its = rf[:, M.F_SID], rf[:, M.F_TS]
    prev_ok = torch.ones((k,), dtype=torch.bool, device=dev)
    prev_ok[1:] = (psid[1:] == isid[:-1]) & (pts[1:] == its[:-1])
    cont = start_any | prev_ok
    no_st = (rf[:, M.F_A] & FL_ST) == 0

    # ---- one lock-step identity walk finds every run head's predecessor
    # copy (only head lanes matter; others ride inertly)
    anchor = refs.ref_idx(rf[:, M.F_REF1]).clamp(0, cap - 1)
    widx = anchor
    done = ((pool.sid[anchor] == psid) & (pool.ts[anchor] == pts)) | ~live
    steps = 0
    while steps < cfg.max_scan and not bool(done.all()):
        w_nxt = pool.nxt[widx]
        hit = (pool.sid[widx] == psid) & (pool.ts[widx] == pts)
        at_end = (pool.key[widx] == ST_KEY) | (refs.is_null(w_nxt) & ~hit)
        nxt = refs.ref_idx(refs.unmarked(w_nxt)).clamp(0, cap - 1)
        stop = done | hit | at_end
        widx = torch.where(stop, widx, nxt)
        done = stop
        steps += 1
    reads = steps + (steps < cfg.max_scan)
    timing.crossed(done, reads, nbytes=reads)
    found = (pool.sid[widx] == psid) & (pool.ts[widx] == pts)

    # ---- per-run aggregates (segments of the lane axis)
    pos = torch.arange(k, dtype=_I32, device=dev)
    lead = _seg(pos, sid_g, k, "amin").clamp(0, k - 1).long()
    lastp = _seg(pos, sid_g, k, "amax").clamp(0, k - 1)
    lead_lane = lead[sid_g]
    prev_copy = widx[lead_lane]
    seg_found = found[lead_lane]
    seg_cont = _seg(cont.to(_I32), sid_g, k, "amin")[sid_g] > 0
    seg_no_st = _seg(no_st.to(_I32), sid_g, k, "amin")[sid_g] > 0

    # splice point: prev_copy's successor must be the SubTail or older
    # than every comp_ts of the run (else serial replay would walk past
    # it — bounce)
    old_word = pool.nxt[prev_copy]
    old_ref = refs.unmarked(old_word)
    old_local = ~refs.is_null(old_ref) & (refs.ref_sid(old_ref) == me_t)
    old_idx = refs.ref_idx(old_ref).clamp(0, cap - 1)
    min_comp = _seg(torch.where(live, pts, _IMAX), sid_g, k, "amin")[sid_g]
    splice_ok = old_local & ((pool.key[old_idx] == ST_KEY)
                             | (pool.ts[old_idx] < min_comp))
    elig = live & seg_found & seg_cont & seg_no_st & splice_ok

    # distinct-splice screen: two runs claiming one predecessor copy would
    # make the relink order-dependent — bounce both
    is_head = start_any & live
    claim = torch.where(elig & is_head, prev_copy, cap + pos)
    dup = _count_eq(torch.sort(claim).values, claim) >= 2
    seg_dup = _seg(dup.to(_I32), sid_g, k, "amax")[sid_g] > 0
    elig = elig & ~seg_dup

    # allocator pressure: bounce wholesale near the edge
    room = state.free_top + (cap - state.alloc_top)
    n_want = elig.to(_I32).sum()
    elig = elig & ((n_want + _ALLOC_HEADROOM) <= room)

    # ---- batched alloc + one splice scatter
    new_idx, _, _, free_top2, alloc_top2 = batched_alloc(state, elig)
    marked = (rf[:, M.F_A] & FL_MARKED) != 0
    is_last = pos == lastp[sid_g]
    next_new = torch.roll(new_idx, -1)
    succ_ref = torch.where(is_last, old_ref, refs.make_ref(me_t, next_new))
    node_nxt = refs.with_mark(succ_ref, marked)
    head = elig & is_head
    head_word = refs.make_ref(me_t, new_idx) | (old_word & refs.MARK_BIT)
    at = new_idx[elig].long()
    ctr_vals = pool.ctr[prev_copy]
    pool.key[at] = rf[elig, M.F_KEY]
    pool.ts[at] = its[elig]
    pool.sid[at] = isid[elig]
    pool.ctr[at] = ctr_vals[elig]
    pool.newloc[at] = refs.NULL_REF
    pool.keymax[at] = rf[elig, M.F_VAL]
    pool.nxt[at] = node_nxt[elig]
    # relink each run's predecessor copy, preserving its own mark
    pool.nxt[prev_copy[head].long()] = head_word[head]

    # §8 Lamport bump past everything absorbed
    max_ts = torch.where(elig, its, _IMIN).max()
    state.ts_clock.copy_(torch.maximum(state.ts_clock, max_ts + 1))
    state.free_top.copy_(free_top2)
    state.alloc_top.copy_(alloc_top2)
    # packed-block compaction point (DESIGN.md §12): the splice grows clone
    # chains no block mirrors — drop the whole mirror when anything landed
    state.blk.valid.logical_and_(~elig.any())

    # ---- acks, in lane (channel) order, and the mask, in one transfer
    ack = torch.zeros((k, M.FIELDS), dtype=_I32, device=dev)
    ack[:, M.F_KIND] = M.MSG_MOVE_ACK
    ack[:, M.F_DST] = rf[:, M.F_SRC]
    ack[:, M.F_SRC] = me_t
    ack[:, M.F_REF1] = refs.make_ref(me_t, new_idx)
    ack[:, M.F_SID] = isid
    ack[:, M.F_TS] = its
    ack[:, M.F_X1] = rf[:, M.F_X1]
    ack[:, M.F_A] = rf[:, M.F_A]
    ack[:, M.F_SLOT] = rf[:, M.F_SLOT]
    lane_of = sel[s2]                  # inbox row of each lane
    host = to_numpy(torch.cat([ack.reshape(-1), elig.to(_I32),
                               lane_of.to(_I32)]))
    acks = host[:k * M.FIELDS].reshape(k, M.FIELDS)
    elig_np = host[k * M.FIELDS:k * M.FIELDS + k].astype(bool)
    handled[host[k * M.FIELDS + k:][elig_np]] = True
    outbox, count = M.push_many(outbox, count, acks, elig_np)
    return ReplayOut(state, handled, outbox, count)
