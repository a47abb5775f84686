"""Message handlers of the background protocol (§5.3-5.4, Alg. 5-7), host
side.

All handlers share one signature::

    (h, hb, me, row, outbox, count, cfg) -> (outbox, count)

``h`` is the round's ``HostShard`` working copy and ``hb`` the shard's
``HostBg`` table; both are updated in place. Handlers that complete a
request issued by a background slot (MOVE_SH_ACK, MOVE_ACK, SWITCH_ST_ACK)
address the slot named by the row's ``F_SLOT`` lane, so concurrent ops on
one shard never credit each other's progress. Replicate and registry
handlers never touch the table. Each one takes exactly the branches of the
reference's handler of the same name (``where(ok, new, old)`` becomes
``if ok``), retry counters and Lamport bumps included.

Delivery contract, as in the reference: exactly-once, per-(src,dst)-FIFO
delivery (several handlers are not duplicate-safe).
"""
from __future__ import annotations

from .. import messages as M
from .. import refs
from ..registry import add_entry, remove_entry, set_fields
from ..types import SH_KEY, ST_KEY
from . import util as U
from .fsm import (BG_IDLE, BG_MOVE_COPY, BG_MOVE_SH_WAIT, BG_SWITCH_REG,
                  BG_SWITCH_ST, BG_SWITCH_ST_WAIT, FL_MARKED, FL_ST)


def _row_slot(hb, row) -> int:
    """Bg slot a move/switch ack addresses (clipped against the table)."""
    return U.clip(row[M.F_SLOT], hb.slots)


def _set_slot_where(hb, j: int, good: bool, **updates) -> None:
    """Apply per-field updates to slot ``j`` when ``good``."""
    if good:
        hb.store(j, updates)


def _retry(row, me, outbox, count, do):
    """Requeue ``row`` at this shard with its retry count (``F_A``) + 1."""
    if do:
        r = row.copy()
        r[M.F_A] += 1
        r[M.F_DST] = me
        outbox, count = M.push(outbox, count, r)
    return outbox, count


def h_rep_insert(h, hb, me, row, outbox, count, cfg):
    """RepInsertAfterRecv (Lines 226-231)."""
    anchor = refs.ref_idx(int(row[M.F_REF1]))
    item_sid, item_ts = int(row[M.F_SID]), int(row[M.F_TS])
    prev_idx, found = U.find_by_identity(h, anchor, row[M.F_X2],
                                         row[M.F_X3], cfg.max_scan)
    new_idx, ok = 0, False
    if found:
        new_idx, ok = U.replay_insert(
            h, me, prev_idx, item_ts, int(row[M.F_KEY]), item_sid, item_ts,
            False, cfg, value=int(row[M.F_VAL]))
    apply_it = found and ok
    if apply_it:
        ack = M.make_row(M.MSG_ACK_INSERT, int(row[M.F_SRC]), me,
                         ref1=refs.make_ref(me, new_idx), sid=item_sid,
                         ts=item_ts, x1=int(row[M.F_X1]),
                         x4=int(row[M.F_X4]))
        outbox, count = M.push(outbox, count, ack)
    # prev's copy not here yet (out-of-order delivery): retry next round
    return _retry(row, me, outbox, count,
                  not apply_it and int(row[M.F_A]) < cfg.max_retries)


def h_rep_delete(h, hb, me, row, outbox, count, cfg):
    """RepDeleteRecv (Lines 232-239)."""
    anchor = refs.ref_idx(int(row[M.F_REF1]))
    idx, found = U.find_by_identity(h, anchor, row[M.F_SID], row[M.F_TS],
                                    cfg.max_scan)
    if found:
        h.put("nxt", idx, refs.with_mark(int(h.nxt[idx])))
    if found and int(row[M.F_X2]) != 0:
        ack = M.make_row(M.MSG_ACK_DELETE, int(row[M.F_SRC]), me,
                         x1=int(row[M.F_X1]), x4=int(row[M.F_X4]))
        outbox, count = M.push(outbox, count, ack)
    return _retry(row, me, outbox, count,
                  not found and int(row[M.F_A]) < cfg.max_retries)


def h_ack_insert(h, hb, me, row, outbox, count, cfg):
    """InsertReplayResponseRecv (Lines 263-265)."""
    oldloc = int(row[M.F_X1])
    same = (U.rd(h.sid, oldloc) == int(row[M.F_SID])
            and U.rd(h.ts, oldloc) == int(row[M.F_TS]))
    U.set_at(h, "newloc", oldloc, int(row[M.F_REF1]), same)
    # the deferred endCt increment always lands (balances the op's stCt++)
    U.add_at(h, "endct", int(row[M.F_X4]), 1)
    return outbox, count


def h_ack_delete(h, hb, me, row, outbox, count, cfg):
    """RemoveReplayResponseRecv (Lines 266-267)."""
    U.add_at(h, "endct", int(row[M.F_X4]), 1)
    return outbox, count


def h_move_sh(h, hb, me, row, outbox, count, cfg):
    """MoveSHRecv (Lines 215-225): create SH*/ST* + fresh counters."""
    sh_sid, sh_ts = int(row[M.F_SID]), int(row[M.F_TS])
    slot = h.ctr_top
    slot_ok = slot < h.n_ctrs
    h.ctr_top = slot + int(slot_ok)
    st_idx, ok1 = U.alloc_node(h)
    sh_idx, ok2 = U.alloc_node(h)
    ok = slot_ok and ok1 and ok2
    if ok:
        h.put("key", st_idx, ST_KEY)
        h.put("key", sh_idx, SH_KEY)
        h.put("keymax", st_idx, int(row[M.F_X1]))
        h.put("ctr", st_idx, slot)
        h.put("ctr", sh_idx, slot)
        # the SubHead keeps the original's <sId, ts> identity (Line 219)
        h.put("sid", sh_idx, sh_sid)
        h.put("sid", st_idx, me)
        h.put("ts", sh_idx, sh_ts)
        h.put("ts", st_idx, h.ts_clock)
        h.put("newloc", sh_idx, refs.NULL_REF)
        h.put("newloc", st_idx, refs.NULL_REF)
        h.put("nxt", sh_idx, refs.make_ref(me, st_idx))
        h.put("nxt", st_idx, refs.NULL_REF)
    h.ts_clock += 1
    U.lamport(h, sh_ts)
    ack = M.make_row(M.MSG_MOVE_SH_ACK, int(row[M.F_SRC]), me,
                     ref1=refs.make_ref(me, sh_idx),
                     x3=refs.make_ref(me, st_idx), key=int(row[M.F_KEY]),
                     x1=int(row[M.F_X1]), a=int(ok),
                     slot=int(row[M.F_SLOT]))
    return M.push(outbox, count, ack)


def h_move_sh_ack(h, hb, me, row, outbox, count, cfg):
    """Line 200: head.newLoc = remoteSH; start copying."""
    j = _row_slot(hb, row)
    s = hb.slot(j)
    waiting = s["phase"] == BG_MOVE_SH_WAIT
    good = waiting and int(row[M.F_A]) != 0
    sh_star = int(row[M.F_REF1])
    U.set_at(h, "newloc", s["old_head"], sh_star, good)
    _set_slot_where(hb, j, good, phase=BG_MOVE_COPY, sh_star=sh_star,
                    st_star=int(row[M.F_X3]), cursor=s["old_head"],
                    send_prev=s["old_head"], sent=0, acked=0, st_sent=0,
                    st_acked=0)
    # nack (target out of nodes / counter slots): abort the move and free
    # the slot — leaving it in MOVE_SH_WAIT would claim the entry forever
    _set_slot_where(hb, j, waiting and int(row[M.F_A]) == 0, phase=BG_IDLE)
    return outbox, count


def h_move_item(h, hb, me, row, outbox, count, cfg):
    """MoveItemRecv (Lines 240-248): replay-insert the copied item.

    Serves both MSG_MOVE_ITEM (SubTail rows, retries) and any
    MSG_MOVE_ITEMS row the batched replay pre-pass bounced — the two kinds
    share one field layout by construction.
    """
    flags = int(row[M.F_A])
    is_st = (flags & FL_ST) != 0
    item_sid, item_ts = int(row[M.F_SID]), int(row[M.F_TS])
    key = int(row[M.F_KEY])
    prev_ts = int(row[M.F_X3])
    prev_idx, found = U.find_by_identity(
        h, refs.ref_idx(int(row[M.F_REF1])), row[M.F_X2], prev_ts,
        cfg.max_scan)

    done = False
    ack_ref = 0
    if found and is_st:
        # ST: link the target SubTail into the global chain (Lines 241-247)
        st_idx, steps = prev_idx, 0
        while int(h.key[st_idx]) != ST_KEY and steps < cfg.max_scan:
            st_idx = U.next_idx(h, st_idx)
            steps += 1
        h.put("nxt", st_idx, int(row[M.F_X4]))  # source ST's next
        h.put("keymax", st_idx, key)
        ack_ref, done = refs.make_ref(me, st_idx), True
    elif found:
        # ordinary item: replay insert with compTs = prev.ts (Line 248)
        new_idx, done = U.replay_insert(
            h, me, prev_idx, prev_ts, key, item_sid, item_ts,
            (flags & FL_MARKED) != 0, cfg, value=int(row[M.F_VAL]))
        ack_ref = refs.make_ref(me, new_idx)

    if done:
        ack = M.make_row(M.MSG_MOVE_ACK, int(row[M.F_SRC]), me, ref1=ack_ref,
                         sid=item_sid, ts=item_ts, x1=int(row[M.F_X1]),
                         a=flags, slot=int(row[M.F_SLOT]))
        outbox, count = M.push(outbox, count, ack)
    # bounded retry: the retry count rides in the flag word's high bits
    elif (flags >> 8) < cfg.max_retries:
        retry = row.copy()
        retry[M.F_A] = flags + 256
        retry[M.F_DST] = me
        outbox, count = M.push(outbox, count, retry)
    return outbox, count


def h_move_ack(h, hb, me, row, outbox, count, cfg):
    """Source side of MoveItem (Lines 208-211): record newLoc, detect
    races."""
    oldloc = int(row[M.F_X1])
    sid, ts = int(row[M.F_SID]), int(row[M.F_TS])
    flags = int(row[M.F_A])
    is_st = (flags & FL_ST) != 0
    new_ref = int(row[M.F_REF1])

    same = U.rd(h.sid, oldloc) == sid and U.rd(h.ts, oldloc) == ts
    U.set_at(h, "newloc", oldloc, new_ref, same)
    # Line 210: item got marked while the copy was in flight -> RepDelete
    race = (same and refs.ref_mark(U.rd(h.nxt, oldloc))
            and not flags & FL_MARKED and not is_st)
    if race:
        # x2=0: no ack needed — the remove already balanced its endCt
        rep = M.make_row(M.MSG_REP_DELETE, refs.ref_sid(new_ref), me,
                         ref1=refs.unmarked(new_ref), sid=sid, ts=ts,
                         x1=oldloc, x2=0, x4=0)
        outbox, count = M.push(outbox, count, rep)

    j = _row_slot(hb, row)
    # NB the acked-prefix cursor is advanced only by move_copy's
    # contiguous-prefix walk
    if int(hb.f["phase"][j]) == BG_MOVE_COPY:
        hb.f["acked"][j] += 1
        if is_st:
            hb.f["st_acked"][j] = 1
    return outbox, count


def h_switch_st(h, hb, me, row, outbox, count, cfg):
    """SwitchSTRecv (Lines 272-277 + 297-302). A misrouted request is
    delegated toward the owner this replica names; only the terminal hop
    acks (see the reference)."""
    keymin = int(row[M.F_KEY])
    left = U.cover(h, keymin)
    owner = refs.ref_sid(int(h.r_subhead[max(left, 0)]))
    delegate = (left >= 0 and owner != me
                and int(row[M.F_A]) < cfg.max_retries)
    success = U.switch_next_st(h, me, keymin, int(row[M.F_REF1]))
    if delegate:
        fwd = row.copy()
        fwd[M.F_A] += 1
        fwd[M.F_DST] = owner
        return M.push(outbox, count, fwd)
    ack = M.make_row(M.MSG_SWITCH_ST_ACK, int(row[M.F_SRC]), me,
                     a=int(success), slot=int(row[M.F_SLOT]))
    return M.push(outbox, count, ack)


def h_switch_st_ack(h, hb, me, row, outbox, count, cfg):
    j = _row_slot(hb, row)
    _set_slot_where(hb, j, int(hb.f["phase"][j]) == BG_SWITCH_ST_WAIT,
                    phase=BG_SWITCH_REG if int(row[M.F_A]) != 0
                    else BG_SWITCH_ST)
    return outbox, count


def h_reg_split(h, hb, me, row, outbox, count, cfg):
    """RegisterSublistRecv (Lines 159-163) at a replica."""
    split_key, keymax = int(row[M.F_KEY]), int(row[M.F_X1])
    sh_ref = int(row[M.F_REF1])
    e = U.cover(h, keymax)
    eidx = max(e, 0)
    kmin, kmax = int(h.r_keymin[eidx]), int(h.r_keymax[eidx])
    # exact right-half already present (duplicate) — drop
    dup = e >= 0 and kmin == split_key and kmax == keymax
    # parent entry present: split it
    can = (e >= 0 and not dup and kmin < split_key and kmax == keymax
           and h.size < h.m)
    if can:
        reg = set_fields(h.registry(), eidx, keymax=split_key)
        h.set_registry(add_entry(reg, split_key, keymax, sh_ref,
                                 refs.NULL_REF, 0, 0))
    return _retry(row, me, outbox, count,
                  not can and not dup and int(row[M.F_A]) < cfg.max_retries)


def h_switch_server(h, hb, me, row, outbox, count, cfg):
    """SwitchServerRecv (Lines 285-287): repoint a registry entry. A
    replica coarser than the sender's registry carves the switched range
    out of its stale covering entry (see the reference)."""
    keymin, keymax = int(row[M.F_KEY]), int(row[M.F_X1])
    sh_ref, st_ref = int(row[M.F_REF1]), int(row[M.F_X3])
    e = U.cover(h, keymax)
    eidx = max(e, 0)
    exact = (e >= 0 and int(h.r_keymin[eidx]) == keymin
             and int(h.r_keymax[eidx]) == keymax)
    new_ctr = (int(h.ctr[U.clip(refs.ref_idx(sh_ref), h.n)])
               if refs.ref_sid(sh_ref) == me else 0)
    if exact:
        h.set_registry(set_fields(h.registry(), eidx, subhead=sh_ref,
                                  subtail=st_ref, ctr=new_ctr, offset=0))

    # carve-out for a stale covering entry (never one of my own chains)
    old_sh = int(h.r_subhead[eidx])
    old_kmin, old_keymax = int(h.r_keymin[eidx]), int(h.r_keymax[eidx])
    covered = (e >= 0 and not exact and old_kmin <= keymin
               and old_keymax >= keymax and refs.ref_sid(old_sh) != me)
    left_rem = covered and old_kmin < keymin
    right_rem = covered and old_keymax > keymax
    carve = covered and h.size + left_rem + right_rem <= h.m
    if carve:
        reg = h.registry()
        if left_rem:
            # the covering entry keeps the left remainder; add the
            # switched entry after it
            reg = add_entry(set_fields(reg, eidx, keymax=keymin), keymin,
                            keymax, sh_ref, st_ref, new_ctr, 0)
        else:
            reg = set_fields(reg, eidx, keymax=keymax, subhead=sh_ref,
                             subtail=st_ref, ctr=new_ctr, offset=0)
        if right_rem:
            # replicas carry a null subtail, as in h_reg_split
            reg = add_entry(reg, keymax, old_keymax, old_sh, refs.NULL_REF,
                            0, 0)
        h.set_registry(reg)
    return _retry(row, me, outbox, count,
                  not exact and not carve
                  and int(row[M.F_A]) < cfg.max_retries)


def h_reg_merged(h, hb, me, row, outbox, count, cfg):
    """RegisterMergedSublistRecv (Lines 360-365) at a replica."""
    key_mid = int(row[M.F_KEY])
    right = U.entry_by_keymax(h, int(row[M.F_X1]))
    ridx = max(right, 0)
    left = U.cover(h, key_mid)
    lidx = max(left, 0)
    ok = (right >= 0 and int(h.r_keymin[ridx]) == key_mid and left >= 0
          and int(h.r_keymax[lidx]) == key_mid)
    # already merged here (idempotent) — drop; otherwise out-of-order with
    # a pending REG_SPLIT: retry next round
    merged = right < 0 and left >= 0
    if ok:
        reg = set_fields(h.registry(), lidx, keymax=int(h.r_keymax[ridx]))
        h.set_registry(remove_entry(reg, ridx))
    return _retry(row, me, outbox, count,
                  not ok and not merged
                  and int(row[M.F_A]) < cfg.max_retries)
