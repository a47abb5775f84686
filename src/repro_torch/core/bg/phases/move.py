"""Move phases (§5.4 + Alg. 5): MoveSH, the pipelined batched copy,
stabilization, Switch, and quarantine.

Host ports of the reference phases (``h`` is the round's ``HostShard``,
``s`` the slot's fields as a dict of Python ints; both updated in place).
The copy phase is pipelined as in the reference (DESIGN.md §10): the
source keeps two cursors —

* ``send_prev``: the last chain node handed to the fabric. Each round it
  advances over the next chain-contiguous run of up to ``cfg.move_batch``
  un-replicated items, emitting one ``MSG_MOVE_ITEMS`` row per item
  without awaiting acks;
* ``cursor``: the acked-prefix cursor, advanced only over the contiguous
  prefix of items whose ``newLoc`` is known. Once the pipeline drains
  (sent == acked) the walk restarts there and ships the stragglers that
  racing inserts left behind ``send_prev``.

The SubTail is sent only when the walk from ``cursor`` reaches it
directly with nothing in flight.
"""
from __future__ import annotations

from ... import messages as M
from ... import refs
from ...registry import set_fields
from ...types import NEG_INF_CT, SH_KEY, ST_KEY
from .. import util as U
from ..fsm import (BG_IDLE, BG_MOVE_SH_WAIT, BG_MOVE_STABLE, BG_QUAR,
                   BG_SWITCH_REG, BG_SWITCH_ST, BG_SWITCH_ST_WAIT,
                   FL_MARKED, FL_ST)


def move_sh(h, s, me, slot_id, outbox, count, cfg):
    e = U.entry_by_keymax(h, s["entry_key"])
    eidx = max(e, 0)
    sh = int(h.r_subhead[eidx])
    ok = e >= 0 and refs.ref_sid(sh) == me and s["target"] != me
    head_idx = refs.ref_idx(sh)
    if ok:
        row = M.make_row(M.MSG_MOVE_SH, s["target"], me,
                         key=int(h.r_keymin[eidx]),
                         x1=int(h.r_keymax[eidx]), sid=U.rd(h.sid, head_idx),
                         ts=U.rd(h.ts, head_idx), slot=slot_id)
        outbox, count = M.push(outbox, count, row)
        # packed-block compaction point (DESIGN.md §12): the entry is about
        # to start moving — drop its block now; it stays invalid until
        # after the Switch
        h.put("blk_valid", eidx, False)
        s.update(phase=BG_MOVE_SH_WAIT, old_head=head_idx)
    else:
        s["phase"] = BG_IDLE
    return outbox, count


def _item_row(h, s, me, slot_id, kind, curr, prev, anchor, flags, key):
    return M.make_row(
        kind, s["target"], me, a=flags, key=key, ref1=anchor,
        sid=int(h.sid[curr]), ts=int(h.ts[curr]), x1=curr,
        x2=U.rd(h.sid, prev), x3=U.rd(h.ts, prev),
        x4=refs.unmarked(int(h.nxt[curr])), val=int(h.keymax[curr]),
        slot=slot_id)


def move_copy(h, s, me, slot_id, outbox, count, cfg):
    """One round of the pipelined copy (module docstring)."""
    active = s["st_sent"] == 0

    # 1. advance the acked-prefix cursor over items with a known newLoc
    cursor, steps = s["cursor"], 0
    while active and steps < cfg.max_scan:
        nxt = U.next_idx(h, cursor)
        if refs.is_null(int(h.newloc[nxt])) or int(h.key[nxt]) == ST_KEY:
            break
        cursor, steps = nxt, steps + 1
    anchor = refs.unmarked(U.rd(h.newloc, cursor))
    drained = s["sent"] == s["acked"]

    # 2. ship the next chain-contiguous run of un-replicated items; the
    # run ends at the first newLoc'd node or at ST
    prev, nsent = s["send_prev"], 0
    if active:
        for _ in range(cfg.move_batch):
            curr = U.next_idx(h, prev)
            if (int(h.key[curr]) == ST_KEY
                    or not refs.is_null(int(h.newloc[curr]))):
                break
            flags = FL_MARKED * refs.ref_mark(int(h.nxt[curr]))
            outbox, count = M.push(outbox, count, _item_row(
                h, s, me, slot_id, M.MSG_MOVE_ITEMS, curr, prev, anchor,
                flags, int(h.key[curr])))
            nsent += 1
            prev = curr

    # 3. nothing to send and nothing in flight: either the walk from the
    # acked-prefix cursor meets ST directly (ship the SubTail) or it is
    # past stragglers/newLoc'd nodes (restart it from the cursor)
    st_idx = U.next_idx(h, s["send_prev"])
    at_end = active and nsent == 0 and drained
    send_st = (at_end and int(h.key[st_idx]) == ST_KEY
               and s["send_prev"] == cursor)
    restart = at_end and not send_st
    if send_st:
        flags = FL_MARKED * refs.ref_mark(int(h.nxt[st_idx])) + FL_ST
        outbox, count = M.push(outbox, count, _item_row(
            h, s, me, slot_id, M.MSG_MOVE_ITEM, st_idx, cursor,
            anchor, flags, int(h.keymax[st_idx])))

    phase = (BG_MOVE_STABLE if s["st_acked"] != 0
             and s["sent"] == s["acked"] else s["phase"])
    if active:
        s["cursor"] = cursor
        s["send_prev"] = cursor if restart else prev
    s["sent"] += nsent + int(send_st)
    if send_st:
        s["st_sent"] = 1
    s["phase"] = phase
    return outbox, count


def move_stable(h, s, me, slot_id, outbox, count, cfg):
    """Line 202-204: CAS stCt := -inf once both copies are provably
    equal."""
    e = U.entry_by_keymax(h, s["entry_key"])
    eidx = max(e, 0)
    slot = int(h.r_ctr[eidx])
    quiet = e >= 0 and U.rd(h.stct, slot) == \
        U.rd(h.endct, slot) + int(h.r_offset[eidx])
    if quiet:
        U.set_at(h, "stct", slot, NEG_INF_CT)
        s["phase"] = BG_SWITCH_ST
    return outbox, count


def switch_st_phase(h, s, me, slot_id, outbox, count, cfg):
    """Alg. 5 Lines 269-280: repoint the previous sublist's SubTail."""
    e = U.entry_by_keymax(h, s["entry_key"])
    keymin = int(h.r_keymin[max(e, 0)])
    no_left = keymin <= SH_KEY
    left = U.cover(h, keymin)
    left_owner = refs.ref_sid(int(h.r_subhead[max(left, 0)]))
    local = not no_left and left >= 0 and left_owner == me
    remote = not no_left and left >= 0 and left_owner != me
    ok = local and U.switch_next_st(h, me, keymin, s["sh_star"])
    if remote:
        row = M.make_row(M.MSG_SWITCH_ST, left_owner, me, key=keymin,
                         ref1=s["sh_star"], slot=slot_id)
        outbox, count = M.push(outbox, count, row)
    if no_left or ok:
        s["phase"] = BG_SWITCH_REG
    elif remote:
        s["phase"] = BG_SWITCH_ST_WAIT
    return outbox, count


def switch_reg(h, s, me, slot_id, outbox, count, cfg):
    """Alg. 5 Lines 281-284: update own registry, broadcast
    SwitchServer."""
    e = U.entry_by_keymax(h, s["entry_key"])
    eidx = max(e, 0)
    keymin = int(h.r_keymin[eidx])
    if e >= 0:
        h.set_registry(set_fields(h.registry(), eidx, subhead=s["sh_star"],
                                  subtail=s["st_star"], ctr=0, offset=0))
        row = M.make_row(M.MSG_SWITCH_SERVER, 0, me, key=keymin,
                         x1=s["entry_key"], ref1=s["sh_star"],
                         x3=s["st_star"])
        for i in range(cfg.num_shards):
            # peer-mask fan-out gate (DESIGN.md §13) — except the move
            # target, which must always learn the transfer
            if i != me and ((h.peers >> i) & 1 or i == s["target"]):
                r = row.copy()
                r[M.F_DST] = i
                outbox, count = M.push(outbox, count, r)
    s.update(phase=BG_QUAR, quar_round=s["round"])
    return outbox, count


def quarantine(h, s, me, slot_id, outbox, count, cfg):
    """Free the stale source chain (interior only — the old SubHead keeps
    forwarding via newLoc; the epoch-based analogue of hazard
    pointers)."""
    if s["round"] - s["quar_round"] < cfg.quarantine_rounds:
        return outbox, count
    cap = h.free_list.shape[0]
    idx = U.next_idx(h, s["old_head"])
    ftop, steps, done = h.free_top, 0, False
    while not done and steps < cfg.max_scan:
        done = int(h.key[idx]) == ST_KEY
        h.put("free_list", U.clip(ftop, cap), idx)
        ftop += 1
        idx = U.next_idx(h, idx)
        steps += 1
    h.free_top = ftop
    s["phase"] = BG_IDLE
    return outbox, count
