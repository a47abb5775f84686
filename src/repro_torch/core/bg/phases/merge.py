"""Merge phases (Appendix B, Alg. 7): fold the right sublist into the left.

Host ports of the reference phases, on the round's ``HostShard`` ``h`` and
the slot's fields ``s`` (see ``split.py``).
"""
from __future__ import annotations

from ... import messages as M
from ... import refs
from ...registry import remove_entry, set_fields
from ...types import ST_KEY
from .. import util as U
from ..fsm import BG_IDLE, BG_MERGE_WAIT


def merge_exec(h, s, me, slot_id, outbox, count, cfg):
    """Merge steps 1-3: neutralize the mid block, link around it."""
    le = U.entry_by_keymax(h, s["entry_key"])      # left entry
    re_ = U.entry_by_keymax(h, s["merge_key"])     # right entry
    lidx, ridx = max(le, 0), max(re_, 0)
    lslot, rslot = int(h.r_ctr[lidx]), int(h.r_ctr[ridx])
    valid = (le >= 0 and re_ >= 0
             and int(h.r_keymax[lidx]) == int(h.r_keymin[ridx])
             and refs.ref_sid(int(h.r_subhead[lidx])) == me
             and refs.ref_sid(int(h.r_subhead[ridx])) == me
             and U.rd(h.stct, lslot) >= 0 and U.rd(h.stct, rslot) >= 0)
    if not valid:
        s["phase"] = BG_IDLE
        return outbox, count

    key_mid = int(h.r_keymax[lidx])
    mid_st = refs.ref_idx(int(h.r_subtail[lidx]))   # block to neutralize
    right_sh = refs.ref_idx(int(h.r_subhead[ridx]))
    old_off_sum = int(h.r_offset[lidx]) + int(h.r_offset[ridx])

    # Line 335: neutralize the mid SubTail so traversals cross it
    U.set_at(h, "keymax", mid_st, int(h.r_keymin[lidx]))

    # Lines 341-344: repoint the right half's counter slots to the left's
    idx = U.clip(right_sh, h.n)
    for _ in range(cfg.max_scan):
        h.put("ctr", idx, lslot)
        if int(h.key[idx]) == ST_KEY:
            break
        idx = U.next_idx(h, idx)

    # Lines 346-352 (RDCSS): link leftLast directly to rightFirst. The mid
    # ST-SH block stays quarantined as a forwarder for stale delegations
    left_last, steps = U.clip(refs.ref_idx(int(h.r_subhead[lidx])), h.n), 0
    while (refs.ref_idx(refs.unmarked(int(h.nxt[left_last]))) != mid_st
           and steps < cfg.max_scan):
        nxt = U.next_idx(h, left_last)
        if nxt != mid_st:
            left_last = nxt
        steps += 1
    right_first = refs.unmarked(U.rd(h.nxt, right_sh))
    ll_mark = int(h.nxt[left_last]) & refs.MARK_BIT
    h.put("nxt", left_last, right_first | ll_mark)

    # Lines 336-338: extend the left entry, drop the right entry (local
    # COW); the relink changed the left chain and remove_entry shifted
    # entry indexing, so the whole packed-block mirror drops (DESIGN.md
    # §12)
    reg = set_fields(h.registry(), lidx, keymax=int(h.r_keymax[ridx]),
                     subtail=int(h.r_subtail[ridx]))
    h.set_registry(remove_entry(reg, ridx))
    h.replace("blk_valid", False)

    s.update(phase=BG_MERGE_WAIT, entry_key=s["merge_key"], split_key=key_mid,
             old_slot=lslot, new_slot=rslot, old_keymax=old_off_sum)
    return outbox, count


def merge_wait(h, s, me, slot_id, outbox, count, cfg):
    """Alg. 7 Lines 353-358: offset stabilization + broadcast."""
    a1 = U.rd(h.stct, s["old_slot"]) - U.rd(h.endct, s["old_slot"])
    a2 = U.rd(h.stct, s["new_slot"]) - U.rd(h.endct, s["new_slot"])
    if a1 + a2 != s["old_keymax"]:
        return outbox, count
    e = U.entry_by_keymax(h, s["entry_key"])
    if e >= 0:
        h.set_registry(set_fields(h.registry(), e, offset=a1))
    row = M.make_row(M.MSG_REG_MERGED, 0, me, key=s["split_key"],
                     x1=s["entry_key"])
    for i in range(cfg.num_shards):
        # peer-mask fan-out gate (DESIGN.md §13)
        if i != me and (h.peers >> i) & 1:
            r = row.copy()
            r[M.F_DST] = i
            outbox, count = M.push(outbox, count, r)
    s["phase"] = BG_IDLE
    return outbox, count
