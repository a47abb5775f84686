"""Split phases (§5.3): insert the ST-SH block, stabilize, register.

Host ports of the reference phases: ``h`` is the round's ``HostShard``
working copy and ``s`` the slot's fields as a dict of Python ints; both
are updated in place. A phase that does not fire leaves the state exactly
as it found it (the reference's ``where(ok, new, old)`` over every field).
"""
from __future__ import annotations

from ... import messages as M
from ... import refs
from ...registry import add_entry, set_fields
from ...types import SH_KEY, ST_KEY
from .. import util as U
from ..fsm import BG_IDLE, BG_SPLIT_WAIT


def split_exec(h, s, me, slot_id, outbox, count, cfg):
    """Split steps 1-3 (§5.3): insert the ST-SH block, repoint counters."""
    e = U.entry_by_keymax(h, s["entry_key"])
    eidx = max(e, 0)
    sitem = min(max(s["sitem"], 0), h.n - 1)
    sitem_key = int(h.key[sitem])
    valid = (e >= 0
             and refs.ref_sid(int(h.r_subhead[eidx])) == me
             and not refs.ref_mark(int(h.nxt[sitem]))
             and int(h.ctr[sitem]) == int(h.r_ctr[eidx])
             and int(h.r_keymin[eidx]) < sitem_key < int(h.r_keymax[eidx])
             and sitem_key not in (SH_KEY, ST_KEY))

    new_slot = h.ctr_top
    old_slot = int(h.r_ctr[eidx])
    # allocate tentatively: a refused split must leave the allocator as it
    # was, so roll back unless every check passes
    tops = (h.free_top, h.alloc_top)
    st_idx, ok1 = U.alloc_node(h)
    sh_idx, ok2 = U.alloc_node(h)
    ok = valid and new_slot < h.n_ctrs and ok1 and ok2
    if not ok:
        h.free_top, h.alloc_top = tops
        s["phase"] = BG_IDLE
        return outbox, count

    h.ctr_top = new_slot + 1
    old_next = int(h.nxt[sitem])          # unmarked by ``valid``
    ts1 = h.ts_clock
    for idx, k, slot, ts in ((st_idx, ST_KEY, old_slot, ts1),
                             (sh_idx, SH_KEY, new_slot, ts1 + 1)):
        h.put("key", idx, k)
        h.put("ctr", idx, slot)
        h.put("sid", idx, me)
        h.put("ts", idx, ts)
        h.put("newloc", idx, refs.NULL_REF)
    h.put("keymax", st_idx, sitem_key)
    # ST -> SH -> old next; then CAS sItem.next := ST (Lines 131-139)
    h.put("nxt", sh_idx, old_next)
    h.put("nxt", st_idx, refs.make_ref(me, sh_idx))
    h.put("nxt", sitem, refs.make_ref(me, st_idx))
    h.ts_clock = ts1 + 2

    # repoint counter pointers of the right half (Lines 140-146),
    # old-subtail included — the reference's bounded while_loop
    idx = min(max(refs.ref_idx(refs.unmarked(old_next)), 0), h.n - 1)
    for _ in range(cfg.max_scan):
        h.put("ctr", idx, new_slot)
        if int(h.key[idx]) == ST_KEY:
            break
        idx = min(max(refs.ref_idx(refs.unmarked(int(h.nxt[idx]))), 0),
                  h.n - 1)
    # packed-block compaction point (DESIGN.md §12): the mid ST-SH block
    # now sits inside entry e's chain, so its mirror row is stale
    h.put("blk_valid", eidx, False)

    s.update(phase=BG_SPLIT_WAIT, new_slot=new_slot, old_slot=old_slot,
             split_key=sitem_key, sh_new=sh_idx, st_new=st_idx,
             old_keymax=int(h.r_keymax[eidx]))
    return outbox, count


def split_wait(h, s, me, slot_id, outbox, count, cfg):
    """Split step 4 (Lines 147-157): offset stabilization + registry COW."""
    e = U.entry_by_keymax(h, s["entry_key"])
    eidx = max(e, 0)
    ns = min(max(s["new_slot"], 0), h.n_ctrs - 1)
    os_ = min(max(s["old_slot"], 0), h.n_ctrs - 1)
    a1 = int(h.stct[ns]) - int(h.endct[ns])
    a2 = int(h.stct[os_]) - int(h.endct[os_])
    stable = e >= 0 and a1 + a2 == int(h.r_offset[eidx]) and h.size < h.m
    if not stable:
        return outbox, count

    old_subtail = int(h.r_subtail[eidx])
    sh_ref = refs.make_ref(me, s["sh_new"])
    st_ref = refs.make_ref(me, s["st_new"])
    reg = set_fields(h.registry(), eidx, keymax=s["split_key"],
                     subtail=st_ref, offset=a2)
    h.set_registry(add_entry(reg, s["split_key"], s["old_keymax"], sh_ref,
                             old_subtail, s["new_slot"], a1))
    # add_entry shifts every entry index at/after the insertion point —
    # blocks are entry-indexed, so the whole mirror drops (DESIGN.md §12)
    h.replace("blk_valid", False)

    row = M.make_row(M.MSG_REG_SPLIT, 0, me, key=s["split_key"],
                     x1=s["old_keymax"], ref1=sh_ref)
    for i in range(cfg.num_shards):
        # fan-out gated on the live-peer bitmask (DESIGN.md §13)
        if i != me and (h.peers >> i) & 1:
            r = row.copy()
            r[M.F_DST] = i
            outbox, count = M.push(outbox, count, r)
    s["phase"] = BG_IDLE
    return outbox, count
