"""Shared host-side helpers for the background engine: registry lookups,
allocation, the identity walk, the serial Replay insert (Lines 249-262) and
switchNextST (Lines 297-302). They work on a ``HostShard``
(``core/host.py``), the serial pass's working copy of a shard.

Replay follows the reference: items are identified by their <sId, ts>
tuple; an insert replays before the first node whose ts is smaller than
the inserted item's comparison timestamp, and the receiving shard
Lamport-bumps its clock on every replayed item (DESIGN.md §8).

Indexing follows JAX's rules, because the reference computes on with
whatever an index gives it: a read (``rd``) normalizes a negative index
and clamps it into the column; a write (``set_at``, ``add_at``) happens
only when asked to and when the normalized index is in range (JAX drops
an out-of-range scatter).
"""
from __future__ import annotations

from .. import refs
from .. import registry as reg_ops
from ..types import ST_KEY


def _norm(n: int, i: int) -> int:
    i = int(i)
    return i + n if i < 0 else i


def rd(col, i: int) -> int:
    """``col[i]`` as JAX gathers it: negative wraps, then clamps."""
    n = col.shape[0]
    return int(col[min(max(_norm(n, i), 0), n - 1)])


def clip(i: int, n: int) -> int:
    return min(max(int(i), 0), n - 1)


def set_at(h, name: str, idx: int, val, do=True) -> None:
    """``col.at[idx].set(val)`` where ``do``; out of range it is dropped."""
    n = getattr(h, name).shape[0]
    i = _norm(n, idx)
    if do and 0 <= i < n:
        h.put(name, i, int(val))


def add_at(h, name: str, idx: int, delta: int, do=True) -> None:
    """``col.at[idx].add(delta)`` where ``do``; out of range it is
    dropped."""
    col = getattr(h, name)
    i = _norm(col.shape[0], idx)
    if do and 0 <= i < col.shape[0]:
        h.put(name, i, int(col[i]) + delta)


def next_idx(h, idx: int) -> int:
    """Pool index of ``idx``'s successor, clamped into the pool."""
    return clip(refs.ref_idx(refs.unmarked(rd(h.nxt, idx))), h.n)


def cover(h, key: int) -> int:
    return reg_ops.lookup(h.r_keymin, h.r_keymax, h.size, key)


def entry_by_keymax(h, keymax: int) -> int:
    """Entry whose keymax equals ``keymax`` (the bg op's stable handle)."""
    e = cover(h, keymax)
    return e if e >= 0 and int(h.r_keymax[max(e, 0)]) == keymax else -1


def alloc_node(h):
    """Pop the free list, else bump-allocate. Returns (idx, ok); idx is 0
    when the pool is exhausted."""
    if h.free_top > 0:
        idx = int(h.free_list[h.free_top - 1])
        h.free_top -= 1
        return idx, True
    if h.alloc_top < h.n:
        idx = h.alloc_top
        h.alloc_top += 1
        return idx, True
    return 0, False


def lamport(h, ts: int) -> None:
    h.ts_clock = max(h.ts_clock, int(ts) + 1)


def same_identity(h, idx: int, sid: int, ts: int) -> bool:
    return int(h.sid[idx]) == sid and int(h.ts[idx]) == ts


def find_by_identity(h, start_idx: int, sid: int, ts: int, bound: int):
    """Walk the chain from ``start_idx`` for the node with <sId, ts>.

    Returns (idx, found). Stops at SubTail / null / ``bound`` steps.
    Used by Replay (Lines 227-230) and RepDelete (Lines 232-234).
    """
    sid, ts = int(sid), int(ts)
    idx = clip(start_idx, h.n)
    done = same_identity(h, idx, sid, ts)
    steps = 0
    while not done and steps < bound:
        hit = same_identity(h, idx, sid, ts)
        at_end = (int(h.key[idx]) == ST_KEY
                  or (refs.is_null(int(h.nxt[idx])) and not hit))
        if not (hit or at_end):
            idx = next_idx(h, idx)
        steps += 1
        done = hit or at_end
    return idx, same_identity(h, idx, sid, ts)


def replay_insert(h, me: int, prev_idx: int, comp_ts: int, key: int,
                  item_sid: int, item_ts: int, is_marked: bool, cfg,
                  value: int = 0):
    """Replay algorithm Lines 249-262: insert after ``prev``, before the
    first node whose ts < comp_ts. Returns (new_idx, ok).

    The reference keeps the result only where the row's identity walk
    found the predecessor and the allocation succeeded, so callers call
    this only once ``found`` holds, and a failed allocation changes
    nothing (the Lamport bump included)."""
    curr_prev, curr = prev_idx, next_idx(h, prev_idx)
    steps = 0
    while (int(h.ts[curr]) >= comp_ts and int(h.key[curr]) != ST_KEY
           and steps < cfg.max_scan):
        curr_prev, curr = curr, next_idx(h, curr)
        steps += 1

    new_idx, ok = alloc_node(h)
    if ok:
        prev_mark = int(h.nxt[curr_prev]) & refs.MARK_BIT
        h.put("key", new_idx, key)
        h.put("ts", new_idx, item_ts)
        h.put("sid", new_idx, item_sid)
        h.put("ctr", new_idx, int(h.ctr[curr_prev]))
        h.put("newloc", new_idx, refs.NULL_REF)
        h.put("keymax", new_idx, value)
        h.put("nxt", new_idx,
              refs.with_mark(refs.make_ref(me, curr), bool(is_marked)))
        # Line 260: preserve currPrev's own deletion mark when relinking
        h.put("nxt", curr_prev, refs.make_ref(me, new_idx) | prev_mark)
        lamport(h, item_ts)
    return new_idx, ok


def switch_next_st(h, me: int, keymin: int, new_sh: int) -> bool:
    """switchNextST (Lines 297-302) on the local shard. Returns whether
    the SubTail was repointed."""
    left = cover(h, keymin)
    lidx = max(left, 0)
    owner_ok = left >= 0 and refs.ref_sid(int(h.r_subhead[lidx])) == me
    st_idx = clip(refs.ref_idx(int(h.r_subtail[lidx])), h.n)
    slot = int(h.ctr[st_idx])
    add_at(h, "stct", slot, 1, owner_ok)
    live = owner_ok and rd(h.stct, slot) >= 0
    set_at(h, "nxt", st_idx, new_sh, live)
    add_at(h, "endct", slot, 1, live)
    return live
