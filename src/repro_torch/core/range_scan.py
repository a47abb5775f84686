"""RANGE(lo, hi, limit) — ordered scans over the distributed list
(DESIGN.md §16).

A scan is a travelling cursor: an ``MSG_RANGE`` row carries the inclusive
low end of the *remaining* span (F_KEY), the exclusive high end (F_X1),
the remaining item budget (F_X3) and the count emitted so far (F_X4).
Each shard that receives the cursor serves the one registry entry covering
the cursor, emits ``MSG_RANGE_ITEM`` rows to the reply shard, and either
forwards a narrowed cursor to the next entry's owner or terminates with a
plain ``MSG_RESULT`` whose F_A is the total item count.

Two serving paths, as in the reference:

  * ``range_prepass`` — on the device, at round start: cursors whose
    covering entry has a valid packed block (DESIGN.md §12) are answered
    with one masked gather over the block row; the rows it emits come to
    the host in one copy.
  * ``h_range`` — the serial chain walk on the round's host working copy
    (``core/host.py``), the fallback for dirty or moving entries. The
    reference's bounded ``lax.while_loop`` is a host loop here.

Message fields are int32 lanes; every sum that can leave the int32 range
wraps as the reference's int32 arithmetic does (``_i32``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import messages as M
from . import refs
from . import registry as reg_ops
from .ops import RES_OVERFLOW, pool_slot
from .types import DiLiConfig, SH_KEY, ST_KEY, ShardState

# walk outcome codes
_D_NONE = 0   # still walking
_D_TERM = 1   # span complete — emit terminal result
_D_CONT = 2   # segment done / bounced — re-issue narrowed cursor
_D_OVER = 3   # traversal bound hit with no progress — error result


def _i32(x: int) -> int:
    """Wrap a Python int to int32 two's complement."""
    return ((int(x) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def make_range_row(shard: int, lo: int, hi: int, limit: int,
                   slot: int) -> np.ndarray:
    """Host-side builder for a fresh RANGE cursor row."""
    row = np.zeros((M.FIELDS,), np.int32)
    row[M.F_KIND] = M.MSG_RANGE
    row[M.F_DST] = shard
    row[M.F_SRC] = shard
    row[M.F_KEY] = lo
    row[M.F_X1] = hi
    row[M.F_X3] = limit
    row[M.F_X4] = 0
    row[M.F_SID] = shard   # reply shard = submission shard
    row[M.F_TS] = slot
    return row


def _item_row(me: int, reply: int, slot: int, key: int, val: int):
    return M.make_row(M.MSG_RANGE_ITEM, reply, me, key=key, val=val,
                      ts=slot)


def h_range(h, hb, me: int, row, outbox, count, cfg: DiLiConfig):
    """Serial RANGE segment serve on the host copy ``h`` — read-only.
    Collects up to ``range_batch`` in-span live keys from the covering
    entry's chain; any dirty node bounces the remainder. Returns the
    handler triple ``(completion, outbox, count)``."""
    cursor = int(row[M.F_KEY])
    hi = int(row[M.F_X1])
    remaining = int(row[M.F_X3])
    emitted = int(row[M.F_X4])
    reply = int(row[M.F_SID])
    slot = int(row[M.F_TS])
    hops = int(row[M.F_X2])
    n, nc, m = h.n, h.n_ctrs, h.m
    batch = int(cfg.range_batch)

    def clip(x, top):
        return min(max(int(x), 0), top - 1)

    span_empty = cursor >= hi or remaining <= 0
    entry = reg_ops.lookup(h.r_keymin, h.r_keymax, h.size, cursor)
    e = clip(entry, m)
    sh_ref = refs.unmarked(int(h.r_subhead[e]))
    owner = refs.ref_sid(sh_ref)
    head_idx = clip(refs.ref_idx(sh_ref), n)
    head_ctr = clip(h.ctr[head_idx], nc)
    head_moved = owner == me and int(h.stct[head_ctr]) < 0
    head_newloc = refs.unmarked(int(h.newloc[head_idx]))

    no_route = (not span_empty) and entry < 0
    deleg = (not span_empty) and entry >= 0 and (owner != me or head_moved)
    deleg_dst = owner if owner != me else refs.ref_sid(head_newloc)
    serve = (not span_empty) and entry >= 0 and not deleg

    # ------------------------------------------------ bounded chain walk
    take = min(batch, remaining)
    keys = [ST_KEY] * batch
    vals = [0] * batch
    got = 0
    code = _D_NONE if serve else _D_TERM
    nxt_cur = cursor
    cur = refs.make_ref(me, head_idx)
    hi1 = _i32(hi - 1)

    def last_key():
        return keys[clip(got - 1, batch)] if got > 0 else _i32(cursor - 1)

    i = 0
    while code == _D_NONE and i < cfg.max_scan:
        ci = clip(refs.ref_idx(cur), n)
        word = int(h.nxt[ci])
        marked = refs.ref_mark(word)
        moving = not refs.is_null(int(h.newloc[ci]))
        switched = int(h.stct[clip(h.ctr[ci], nc)]) < 0
        k = int(h.key[ci])
        kmax = int(h.keymax[ci])
        is_sh = k == SH_KEY
        is_st = k == ST_KEY
        # dirty node → bounce: re-issue the cursor past the last emitted
        # key (or unchanged when nothing was emitted yet). A marked ST is
        # a merge-neutralized subtail mid-restructure — bounce too.
        bad = (refs.ref_sid(cur) != me or refs.is_null(cur) or moving
               or switched or (is_st and marked))
        st_stop = not bad and is_st
        st_covers = st_stop and kmax >= hi1
        plain = not bad and not is_sh and not is_st
        past = plain and k >= hi
        in_span = plain and not marked and cursor <= k < hi
        trunc = in_span and got >= take
        coll = in_span and got < take
        if bad:
            code, nxt_cur = _D_CONT, _i32(last_key() + 1)
        elif st_covers or past:
            code = _D_TERM
        elif st_stop:
            code, nxt_cur = _D_CONT, _i32(kmax + 1)
        elif trunc:
            code, nxt_cur = _D_CONT, k
        if coll:
            keys[got], vals[got] = k, kmax
            got += 1
        if code == _D_NONE:
            cur = word
        i += 1

    # bound hit while still walking: progress → continue, else overflow
    if serve and code == _D_NONE:
        nxt_cur = _i32(last_key() + 1)
        code = _D_CONT if got > 0 else _D_OVER
    if not serve:
        got = 0
    total = _i32(emitted + got)
    rem2 = _i32(remaining - got)

    # ------------------------------------------------ emit items
    for j in range(got):
        outbox, count = M.push(outbox, count,
                               _item_row(me, reply, slot, keys[j], vals[j]))

    # ------------------------------------------------ final row
    # terminal when the span is served out or the budget is spent;
    # otherwise forward the (possibly unchanged) cursor — to the next
    # entry's owner on a clean continue, to the delegate on a stale
    # route, to self on a transient registry gap or an interior bounce.
    over = serve and code == _D_OVER
    term = span_empty or (serve and code == _D_TERM) or \
        (serve and code == _D_CONT and rem2 <= 0)
    is_term = term or over
    e2 = reg_ops.lookup(h.r_keymin, h.r_keymax, h.size, nxt_cur)
    dst2 = (refs.ref_sid(refs.unmarked(int(h.r_subhead[clip(e2, m)])))
            if e2 >= 0 else me)
    fwd_dst = deleg_dst if deleg else (me if no_route else dst2)
    final = M.make_row(
        M.MSG_RESULT if is_term else M.MSG_RANGE,
        reply if is_term else fwd_dst, me,
        a=RES_OVERFLOW if over else total,
        key=nxt_cur if serve else cursor, x1=hi, x3=rem2, x4=total,
        sid=reply, ts=slot, x2=_i32(hops + 1))
    outbox, count = M.push(outbox, count, final)
    return (-1, 0, 0, SH_KEY), outbox, count


def h_range_item(h, hb, me: int, row, outbox, count, cfg: DiLiConfig):
    """One scanned pair arriving at the reply shard: echo it onto the
    completion lanes. The completion key carries the real key (> SH_KEY),
    which marks the row as an item rather than a scalar completion."""
    return ((int(row[M.F_TS]), int(row[M.F_VAL]), int(row[M.F_SRC]),
             int(row[M.F_KEY])), outbox, count)


def range_prepass(state: ShardState, rows: torch.Tensor,
                  rows_np: np.ndarray, me: int, outbox, count,
                  cfg: DiLiConfig):
    """Vectorized RANGE segment serve from valid packed blocks.

    Runs at round start, before any mutation, against the snapshot
    ``refresh_blocks`` just validated. Up to ``range_lanes`` MSG_RANGE
    rows whose covering entry has a valid block are each answered with
    one masked gather over the block row (on the device); unservable
    cursors fall through to the serial ``h_range``. Returns
    ``(outbox, count, handled[n_rows] (host bool), hits)``.
    """
    n_rows = rows_np.shape[0]
    cand_np = rows_np[:, M.F_KIND] == M.MSG_RANGE
    if not cand_np.any():
        # nothing to serve: the reference's lanes are all masked off
        return outbox, count, np.zeros((n_rows,), bool), 0
    dev = rows.device
    i32 = torch.int32
    lanes = int(cfg.range_lanes)
    # the first ``lanes`` candidate rows in row order, padded with the
    # first non-candidates (the reference's stable argsort selection)
    sel_np = np.argsort(~cand_np, kind="stable")[:lanes]
    lane_np = cand_np[sel_np]
    nl = sel_np.shape[0]
    sel = torch.from_numpy(sel_np).to(dev)
    lane = torch.from_numpy(lane_np).to(dev)
    r = rows[sel]
    cursor = r[:, M.F_KEY].contiguous()
    hi = r[:, M.F_X1]
    remaining = r[:, M.F_X3]
    emitted = r[:, M.F_X4]
    reply = r[:, M.F_SID]
    slot = r[:, M.F_TS]
    hops = r[:, M.F_X2]

    reg = state.registry
    blk = state.blk
    m, c = blk.keys.shape
    entry = reg_ops.get_by_key(reg, cursor)
    e = entry.clamp(0, m - 1)
    owned = refs.ref_sid(refs.unmarked(reg.subhead[e])) == me
    # a valid block IS the version check: chain entirely local,
    # non-moving, non-switched as of round start (DESIGN.md §12)
    usable = lane & (entry >= 0) & blk.valid[e] & owned \
        & (cursor < hi) & (remaining > 0)

    batch = remaining.clamp(max=int(cfg.range_batch))
    bkeys = blk.keys[e]                                        # [L, C]
    bvals = state.pool.keymax[pool_slot(state, blk.idx[e]).long()]
    in_span = (bkeys != ST_KEY) & (bkeys >= cursor[:, None]) \
        & (bkeys < hi[:, None])
    rank = torch.cumsum(in_span.to(i32), dim=1, dtype=i32) - 1
    take = in_span & (rank < batch[:, None])
    got = take.to(i32).sum(dim=1, dtype=i32)

    # continuation / terminal — one row per served lane
    truncated = in_span.to(i32).sum(dim=1, dtype=i32) > batch
    last_taken = torch.where(take, bkeys,
                             torch.full_like(bkeys, SH_KEY)).amax(dim=1)
    ekmax = reg.keymax[e]
    total = emitted + got
    rem2 = remaining - got
    # (hi - 1 and the +1s wrap in int32 as the reference's arithmetic)
    done = (~truncated & (ekmax >= hi - 1)) | (rem2 <= 0)
    nxt_cur = torch.where(truncated, last_taken + 1, ekmax + 1)
    e2 = reg_ops.get_by_key(reg, nxt_cur)
    dst2 = torch.where(
        e2 >= 0,
        refs.ref_sid(refs.unmarked(reg.subhead[e2.clamp(0, m - 1)])),
        torch.full_like(e2, me))

    # one transfer brings every lane's rows to the host
    items = torch.zeros((nl, c, M.FIELDS), dtype=i32, device=dev)
    items[..., M.F_KIND] = M.MSG_RANGE_ITEM
    items[..., M.F_DST] = reply[:, None]
    items[..., M.F_SRC] = me
    items[..., M.F_KEY] = bkeys
    items[..., M.F_VAL] = bvals
    items[..., M.F_TS] = slot[:, None]
    final = torch.zeros((nl, M.FIELDS), dtype=i32, device=dev)
    final[:, M.F_KIND] = torch.where(done, M.MSG_RESULT, M.MSG_RANGE)
    final[:, M.F_DST] = torch.where(done, reply, dst2)
    final[:, M.F_SRC] = me
    final[:, M.F_A] = torch.where(done, total, 0)
    final[:, M.F_KEY] = nxt_cur
    final[:, M.F_X1] = hi
    final[:, M.F_X3] = rem2
    final[:, M.F_X4] = total
    final[:, M.F_SID] = reply
    final[:, M.F_TS] = slot
    final[:, M.F_X2] = hops + 1
    do_items = usable[:, None] & take
    host = torch.cat([items.reshape(-1), final.reshape(-1),
                      do_items.reshape(-1).to(i32),
                      usable.to(i32)]).cpu().numpy()
    a = nl * c * M.FIELDS
    b = a + nl * M.FIELDS
    items_np = host[:a].reshape(nl * c, M.FIELDS)
    final_np = host[a:b].reshape(nl, M.FIELDS)
    do_np = host[b:b + nl * c].astype(bool)
    usable_np = host[b + nl * c:].astype(bool)
    outbox, count = M.push_many(outbox, count, items_np, do_np)
    outbox, count = M.push_many(outbox, count, final_np, usable_np)

    handled = np.zeros((n_rows,), bool)
    handled[sel_np] = usable_np
    return outbox, count, handled, int(usable_np.sum())
