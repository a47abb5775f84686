"""Packed-block sublists (DESIGN.md §12): maintain and probe the ``Blocks``
mirror — each owned registry entry's live chain keys as one contiguous,
sorted ``int32[C]`` row — so the stage-2 probe of the batched fast-paths
runs as the ``hybrid_search`` kernel instead of ``probe_batch``'s pointer
walk.

The mirror is a cache with detectable staleness, never a source of truth:
``refresh_blocks`` rebuilds dirty owned rows at round start (a row
validates only when its walk saw exclusively local, non-moving,
non-switched nodes, at most C live keys, and ended at the entry's
registered unmarked SubTail), and writers clear valid bits.

The reference's "aim past the end" writes (``mode="drop"``) become masked
writes here: torch raises on an out-of-range index.
"""
from __future__ import annotations

import torch

from .. import timing
from . import refs
from ..kernels import ops as K
from .types import Blocks, DiLiConfig, SH_KEY, ST_KEY, ShardState


def invalidate_entry(blk: Blocks, e, when=True) -> Blocks:
    """Clear entry ``e``'s valid bit where ``when`` holds and ``e`` is a
    real entry (the reference drops the write when e is out of range)."""
    m = blk.valid.shape[0]
    e = torch.as_tensor(e, dtype=torch.int64, device=blk.valid.device)
    hit = torch.as_tensor(when, device=blk.valid.device) & (e >= 0) & (e < m)
    valid = blk.valid.clone()
    valid[e.clamp(0, m - 1)[hit]] = False
    return blk._replace(valid=valid)


def refresh_blocks(state: ShardState, me, cfg: DiLiConfig) -> ShardState:
    """Rebuild every dirty, owned, live registry entry's packed block.

    One lock-step walk over all M entries with a per-row write cursor:
    live keys land at their cursor column, marked tombstones and in-chain
    SubHeads are stepped over. The walk ends when no row is still
    collecting, read on the host once per step.
    """
    pool = state.pool
    reg = state.registry
    blk = state.blk
    m = reg.keymin.shape[0]
    c = cfg.block_cap
    n = pool.key.shape[0]
    nc = state.stct.shape[0]
    dev = pool.key.device

    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    sh = reg.subhead
    head_idx = refs.ref_idx(sh).clamp(0, n - 1)
    slot = reg.ctr.clamp(0, nc - 1)
    live = (eidx < reg.size) & ~refs.is_null(sh) & \
        (refs.ref_sid(sh) == me) & (state.stct[slot] >= 0) & \
        refs.is_null(pool.newloc[head_idx])
    need = live & ~blk.valid

    # one spare column takes the writes the reference drops (col == C), so
    # the per-step scatter needs no host-side mask
    keys = torch.full((m, c + 1), ST_KEY, dtype=torch.int32, device=dev)
    idxs = torch.zeros((m, c + 1), dtype=torch.int32, device=dev)
    keys[:, :c] = torch.where(need[:, None], ST_KEY, blk.keys)
    idxs[:, :c] = torch.where(need[:, None], 0, blk.idx)
    st_ref = refs.unmarked(reg.subtail)
    rows_ = torch.arange(m, dtype=torch.int64, device=dev)
    col = torch.zeros((m,), dtype=torch.int32, device=dev)
    cur = pool.nxt[head_idx]
    collecting = need
    good = torch.zeros((m,), dtype=torch.bool, device=dev)

    # chain steps, not live keys: tombstones stretch the walk past C
    i = 0
    while i < cfg.max_scan and bool(collecting.any()):
        ci = refs.ref_idx(cur).clamp(0, n - 1)
        local = refs.ref_sid(cur) == me
        word = pool.nxt[ci]
        marked = refs.ref_mark(word)
        moving = ~refs.is_null(pool.newloc[ci])
        switched = state.stct[pool.ctr[ci].clamp(0, nc - 1)] < 0
        k = pool.key[ci]
        at_st = k == ST_KEY
        # the terminating ST must be the *registered* subtail, unmarked
        reach_ok = at_st & ~marked & (refs.unmarked(cur) == st_ref)
        # marked non-ST nodes and in-chain SubHeads are logically absent
        hop = (k == SH_KEY) | (marked & ~at_st)
        want_write = ~at_st & ~hop
        bad = ~local | refs.is_null(cur) | moving | switched \
            | (at_st & ~reach_ok) | (want_write & (col >= c))
        write = collecting & ~bad & want_write

        at_col = torch.where(write, col, c).long()
        keys[rows_, at_col] = k
        idxs[rows_, at_col] = ci
        good = good | (collecting & reach_ok)
        collecting = collecting & ~bad & ~reach_ok
        col = col + write.to(torch.int32)
        cur = torch.where(collecting, word, cur)
        i += 1
    # the loop's test is read on the host each time it runs, a byte a read
    reads = i + (i < cfg.max_scan)
    timing.count("refresh_steps", i)
    timing.crossed(collecting, reads, nbytes=reads)
    # rows still collecting at the bound never reached their subtail
    valid = (blk.valid | good) & live
    return state._replace(blk=Blocks(keys=keys[:, :c].contiguous(),
                                     idx=idxs[:, :c].contiguous(),
                                     valid=valid))


def probe_blocks(state: ShardState, entry, sh_ref, q, me, cfg: DiLiConfig):
    """Answer probe lanes from valid packed blocks via the hybrid-search
    kernel. Returns ``(usable, present, left, right)`` — the same Harris
    window ``probe_batch`` would return; lanes that are not ``usable``
    carry no information and bounce."""
    reg = state.registry
    blk = state.blk
    pool = state.pool
    m, c = blk.keys.shape
    n = pool.key.shape[0]

    e = entry.clamp(0, m - 1)
    usable = (entry >= 0) & blk.valid[e] & \
        (refs.unmarked(sh_ref) == refs.unmarked(reg.subhead[e])) & \
        (q > SH_KEY) & (q < ST_KEY)

    slot, found = K.hybrid_search(reg.keymin, blk.keys, q.contiguous())
    # decode against OUR entry, never slot // C: a full block with every
    # key < q answers pos == C, where slot aliases (entry+1)*C
    pos = slot - e * c
    usable = usable & (pos >= 0) & (pos <= c)

    posc = pos.clamp(0, c - 1)
    past = (pos >= c) | (blk.keys[e, posc] == ST_KEY)
    st_idx = refs.ref_idx(reg.subtail[e]).clamp(0, n - 1)
    right = torch.where(past, st_idx, blk.idx[e, posc])
    hd = refs.ref_idx(reg.subhead[e]).clamp(0, n - 1)
    left = torch.where(pos == 0, hd, blk.idx[e, (pos - 1).clamp(0, c - 1)])
    return usable, found, left, right
