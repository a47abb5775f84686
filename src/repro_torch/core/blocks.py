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

    Each dirty row walks its chain from its SubHead with a write cursor:
    live keys land at their cursor column, marked tombstones and in-chain
    SubHeads are stepped over (``kernels.ops.refresh_walk``: on the card
    one launch of ``csrc/refresh_walk.cu`` that the host never waits for;
    on the CPU the reference's lock-step loop). The longest walk's steps
    (``refresh_steps``) cost a read of the card, so they are read only
    while a ``timing.PhaseTimer`` span is open.
    """
    pool, reg, blk = state.pool, state.registry, state.blk
    keys, idx, valid, steps = K.refresh_walk(
        pool.key, pool.nxt, pool.ctr, pool.newloc, state.stct, reg.subhead,
        reg.subtail, reg.ctr, reg.size, blk.keys, blk.idx, blk.valid, me,
        cfg.max_scan)
    if timing.counting():
        longest = steps.max()
        timing.crossed(longest)
        timing.count("refresh_steps", int(longest))
    return state._replace(blk=Blocks(keys=keys, idx=idx, valid=valid))


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
