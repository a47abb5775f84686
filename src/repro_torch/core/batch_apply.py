"""Unified batched pre-pass: answer a round's eligible FINDs and *apply*
its eligible INSERT/REMOVE rows in one vectorized sweep on the device
(DESIGN.md §4/§4b).

  1. one vectorized registry binary search over all op keys
     (``ops.resolve_route``),
  2. with ``block_probe``, the packed-block ``hybrid_search`` kernel, then
     one bounded lock-step walk (``traverse.probe_batch``) of the lanes the
     kernel did not answer, giving each lane's presence and Harris window
     ``(left, right)``,
  3. a same-key group fold: lanes sorted by (key, row order), a segmented
     scan replays each key group's serial semantics,
  4. a conflict screen bouncing every group the static schedule cannot
     guarantee (incomplete groups, shared link words, dirty walks, pool
     pressure),
  5. one scatter-based apply of each surviving group's net effect.

The commute argument and the bounce taxonomy are the reference's
(``src/repro/core/batch_apply.py``). Port notes: ``associative_scan``
becomes a Hillis–Steele log-step scan, ``lexsort`` two stable sorts,
``segment_*`` ``scatter_reduce``/``index_add_`` on int32 (exact in any
order), and the ``mode="drop"`` scatters masked writes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import timing
from . import blocks as BL
from . import messages as M
from . import refs
from .ops import pool_slot, resolve_route
from .traverse import probe_batch
from .types import (DiLiConfig, OP_FIND, OP_INSERT, OP_REMOVE, RES_FALSE,
                    RES_TRUE, ShardState)

# message kinds that cannot invalidate a round-start read or mutation
# window (see the reference)
_BENIGN_KINDS = (M.MSG_NONE, M.MSG_RESULT, M.MSG_OP, M.MSG_RANGE,
                 M.MSG_RANGE_ITEM)

_I32 = torch.int32
_IMAX = torch.iinfo(torch.int32).max
_IMIN = torch.iinfo(torch.int32).min


class PreOut(NamedTuple):
    state: ShardState        # post-apply state (== input when no mut ran)
    find_elig: torch.Tensor  # bool[R] — FIND answered here
    mut_elig: torch.Tensor   # bool[R] — INSERT/REMOVE applied here
    res: torch.Tensor        # int32[R] (valid where find_elig | mut_elig)
    blk_hits: torch.Tensor   # int32 — eligible lanes answered by the kernel


def _count_eq(sorted_keys, query):
    """Occurrences of each ``query`` value in ``sorted_keys``."""
    return (torch.searchsorted(sorted_keys, query, side="right",
                               out_int32=True)
            - torch.searchsorted(sorted_keys, query, side="left",
                                 out_int32=True))


def _seg(vals, seg, k, reduce):
    """jax.ops.segment_{min,max} over ``k`` segments; an empty segment
    holds the reduction's identity, as in JAX."""
    init = _IMAX if reduce == "amin" else _IMIN
    out = torch.full((k,), init, dtype=_I32, device=vals.device)
    return out.scatter_reduce(0, seg, vals.to(_I32), reduce=reduce,
                              include_self=True)


def _seg_sum(vals, seg, k):
    out = torch.zeros((k,), dtype=_I32, device=vals.device)
    return out.index_add_(0, seg, vals.to(_I32))


def batched_alloc(state: ShardState, want):
    """Vectorized node allocation over a boolean lane mask: free-list pops
    first, then bump — the exact policy of the serial allocator. Returns
    ``(new_idx, rank, n_ins, free_top2, alloc_top2)``."""
    cap = state.pool.key.shape[0]
    rank = torch.cumsum(want.to(_I32), 0).to(_I32) - 1
    n_ins = want.to(_I32).sum().to(_I32)
    from_free = rank < state.free_top
    free_pos = (state.free_top - 1 - rank).clamp(
        0, state.free_list.shape[0] - 1)
    new_idx = torch.where(from_free, state.free_list[free_pos],
                          state.alloc_top + (rank - state.free_top))
    new_idx = new_idx.clamp(0, cap - 1)
    free_top2 = state.free_top - torch.minimum(n_ins, state.free_top)
    alloc_top2 = state.alloc_top + (n_ins - state.free_top).clamp(min=0)
    return new_idx, rank, n_ins, free_top2, alloc_top2


def _seg_last_nonzero(start, code):
    """Segmented inclusive scan of 'last nonzero code so far', as a
    Hillis–Steele log-step scan of the reference's associative operator
    ``(ra | rb, vb if (rb or vb != 0) else va)``."""
    r, v = start.clone(), code.clone()
    k = r.shape[0]
    d = 1
    while d < k:
        ra, va, rb, vb = r[:-d], v[:-d], r[d:], v[d:]
        nr, nv = r.clone(), v.clone()
        nr[d:] = ra | rb
        nv[d:] = torch.where(rb | (vb != 0), vb, va)
        r, v = nr, nv
        d *= 2
    return v


def _gate(rows_np: np.ndarray, me: int, cfg: DiLiConfig, run_find: bool,
          run_mut: bool) -> bool:
    """Whether the pre-pass runs this round — read from the host copy of
    the rows (the reference's ``lax.cond`` predicate)."""
    kind = rows_np[:, M.F_KIND]
    op = rows_np[:, M.F_A]
    round_ok = bool(np.isin(kind, _BENIGN_KINDS).all())
    local = (kind == M.MSG_OP) & (rows_np[:, M.F_SID] == me) & round_ok
    gate = False
    if run_find:
        gate |= int((local & (op == OP_FIND)).sum()) >= max(
            1, cfg.fast_min_batch)
    if run_mut:
        gate |= int((local & ((op == OP_INSERT) | (op == OP_REMOVE))).sum()
                    ) >= max(1, cfg.mut_min_batch)
    return gate


def round_prepass(state: ShardState, rows, rows_np, me, cfg: DiLiConfig,
                  *, run_find: bool, run_mut: bool, timer=None) -> PreOut:
    """Classify + answer/apply the round's eligible rows. ``rows`` is the
    round's full [R, FIELDS] block on the device and ``rows_np`` its host
    copy. ``state`` is the round's private copy and is updated in place."""
    dev = rows.device
    kind = rows[:, M.F_KIND]
    op = rows[:, M.F_A]
    key = rows[:, M.F_KEY].contiguous()
    n = key.shape[0]
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    zi = torch.zeros((n,), dtype=_I32, device=dev)
    z0 = torch.zeros((), dtype=_I32, device=dev)
    if not (run_find or run_mut) or \
            not _gate(rows_np, me, cfg, run_find, run_mut):
        return PreOut(state, zb, zb, zi, z0)

    is_op = kind == M.MSG_OP
    round_ok = bool(np.isin(rows_np[:, M.F_KIND], _BENIGN_KINDS).all())
    is_find = is_op & (op == OP_FIND)
    is_mut = is_op & ((op == OP_INSERT) | (op == OP_REMOVE))
    is_fir = is_find | is_mut
    local_client = rows[:, M.F_SID] == me
    bound = min(cfg.fast_scan_bound, cfg.max_scan)

    rt = resolve_route(state, key, rows[:, M.F_REF1], me)
    routed = ~rt.no_route & (rt.owner == me) & ~rt.head_moved
    side_on = (is_find if run_find else zb) | (is_mut if run_mut else zb)
    cand = side_on & local_client & routed & round_ok

    # compact candidates into k lanes before sweeping; overflow lanes
    # bounce to the serial path (their whole key group with them)
    k = min(n, max(2 * cfg.batch_size, 64))
    ar = torch.arange(n, dtype=_I32, device=dev)
    sel = torch.argsort((~cand).to(_I32) * n + ar, stable=True)[:k]
    cand_k = cand[sel]
    key_k = key[sel]
    op_k = op[sel]
    ent_k = rt.entry[sel]
    t = timing.tracer(timer)

    # packed-block stage-2 probe (DESIGN.md §12), ahead of the walk: lanes
    # whose entry has a valid block are answered by the hybrid-search
    # kernel's window and skip the walk
    use_blk = torch.zeros((k,), dtype=torch.bool, device=dev)
    if cfg.block_probe:
        with t("hybrid_search"):
            b = BL.probe_blocks(state, ent_k, rt.sh_ref[sel], key_k, me, cfg)
        b_ok, b_present, b_left, b_right = b
        use_blk = cand_k & b_ok
    with t("probe_batch"):
        pr = probe_batch(state, rt.head_idx[sel], key_k, me, bound,
                         start_done=use_blk)
    if cfg.block_probe:
        pr = pr._replace(present=torch.where(use_blk, b_present, pr.present),
                         left=torch.where(use_blk, b_left, pr.left),
                         right=torch.where(use_blk, b_right, pr.right))

    pool = state.pool
    cap = pool.key.shape[0]
    nc = state.stct.shape[0]
    left = pool_slot(state, pr.left)
    right = pool_slot(state, pr.right)

    # whole-group check: every op row of this key must be a selected
    # candidate lane (padding lanes hold INT32_MAX, never a valid key)
    cnt_all = _count_eq(torch.sort(torch.where(is_fir, key, _IMAX)).values,
                        key_k)
    cnt_sel = _count_eq(torch.sort(torch.where(cand_k, key_k, _IMAX)).values,
                        key_k)
    whole = cnt_sel == cnt_all

    if not run_mut:
        # read-only side: eligibility is per lane
        elig_k = cand_k & pr.ok & whole
        res_k = torch.where(pr.present, RES_TRUE, RES_FALSE).to(_I32)
        felig = zb.clone()
        felig[sel] = elig_k
        res = zi.clone()
        res[sel] = res_k
        return PreOut(state, felig, zb, res,
                      (elig_k & use_blk).to(_I32).sum().to(_I32))

    # ---- group fold: sort lanes by (key, original row position)
    fold_key = torch.where(cand_k, key_k, _IMAX)
    o1 = torch.argsort(sel, stable=True)
    s2 = o1[torch.argsort(fold_key[o1], stable=True)]
    kf = fold_key[s2]
    start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       kf[1:] != kf[:-1]])
    sid_g = (torch.cumsum(start.to(_I32), 0) - 1).long()   # segment ids
    candf = cand_k[s2]
    opf = op_k[s2]
    okf = ~candf | pr.ok[s2]
    p0f = pr.present[s2]
    is_insf = candf & (opf == OP_INSERT)
    is_remf = candf & (opf == OP_REMOVE)

    # presence evolves as 'last membership-setting op wins'
    code = torch.where(is_insf, 2, torch.where(is_remf, 1, 0)).to(_I32)
    last = _seg_last_nonzero(start, code)
    paft = torch.where(last == 2, True, torch.where(last == 1, False, p0f))
    pbef = torch.where(start, p0f, torch.cat([p0f[:1], paft[:-1]]))

    fired = (is_insf & ~pbef) | (is_remf & pbef)
    resf = torch.where(is_insf, ~pbef, pbef)

    # ---- per-group (segment) aggregates
    pos = torch.arange(k, dtype=_I32, device=dev)
    lead = _seg(pos, sid_g, k, "amin").clamp(0, k - 1).long()
    lastp = _seg(pos, sid_g, k, "amax").clamp(0, k - 1).long()
    seg_has = _seg(candf, sid_g, k, "amax") > 0
    clean = _seg(okf, sid_g, k, "amin") > 0
    any_fired = _seg(fired, sid_g, k, "amax") > 0
    n_fired = _seg_sum(fired, sid_g, k)
    jstar = _seg(torch.where(fired & is_insf, pos, -1), sid_g, k, "amax")

    p0_g = p0f[lead]
    pend_g = paft[lastp]
    whole_g = whole[s2][lead]
    left_g = left[s2][lead]
    right_g = right[s2][lead]

    does_mark = seg_has & p0_g & any_fired
    does_ins = seg_has & pend_g & ~(p0_g & ~any_fired)

    # left-node screen: a SubHead left was never inspected by the probe
    left_nxt = pool.nxt[left_g]
    left_newloc = pool.newloc[left_g]
    left_ctr = pool.ctr[left_g]
    left_bad = refs.ref_mark(left_nxt) | ~refs.is_null(left_newloc) \
        | (state.stct[left_ctr.clamp(0, nc - 1)] < 0)
    elig_g = seg_has & clean & whole_g & (~does_ins | ~left_bad)

    # shared-link-word screen: two groups claiming one nxt word bounce
    does_mark = does_mark & elig_g
    does_ins = does_ins & elig_g
    dummies = cap + torch.arange(2 * k, dtype=_I32, device=dev)
    claim = torch.cat([torch.where(does_ins, left_g, dummies[:k]),
                       torch.where(does_mark, right_g, dummies[k:])])
    shared2 = _count_eq(torch.sort(claim).values, claim) >= 2
    racing = shared2[:k] | shared2[k:]
    elig_g = elig_g & ~racing
    does_mark = does_mark & ~racing
    does_ins = does_ins & ~racing

    # allocator-pressure screen (whole batch)
    n_ins0 = does_ins.to(_I32).sum()
    room = state.free_top + (cap - state.alloc_top)
    alloc_ok = (n_ins0 + cfg.mut_alloc_headroom) <= room
    elig_g = elig_g & alloc_ok
    does_mark = does_mark & alloc_ok
    does_ins = does_ins & alloc_ok

    new_idx, rank, n_ins, free_top2, alloc_top2 = batched_alloc(
        state, does_ins)
    # block Lamport bump (DESIGN.md §4b/§8)
    new_ts = state.ts_clock + rank
    clock2 = state.ts_clock + n_ins

    # ---- one masked scatter per column (in-bounds targets are distinct
    # by the screens above, so write order within a scatter is moot).
    # Every value is read before the first write, as in the reference.
    key_g = key_k[s2][lead]
    val_g = rows[:, M.F_VAL][sel][s2][jstar.clamp(0, k - 1).long()]
    right_nxt = pool.nxt[right_g]
    gi = does_ins.nonzero().squeeze(1)      # groups that insert
    gm = does_mark.nonzero().squeeze(1)     # groups that mark
    timing.crossed(gi, 2, nbytes=8)         # each nonzero reads its count
    ins_at = new_idx[gi].long()
    pool.key[ins_at] = key_g[gi]
    pool.ts[ins_at] = new_ts[gi]
    pool.sid[ins_at] = me
    pool.ctr[ins_at] = left_ctr[gi]
    pool.newloc[ins_at] = left_newloc[gi]
    pool.keymax[ins_at] = val_g[gi]
    pool.nxt[ins_at] = refs.make_ref(me, right_g[gi])
    pool.nxt[left_g[gi].long()] = refs.make_ref(me, new_idx[gi]) \
        | (left_nxt[gi] & refs.MARK_BIT)
    pool.nxt[right_g[gm].long()] = refs.with_mark(right_nxt[gm])

    # counter batch increments: stCt++ and endCt++ per fired mutation
    w = elig_g & (n_fired > 0)
    slot = torch.where(w, left_ctr.clamp(0, nc - 1), 0).long()
    bump = _seg_sum(torch.where(w, n_fired, 0), slot, nc)
    state.stct.add_(bump)
    state.endct.add_(bump)

    # packed-block invalidation (DESIGN.md §12): a group that changed its
    # chain dirties its entry's row; an unattributable one drops all rows
    ent_lead = ent_k[s2][lead]
    chain_mut = does_ins | does_mark
    mblk = state.blk.valid.shape[0]
    dirty = torch.zeros((mblk + 1,), dtype=torch.bool, device=dev)
    dirty[torch.where(chain_mut & (ent_lead >= 0), ent_lead, mblk).long()] \
        = True
    state.blk.valid.logical_and_(~dirty[:mblk])
    state.blk.valid.logical_and_(~(chain_mut & (ent_lead < 0)).any())

    st2 = state._replace(free_top=free_top2, alloc_top=alloc_top2,
                         ts_clock=clock2)

    # ---- scatter lane verdicts back to rows
    eligf = candf & elig_g[sid_g]
    elig_k = torch.zeros((k,), dtype=torch.bool, device=dev)
    elig_k[s2] = eligf
    res_k = torch.zeros((k,), dtype=_I32, device=dev)
    res_k[s2] = torch.where(resf, RES_TRUE, RES_FALSE).to(_I32)
    is_find_k = op_k == OP_FIND
    felig = zb.clone()
    felig[sel] = elig_k & is_find_k
    melig = zb.clone()
    melig[sel] = elig_k & ~is_find_k
    res = zi.clone()
    res[sel] = res_k
    hits = (elig_k & use_blk).to(_I32).sum().to(_I32)
    return PreOut(state=st2, find_elig=felig, mut_elig=melig, res=res,
                  blk_hits=hits)
