"""Plain PyTorch versions of the port's kernels (the CPU path and the
yardstick of correctness on the card)."""
from __future__ import annotations

import torch

from ..core import refs
from ..core.types import SH_KEY, ST_KEY


def hybrid_search_ref(keymin, blocks, queries):
    """Plain twin of ``hybrid_search``: searchsorted + row scan.

    Bit-identical to the reference oracle ``repro.kernels.ref``: entry is
    the last i with keymin[i] < q (clamped into [0, M-1]); pos is the first
    index with key >= q, or C when none is (the full-block edge).
    """
    m, c = blocks.shape
    entry = torch.searchsorted(keymin, queries, side="left",
                               out_int32=True) - 1
    entry = entry.clamp(0, m - 1)
    rows = blocks[entry]                       # [B, C]
    eq = rows == queries[:, None]
    ge = rows >= queries[:, None]
    # argmax over an int cast (torch's argmax takes no bool); an all-False
    # row would say 0, so pos = C there
    pos = torch.where(ge.any(dim=1), ge.to(torch.int32).argmax(dim=1),
                      c).to(torch.int32)
    found = eq.any(dim=1)
    return entry * c + pos, found


def paged_attention_ref(q, k_pages, v_pages, page_table, seq_lens, *,
                        page_size: int):
    """Plain twin of ``paged_attention``: dense gather + masked softmax in
    f32, output in ``q``'s dtype (the reference oracle's arithmetic).

    Page ids are clamped into ``[0, P-1]`` as the kernel clamps them; the
    reference's gather clamps too (its callers pass no negative id)."""
    b, h, d = q.shape
    n_pages, s, kh, _ = k_pages.shape
    pp = page_table.shape[1]
    groups = h // kh
    pt = page_table.long().clamp(0, n_pages - 1)
    k = k_pages[pt].reshape(b, pp * s, kh, d).float()
    v = v_pages[pt].reshape(b, pp * s, kh, d).float()
    qg = q.reshape(b, kh, groups, d).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, k) * (d ** -0.5)
    pos = torch.arange(pp * s, device=q.device)[None, None, None, :]
    valid = pos < seq_lens.to(q.device)[:, None, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", w, v)
    return out.reshape(b, h, d).to(q.dtype)


def refresh_walk_ref(key, nxt, ctr, newloc, stct, subhead, subtail, reg_ctr,
                     size, keys, idx, valid, me: int, max_scan: int):
    """Plain twin of ``refresh_walk``: one lock-step walk over all M
    entries with a per-row write cursor, as the reference's
    ``core/blocks.py::refresh_blocks`` writes it. Live keys land at their
    cursor column, marked tombstones and in-chain SubHeads are stepped
    over. The walk ends when no row is still collecting, read on the host
    once per step. ``steps`` counts the steps each row collected."""
    blk_keys, blk_idx, blk_valid = keys, idx, valid
    m, c = blk_keys.shape
    n = key.shape[0]
    nc = stct.shape[0]
    dev = key.device

    eidx = torch.arange(m, dtype=torch.int32, device=dev)
    sh = subhead
    head_idx = refs.ref_idx(sh).clamp(0, n - 1)
    slot = reg_ctr.clamp(0, nc - 1)
    live = (eidx < size) & ~refs.is_null(sh) & \
        (refs.ref_sid(sh) == me) & (stct[slot] >= 0) & \
        refs.is_null(newloc[head_idx])
    need = live & ~blk_valid

    # one spare column takes the writes the reference drops (col == C), so
    # the per-step scatter needs no host-side mask
    keys = torch.full((m, c + 1), ST_KEY, dtype=torch.int32, device=dev)
    idxs = torch.zeros((m, c + 1), dtype=torch.int32, device=dev)
    keys[:, :c] = torch.where(need[:, None], ST_KEY, blk_keys)
    idxs[:, :c] = torch.where(need[:, None], 0, blk_idx)
    st_ref = refs.unmarked(subtail)
    rows_ = torch.arange(m, dtype=torch.int64, device=dev)
    col = torch.zeros((m,), dtype=torch.int32, device=dev)
    cur = nxt[head_idx]
    collecting = need
    good = torch.zeros((m,), dtype=torch.bool, device=dev)
    steps = torch.zeros((m,), dtype=torch.int32, device=dev)

    # chain steps, not live keys: tombstones stretch the walk past C
    i = 0
    while i < max_scan and bool(collecting.any()):
        steps += collecting
        ci = refs.ref_idx(cur).clamp(0, n - 1)
        local = refs.ref_sid(cur) == me
        word = nxt[ci]
        marked = refs.ref_mark(word)
        moving = ~refs.is_null(newloc[ci])
        switched = stct[ctr[ci].clamp(0, nc - 1)] < 0
        k = key[ci]
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
    # rows still collecting at the bound never reached their subtail
    valid = (blk_valid | good) & live
    return (keys[:, :c].contiguous(), idxs[:, :c].contiguous(), valid,
            steps)
