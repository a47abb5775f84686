"""Plain PyTorch versions of the port's kernels (the CPU path and the
yardstick of correctness on the card)."""
from __future__ import annotations

import torch


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
