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
