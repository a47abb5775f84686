"""Background message handlers, host side. This slice ports the registry
broadcast a Split sends (``h_reg_split``); the Move/Merge/Switch/replicate
handlers come with the slice that ports those background operations."""
from __future__ import annotations

from .. import messages as M
from .. import refs
from ..registry import add_entry, lookup, set_fields


def h_reg_split(h, hb, me, row, outbox, count, cfg):
    """RegisterSublistRecv (Lines 159-163) at a replica."""
    split_key, keymax = int(row[M.F_KEY]), int(row[M.F_X1])
    sh_ref = int(row[M.F_REF1])
    e = lookup(h.r_keymin, h.r_keymax, h.size, keymax)
    eidx = max(e, 0)
    kmin, kmax = int(h.r_keymin[eidx]), int(h.r_keymax[eidx])
    # exact right-half already present (duplicate) — drop
    dup = e >= 0 and kmin == split_key and kmax == keymax
    # parent entry present: split it
    can = (e >= 0 and not dup and kmin < split_key and kmax == keymax
           and h.size < h.m)
    if can:
        reg = set_fields(h.registry(), eidx, keymax=split_key)
        h.set_registry(add_entry(reg, split_key, keymax, sh_ref,
                                 refs.NULL_REF, 0, 0))
    elif not dup and int(row[M.F_A]) < cfg.max_retries:
        retry = row.copy()
        retry[M.F_A] += 1
        retry[M.F_DST] = me
        outbox, count = M.push(outbox, count, retry)
    return outbox, count
