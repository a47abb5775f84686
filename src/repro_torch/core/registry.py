"""Registry operations (paper Algorithm 6) over tensors.

Entries are sorted by keymin; empty slots hold keymin == ST_KEY so the live
prefix [0, size) stays sorted and padding sorts last. ``add_entry`` /
``remove_entry`` / ``set_fields`` return new Registry tuples (copy on
write, as in the reference) and work on any device; ``get_by_key`` is the
vectorized binary search of the pre-passes. ``lookup`` is its scalar twin
over numpy columns, for the host-side serial pass.
"""
from __future__ import annotations

import numpy as np
import torch

from . import refs
from .types import Registry, ST_KEY


def get_by_key(reg: Registry, key):
    """Index of the entry whose (keymin, keymax] contains ``key``, or -1.

    An entry covers keys strictly greater than its keymin and up to
    (inclusive) its keymax. Vectorizes over an int32 ``key`` tensor.
    """
    key = torch.as_tensor(key, dtype=torch.int32,
                          device=reg.keymin.device).contiguous()
    m = reg.keymin.shape[0]
    i = torch.searchsorted(reg.keymin, key, side="left",
                           out_int32=True) - 1
    i = i.clamp(0, m - 1)
    ok = (key > reg.keymin[i]) & (key <= reg.keymax[i]) & (i < reg.size)
    return torch.where(ok, i, -1)


def lookup(keymin: np.ndarray, keymax: np.ndarray, size: int, key: int) -> int:
    """Scalar ``get_by_key`` over host numpy columns."""
    m = keymin.shape[0]
    i = int(np.searchsorted(keymin, key, side="left")) - 1
    i = min(max(i, 0), m - 1)
    if key > keymin[i] and key <= keymax[i] and i < size:
        return i
    return -1


def add_entry(reg: Registry, keymin, keymax, subhead, subtail, ctr,
              offset) -> Registry:
    """COW sorted insert of a new sublist entry (Algorithm 6 addEntry)."""
    m = reg.keymin.shape[0]
    dev = reg.keymin.device
    kmin = torch.as_tensor(keymin, dtype=torch.int32, device=dev).reshape(1)
    pos = torch.searchsorted(reg.keymin, kmin, side="left", out_int32=True)
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    take = torch.where(idx < pos, idx, idx - 1).clamp(0, m - 1)

    def shift(col, newval):
        shifted = torch.where(idx < pos, col, col[take])
        return torch.where(idx == pos,
                           torch.as_tensor(newval, dtype=col.dtype,
                                           device=dev), shifted)

    return Registry(
        keymin=shift(reg.keymin, keymin),
        keymax=shift(reg.keymax, keymax),
        subhead=shift(reg.subhead, subhead),
        subtail=shift(reg.subtail, subtail),
        ctr=shift(reg.ctr, ctr),
        offset=shift(reg.offset, offset),
        size=reg.size + 1,
    )


def remove_entry(reg: Registry, pos) -> Registry:
    """COW delete of entry ``pos`` (used by Merge)."""
    m = reg.keymin.shape[0]
    dev = reg.keymin.device
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    take = torch.where(idx >= pos, idx + 1, idx).clamp(0, m - 1)

    def shift(col, pad):
        out = torch.where(idx >= pos, col[take], col)
        out[m - 1] = pad
        return out

    return Registry(
        keymin=shift(reg.keymin, ST_KEY),
        keymax=shift(reg.keymax, ST_KEY),
        subhead=shift(reg.subhead, refs.NULL_REF),
        subtail=shift(reg.subtail, refs.NULL_REF),
        ctr=shift(reg.ctr, 0),
        offset=shift(reg.offset, 0),
        size=reg.size - 1,
    )


def set_fields(reg: Registry, pos, *, keymax=None, subhead=None,
               subtail=None, ctr=None, offset=None) -> Registry:
    """Point updates to one entry (Split truncation, Switch subhead flip)."""
    upd = {}
    for name, val in (("keymax", keymax), ("subhead", subhead),
                      ("subtail", subtail), ("ctr", ctr),
                      ("offset", offset)):
        if val is not None:
            col = getattr(reg, name).clone()
            col[pos] = val
            upd[name] = col
    return reg._replace(**upd)
