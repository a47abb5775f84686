"""Shared host-side helpers for the background engine: registry lookups
and node allocation. They work on a ``HostShard``
(``core/host.py``), the serial pass's working copy of a shard."""
from __future__ import annotations

from .. import registry as reg_ops


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
