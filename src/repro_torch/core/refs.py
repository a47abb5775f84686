"""Packed smart references — the paper's §4 'smart pointer', as int32 bit
patterns.

The reference package packs {mark, shard id, node index} into a uint32.
Torch on the CPU has no ``>>``, ``<`` or ``index_put`` for uint32, so the
port keeps the same 32 bits in an int32::

    bit 31      : mark (the sign bit — Harris deletion mark on the *next*
                  pointer), so ``MARK_BIT`` is ``-(2**31)``
    bits 30..22 : shard id (9 bits)
    bits 21..0  : node index into the owner shard's node pool

``ref_sid`` masks after the (arithmetic) shift, so a set sign bit never
leaks into the shard id. Every helper works on Python ints (kept inside
the signed int32 range) and on int32 tensors alike; the bit patterns are
identical to the reference's uint32 values viewed as int32.
"""
from __future__ import annotations

import torch

REF_DTYPE = torch.int32

IDX_BITS = 22
SID_BITS = 9
IDX_MASK = (1 << IDX_BITS) - 1            # 0x003FFFFF
SID_MASK = ((1 << SID_BITS) - 1) << IDX_BITS
MARK_BIT = -(2**31)                       # the sign bit of an int32
UNMARK_MASK = 0x7FFFFFFF

# NULL is all-ones in the index field with shard 0 / no mark.
NULL_IDX = IDX_MASK
NULL_REF = NULL_IDX

MAX_SHARDS = 1 << SID_BITS
POOL_LIMIT = IDX_MASK  # exclusive upper bound on per-shard pool capacity


def make_ref(sid, idx, mark=False):
    """Pack (shard id, index, mark) into an int32 Ref."""
    r = (sid << IDX_BITS) | idx
    if isinstance(mark, bool):
        return r | MARK_BIT if mark else r
    return torch.where(mark, r | MARK_BIT, r)


def ref_idx(ref):
    """Index field (the masked pointer access '→' of the paper)."""
    return ref & IDX_MASK


def ref_sid(ref):
    """Owner shard id — the paper's ``X.id``."""
    return (ref >> IDX_BITS) & ((1 << SID_BITS) - 1)


def ref_mark(ref):
    """Deletion mark — the paper's ``X.mark`` (the sign bit)."""
    return ref < 0


def with_mark(ref, mark=True):
    if isinstance(mark, bool):
        return ref | MARK_BIT if mark else ref & UNMARK_MASK
    return torch.where(mark, ref | MARK_BIT, ref & UNMARK_MASK)


def unmarked(ref):
    """Ref with the mark bit cleared (address+owner only)."""
    return ref & UNMARK_MASK


def is_null(ref):
    return unmarked(ref) == NULL_REF
