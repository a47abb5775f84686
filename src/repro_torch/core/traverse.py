"""Distributed list traversal — the paper's Algorithm 2 ``Search``.

``probe_batch`` is the read-only lock-step walk of the batched pre-passes,
on the device: one vectorized step advances every lane. Its early exit
(stop once no lane is still walking) is read on the host, which costs one
device sync per step; ``probe_batch.steps`` counts the steps taken, and so
does the ``prepass_steps`` counter of the open span (``timing.count``).

``search`` is the serial pass's exact traversal with Harris delinking, on
the host working copy (``core/host.py``).

Status codes:
  * ``S_FOUND``    — right node located (first unmarked node with key' >= key
                     inside the covering sublist, or that sublist's SubTail).
  * ``S_DELEGATE`` — the walk left this shard's ownership (a foreign node, or
                     a moved sublist: stCt < 0 → head.newLoc).
  * ``S_OVERFLOW`` — exceeded cfg.max_scan steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import timing
from . import refs
from .types import DiLiConfig, ShardState, SH_KEY, ST_KEY

S_FOUND = 0
S_DELEGATE = 1
S_OVERFLOW = 2


class ProbeOut(NamedTuple):
    ok: torch.Tensor       # bool[B] — lane terminated cleanly within bound
    present: torch.Tensor  # bool[B] — membership answer (valid where ok)
    left: torch.Tensor     # int32[B] pool idx of the stop node's predecessor
    right: torch.Tensor    # int32[B] pool idx of the stop node


def probe_batch(state: ShardState, head_idx, key, me, bound: int,
                start_done=None) -> ProbeOut:
    """Read-only batched traversal for the batched fast-paths (DESIGN.md
    §4/§4b). A lane is clean only while its walk touches exclusively
    local, unmarked, non-moving, non-switched nodes and terminates within
    ``bound`` steps; ``(left, right)`` is the Harris window it stopped at.
    NB the walk starts at ``head.nxt``: callers re-check a SubHead left.
    Lanes set in the bool mask ``start_done`` are not walked: they come
    back ok, absent, with the window (head, head)."""
    pool = state.pool
    n = pool.key.shape[0]
    nc = state.stct.shape[0]
    head_idx = head_idx.clamp(0, n - 1)
    shape = key.shape
    dev = key.device

    curr = pool.nxt[head_idx]
    prev = head_idx
    right = head_idx
    ok = torch.ones(shape, dtype=torch.bool, device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev) \
        if start_done is None else start_done
    present = torch.zeros(shape, dtype=torch.bool, device=dev)

    # early-exit sweep: the fixed cost is the *longest* live lane
    i = 0
    while i < bound and bool((ok & ~done).any()):
        active = ok & ~done
        idx = refs.ref_idx(curr).clamp(0, n - 1)
        remote = refs.ref_sid(curr) != me
        dead_end = refs.is_null(curr)
        curr_nxt = pool.nxt[idx]
        marked = refs.ref_mark(curr_nxt)
        switched = state.stct[pool.ctr[idx].clamp(0, nc - 1)] < 0
        moving = ~refs.is_null(pool.newloc[idx])
        bad = remote | dead_end | marked | switched | moving

        curr_key = pool.key[idx]
        is_sh = curr_key == SH_KEY
        is_st = curr_key == ST_KEY
        # stop at a covering SubTail or the first node with key' >= key;
        # cross non-covering SubTails into the next sublist
        st_stop = is_st & (key <= pool.keymax[idx])
        ord_stop = ~is_st & ~is_sh & (curr_key >= key)
        stop = (st_stop | ord_stop) & ~bad

        ok = ok & (~active | ~bad)
        hit = active & stop
        present = torch.where(hit, ~is_st & (curr_key == key), present)
        right = torch.where(hit, idx, right)
        done = done | (active & (stop | bad))
        advance = active & ~stop & ~bad
        prev = torch.where(advance, idx, prev)
        curr = torch.where(advance, curr_nxt, curr)
        i += 1
    probe_batch.steps += i
    timing.count("prepass_steps", i)
    reads = i + (i < bound)
    timing.crossed(done, reads, nbytes=reads)
    return ProbeOut(ok=ok & done, present=present, left=prev, right=right)


probe_batch.steps = 0


class SearchOut(NamedTuple):
    status: int
    left: int     # pool index of left node (valid if FOUND)
    right: int    # pool index of right node (valid if FOUND)
    head: int     # pool index of the covering sublist's SubHead
    deleg: int    # Ref to delegate to (valid if DELEGATE)


def search(h, head_idx: int, key: int, me: int, cfg: DiLiConfig) -> SearchOut:
    """Traverse from subhead ``head_idx`` for ``key`` on shard ``me``.

    Writes (through the host copy ``h``) only ``nxt`` (Harris delinks) and
    the free list. Gathers clamp an index into the pool as the reference's
    do; a healthy chain never needs it.
    """
    n1 = h.n - 1
    key_a, nxt, newloc = h.key, h.nxt, h.newloc
    ctr, stct, keymax = h.ctr, h.stct, h.keymax
    prev, head = head_idx, head_idx
    curr_ref = int(nxt[min(head_idx, n1)])
    status, deleg = -1, refs.NULL_REF
    for _ in range(cfg.max_scan):
        remote = refs.ref_sid(curr_ref) != me
        curr_idx = refs.ref_idx(curr_ref)
        safe_idx = 0 if remote else curr_idx
        gi = min(safe_idx, n1)
        is_moved = (not remote) and int(stct[ctr[gi]]) < 0

        curr_key = int(key_a[gi])
        curr_nxt = int(nxt[gi])
        is_sh = curr_key == SH_KEY
        is_st = curr_key == ST_KEY

        # entering a new sublist: its SubHead becomes the delegation anchor
        if not remote and is_sh:
            head = safe_idx
        hg = min(head, n1)
        if remote or is_moved:
            status = S_DELEGATE
            deleg = refs.unmarked(curr_ref) if remote \
                else refs.unmarked(int(newloc[hg]))
            break

        # marked node (not a sentinel): delink it (Harris helping) — unless
        # it or its sublist is moving (§5.4; see the reference's note)
        unlinked_to = refs.unmarked(curr_nxt)
        if (curr_nxt < 0 and not is_sh and not is_st
                and refs.is_null(int(newloc[gi]))
                and refs.is_null(int(newloc[hg]))):
            # preserve prev's own deletion mark when relinking
            pg = min(prev, n1)
            h.put("nxt", pg, unlinked_to | (int(nxt[pg]) & refs.MARK_BIT))
            h.put("free_list", min(max(h.free_top, 0), h.n - 1), curr_idx)
            h.free_top += 1
            curr_ref = unlinked_to
            continue

        # SubTail: stop here if key is covered, else cross into the next
        # sublist; ordinary stop at the first node with key' >= key
        if (is_st and key <= int(keymax[gi])) or \
                (not is_st and not is_sh and curr_key >= key):
            status = S_FOUND
            break
        prev = safe_idx
        curr_ref = curr_nxt

    if status < 0:
        status = S_OVERFLOW
    return SearchOut(status=status, left=prev, right=refs.ref_idx(curr_ref),
                     head=head, deleg=deleg)
