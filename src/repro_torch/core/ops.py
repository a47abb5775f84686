"""Client operations — the paper's Find / Insert / Remove (§5.2, Alg. 2-3).

Each op is applied atomically within a round; stCt is incremented before
an update and endCt after it (§5.4), an update on a moving sublist defers
its endCt to the replay acknowledgement, and ops that hit a switched
sublist (stCt < 0) are delegated.

``resolve_route`` is the vectorized route resolution of the pre-passes, on
the device. ``apply_op`` is the serial pass's exact per-row algorithm, on
the round's host working copy (``core/host.py``); ``route`` is its scalar
route resolution.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import messages as M
from . import refs
from . import registry as reg_ops
from .bg.util import alloc_node
from .traverse import S_DELEGATE, S_FOUND, S_OVERFLOW, search
from .types import (DiLiConfig, OP_FIND, OP_INSERT, OP_NOP, OP_REMOVE,
                    RES_FALSE, RES_PENDING, RES_TRUE, ShardState)

RES_OVERFLOW = -2   # traversal bound exceeded — tests assert never seen
RES_POOLFULL = -3   # allocator exhausted — tests assert never seen


class Route(NamedTuple):
    """Resolved subhead for an op (Find lines 72-74)."""
    sh_ref: torch.Tensor      # int32 subhead Ref (hint, or registry entry)
    owner: torch.Tensor       # int32 shard id owning the subhead
    head_idx: torch.Tensor    # int32 pool index of the subhead on ``owner``
    head_moved: torch.Tensor  # bool — subhead's sublist switched away
    head_newloc: torch.Tensor # int32 forwarding Ref when head_moved
    no_route: torch.Tensor    # bool — registry has no covering entry
    entry: torch.Tensor       # int32 covering registry entry (-1 if none)


def pool_slot(state: ShardState, idx):
    """Clip a (possibly hostile) pool index into the pool's bound — the
    clamp a JAX gather applies on its own."""
    return idx.clamp(0, state.pool.key.shape[0] - 1)


def resolve_route(state: ShardState, key, sh_hint, me) -> Route:
    """Resolve the subhead each lane must start from: a null hint forces a
    registry lookup; a hinted subhead that has itself moved forwards via
    its newLoc. ``key``/``sh_hint`` are equally-shaped int32 tensors."""
    need_lookup = refs.is_null(sh_hint)
    entry = reg_ops.get_by_key(state.registry, key)
    entry_sh = state.registry.subhead[entry.clamp(min=0)]
    sh_ref = torch.where(need_lookup, entry_sh, sh_hint)
    no_route = need_lookup & (entry < 0)

    owner = refs.ref_sid(sh_ref)
    head_idx = refs.ref_idx(sh_ref)
    safe_head = pool_slot(state, head_idx)
    head_ctr = state.pool.ctr[safe_head].clamp(0, state.stct.shape[0] - 1)
    head_moved = (owner == me) & (state.stct[head_ctr] < 0)
    head_newloc = refs.unmarked(state.pool.newloc[safe_head])
    return Route(sh_ref=sh_ref, owner=owner, head_idx=head_idx,
                 head_moved=head_moved, head_newloc=head_newloc,
                 no_route=no_route, entry=entry)


def route(h, key: int, sh_hint: int, me: int):
    """Scalar ``resolve_route`` on the host copy: returns
    (sh_ref, owner, head_idx, head_moved, head_newloc, no_route)."""
    need_lookup = refs.is_null(sh_hint)
    entry = reg_ops.lookup(h.r_keymin, h.r_keymax, h.size, key)
    sh_ref = int(h.r_subhead[max(entry, 0)]) if need_lookup else sh_hint
    no_route = need_lookup and entry < 0
    owner = refs.ref_sid(sh_ref)
    head_idx = refs.ref_idx(sh_ref)
    safe_head = min(max(head_idx, 0), h.n - 1)
    head_ctr = min(max(int(h.ctr[safe_head]), 0), h.n_ctrs - 1)
    head_moved = owner == me and int(h.stct[head_ctr]) < 0
    head_newloc = refs.unmarked(int(h.newloc[safe_head]))
    return sh_ref, owner, head_idx, head_moved, head_newloc, no_route


def _tick(h) -> int:
    ts = h.ts_clock
    h.ts_clock = ts + 1
    return ts


def apply_op(h, me: int, row, outbox, count, cfg: DiLiConfig):
    """Apply one MSG_OP row (fresh client op or delegated op) to the host
    copy ``h``. Returns (result, outbox, count).

    Row fields: a=op kind, key, ref1=subhead hint (NULL => registry lookup),
    sid=reply shard, ts=client slot, x2=hops.
    """
    kind = int(row[M.F_A])
    key = int(row[M.F_KEY])
    sh_hint = int(row[M.F_REF1])
    reply_sid = int(row[M.F_SID])
    slot = int(row[M.F_TS])
    hops = int(row[M.F_X2])
    n1 = h.n - 1

    # ------------------------------------------------ resolve the subhead
    sh_ref, owner, head_idx, head_moved, head_newloc, no_route = \
        route(h, key, sh_hint, me)
    deleg_now = owner != me or head_moved
    deleg_ref = refs.unmarked(sh_ref) if owner != me else head_newloc

    # ------------------------------------------------ traverse
    do_search = not no_route and not deleg_now and kind != OP_NOP
    left = right = 0
    overflow = found_ok = False
    if do_search:
        s = search(h, head_idx, key, me, cfg)
        if s.status == S_DELEGATE:
            deleg_now, deleg_ref = True, s.deleg
        overflow = s.status == S_OVERFLOW
        found_ok = s.status == S_FOUND
        left, right = min(s.left, n1), min(s.right, n1)

    # a marked right is NOT present (see the reference's note on moving
    # sublists)
    key_present = (found_ok and int(h.key[right]) == key
                   and not refs.ref_mark(int(h.nxt[right])))
    find_res = RES_TRUE if key_present else RES_FALSE

    # ------------------------------------------------ INSERT (Alg. 3)
    do_insert = found_ok and kind == OP_INSERT and not key_present
    new_idx, alloc_ok = alloc_node(h) if do_insert else (0, True)
    new_ts = _tick(h)
    ins_ok = do_insert and alloc_ok
    if ins_ok:
        left_ctr = int(h.ctr[left])
        left_newloc = int(h.newloc[left])
        moving = not refs.is_null(left_newloc)
        h.put("key", new_idx, key)
        h.put("ts", new_idx, new_ts)
        h.put("sid", new_idx, me)
        h.put("ctr", new_idx, left_ctr)
        # Line 189: the new item inherits leftNode.newLoc
        h.put("newloc", new_idx, left_newloc)
        # keymax doubles as the item payload on non-sentinels
        h.put("keymax", new_idx, int(row[M.F_VAL]))
        h.put("nxt", new_idx, refs.make_ref(me, right))
        # preserve left's own deletion mark when relinking
        left_mark = int(h.nxt[left]) & refs.MARK_BIT
        h.put("nxt", left, refs.make_ref(me, new_idx) | left_mark)
        # counters: stCt++ always; endCt++ only if no replicate
        h.put("stct", left_ctr, int(h.stct[left_ctr]) + 1)
        if not moving:
            h.put("endct", left_ctr, int(h.endct[left_ctr]) + 1)
        else:
            rep = M.make_row(
                M.MSG_REP_INSERT, refs.ref_sid(left_newloc), me,
                key=key, ref1=refs.unmarked(left_newloc),
                x2=int(h.sid[left]), x3=int(h.ts[left]),
                sid=me, ts=new_ts, x1=new_idx, x4=left_ctr,
                val=int(row[M.F_VAL]))
            outbox, count = M.push(outbox, count, rep)
    ins_res = RES_FALSE if key_present else \
        (RES_TRUE if alloc_ok else RES_POOLFULL)

    # ------------------------------------------------ REMOVE (Delete, Alg. 2)
    if found_ok and kind == OP_REMOVE and key_present:
        node = right
        node_ctr = int(h.ctr[node])
        node_newloc = int(h.newloc[node])
        h.put("nxt", node, refs.with_mark(int(h.nxt[node])))
        h.put("stct", node_ctr, int(h.stct[node_ctr]) + 1)
        if refs.is_null(node_newloc):
            h.put("endct", node_ctr, int(h.endct[node_ctr]) + 1)
        else:
            # x2=1: the ack carries the deferred endCt
            rep = M.make_row(
                M.MSG_REP_DELETE, refs.ref_sid(node_newloc), me,
                key=key, ref1=refs.unmarked(node_newloc),
                sid=int(h.sid[node]), ts=int(h.ts[node]),
                x1=node, x2=1, x4=node_ctr)
            outbox, count = M.push(outbox, count, rep)
    rem_res = RES_TRUE if key_present else RES_FALSE

    # ------------------------------------------------ result / routing
    result = {OP_FIND: find_res, OP_INSERT: ins_res,
              OP_REMOVE: rem_res}.get(kind, RES_FALSE)
    if overflow:
        result = RES_OVERFLOW
    if no_route:
        result = RES_FALSE
    if deleg_now:
        result = RES_PENDING

    if kind != OP_NOP:
        if deleg_now:
            # delegate: forward the op with the resolved subhead ref and
            # its value. The reference's forwarded row drops F_VAL, so an
            # INSERT that reaches its owner by delegation stores 0 there;
            # the port keeps the value (ROADMAP, Queue 3)
            fwd = M.make_row(M.MSG_OP, refs.ref_sid(deleg_ref), me,
                             a=kind, key=key, ref1=deleg_ref,
                             sid=reply_sid, ts=slot, x2=hops + 1,
                             val=int(row[M.F_VAL]))
            outbox, count = M.push(outbox, count, fwd)
        elif reply_sid != me:
            # completed op for a remote client: route the result home
            res = M.make_row(M.MSG_RESULT, reply_sid, me, a=result, ts=slot)
            outbox, count = M.push(outbox, count, res)
    return result, outbox, count
