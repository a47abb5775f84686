"""Hot-sublist read replication (DESIGN.md §15).

Under Zipfian skew one hot sublist caps throughput however the keys are
spread. The primary of a hot entry streams a packed-block image of the
sublist (one sorted ``int32[C]`` row of live keys, the ``core.blocks``
layout) to replica shards, which then answer FINDs in the entry's range
locally. INSERT and REMOVE still go to the primary; a replica is a cache
with bounded staleness.

The protocol is the reference's (``repro.core.replica``), bit for bit:

  * ``queue_replicate`` claims a primary-side *session* keyed by the
    entry's keymax and poisons its published mirror, so the first
    publication streams the whole image; ``queue_drop_replica`` retires
    targets. Both are host commands, journaled like the balancer's, and
    pure, so WAL recovery replays them literally.
  * ``replica_step`` (after the serial pass and the background step, on
    the device) ticks the replica leases, audits each session's entry,
    diffs the packed-block row against the published mirror on the
    refresh cadence, and emits REPLICA_DROP rows, ``replica_batch``
    REPLICA_DELTA rows and a REPLICA_INSTALL commit per session and
    target, in that order on each FIFO lane, with one ``push_many``.
  * The replica applies deltas in place (``h_replica_delta``, host side
    like every handler of the serial pass); the commit
    (``h_replica_install``) publishes the version and renews the lease,
    and a slot serves only while ``ttl > 0``.
  * ``replica_serve`` is the read pre-pass, on the device: fresh local
    FINDs whose key falls in a serving slot's range are answered from its
    image and skip the serial pass.

Indexing follows JAX's rules, as in ``core/bg/util.py``: an ``argmax``
over an all-False mask is 0 and the code reads on from that row, and a
write aimed at the slot count is dropped. A row that still serves while a
new version streams into it can be unsorted, so ``replica_serve``'s
search is the reference's own bisection (``searchsorted_scan``), not
``torch.searchsorted``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import messages as M
from . import refs
from . import registry as REG
from .types import (DiLiConfig, OP_FIND, RES_FALSE, RES_TRUE, SH_KEY,
                    ST_KEY, ShardState, tree_map)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _i32(v: int) -> int:
    """``v`` wrapped into the signed int32 range (JAX's int32 shifts)."""
    return (int(v) + 2**31) % 2**32 - 2**31


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmax`` of a bool mask: the first True, 0 when there is
    none (``torch.argmax`` takes no bool and returns the first maximum)."""
    return mask.to(torch.int32).argmax(dim)


# ------------------------------------------------------------- commands

def queue_replicate(state: ShardState, cfg: DiLiConfig, keymax, target):
    """Host command: start (or widen) read replication of the entry with
    upper bound ``keymax`` onto shard ``target``. Returns ``(state, ok)``;
    an unknown entry, a target out of range or equal to the owner, or no
    free session rejects it. ``state`` is not modified."""
    keymax, target = int(keymax), int(target)
    reg = state.registry
    m = reg.keymin.shape[0]
    r_keymax = _np(reg.keymax)
    e = REG.lookup(_np(reg.keymin), r_keymax, int(reg.size), keymax)
    ec = min(max(e, 0), m - 1)
    owner = refs.ref_sid(int(reg.subhead[ec]))
    valid = (e >= 0 and int(r_keymax[ec]) == keymax
             and 0 <= target < cfg.num_shards and target != owner)

    rk = _np(state.rep.keymax)
    have, free = rk == keymax, rk == SH_KEY
    j = int(np.argmax(have)) if have.any() else int(np.argmax(free))
    if not (valid and (have.any() or free.any())):
        return state, False
    rep = tree_map(torch.clone, state.rep)
    rep.keymax[j] = keymax
    rep.targets[j] = int(rep.targets[j]) | _i32(1 << target)
    if not have.any():
        rep.version[j] = 0
    rep.cursor[j] = -1
    rep.age[j] = 0
    # a new target must receive the full image: poison the published
    # mirror (SH_KEY differs from every image cell and every ST_KEY pad)
    rep.keys[j] = SH_KEY
    rep.diff[j] = False
    return state._replace(rep=rep), True


def queue_drop_replica(state: ShardState, cfg: DiLiConfig, keymax,
                       target=-1):
    """Host command: retire replicas of ``keymax`` on ``target`` (all of
    them when ``target`` is -1). The session flushes REPLICA_DROP rows
    next round and frees itself once no target remains. Returns
    ``(state, ok)``; ``state`` is not modified."""
    keymax, target = int(keymax), int(target)
    have = _np(state.rep.keymax) == keymax
    j = int(np.argmax(have))
    tj = int(state.rep.targets[j])
    bits = tj if target < 0 else tj & _i32(1 << min(max(target, 0), 30))
    if not have.any():
        return state, False
    rep = tree_map(torch.clone, state.rep)
    rep.targets[j] = tj & ~bits
    rep.drops[j] = int(rep.drops[j]) | bits
    rep.cursor[j] = -1
    rep.diff[j] = False
    return state._replace(rep=rep), bits != 0


# ---------------------------------------------------------- serve path

def searchsorted_scan(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(rows[i], q[i], side="left")`` per row, as JAX's
    default ``method="scan"`` computes it: ``ceil(log2(C+1))`` levels of
    ``mid = (low+high)//2``, going left where ``q <= row[mid]``; returns
    ``high``. On a sorted row this is the usual insertion point; on an
    unsorted one (a slot whose deltas are still landing) it is whatever
    this exact sequence of probes gives, as in the reference."""
    b, c = rows.shape
    low = torch.zeros((b,), dtype=torch.int64, device=rows.device)
    high = torch.full((b,), c, dtype=torch.int64, device=rows.device)
    for _ in range(int(np.ceil(np.log2(c + 1)))):
        mid = (low + high) // 2
        go_left = q <= rows.gather(1, mid.clamp(max=c - 1)[:, None])[:, 0]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high.to(torch.int32)


def replica_serve(state: ShardState, rows: torch.Tensor, me: int,
                  cfg: DiLiConfig):
    """Vectorized replica read pre-pass over the round's device rows.
    Returns ``(elig, res)``, both on the device.

    A row is served when it is a fresh local FIND (delegated rows expect
    an authoritative answer) whose key lies in (keymin, keymax] of a slot
    that is occupied, committed (version >= 0) and leased (ttl > 0), and
    no locally owned registry entry covers the key (then the chain is the
    truth and the slot a leftover awaiting its DROP)."""
    rs = state.rslots
    kind, key = rows[:, M.F_KIND], rows[:, M.F_KEY]
    cand = (kind == M.MSG_OP) & (rows[:, M.F_A] == OP_FIND) & \
        (rows[:, M.F_SID] == me)

    serving = (rs.keymax != SH_KEY) & (rs.version >= 0) & (rs.ttl > 0)
    inrange = (key[:, None] > rs.keymin[None, :]) & \
        (key[:, None] <= rs.keymax[None, :]) & serving[None, :]
    hit = inrange.any(1)
    j = _first_true(inrange, 1)

    reg = state.registry
    e = REG.get_by_key(reg, key)
    ec = e.clamp(0, reg.keymin.shape[0] - 1)
    owned = (e >= 0) & (refs.ref_sid(reg.subhead[ec]) == me)

    elig = cand & hit & ~owned
    krow = rs.keys[j]                                  # [B, C]
    pos = searchsorted_scan(krow, key)
    found = krow.gather(
        1, pos.clamp(0, krow.shape[1] - 1).long()[:, None])[:, 0] == key
    res = torch.where(found, RES_TRUE, RES_FALSE).to(torch.int32)
    return elig, res


# ------------------------------------------------------ replica handlers
# Host side, on the serial pass's ``HostShard`` (``core/host.py``), with
# the background handlers' signature (h, hb, me, row, outbox, count, cfg)
# -> (outbox, count). None of them touches the table or the outbox.

def h_replica_delta(h, hb, me, row, outbox, count, cfg: DiLiConfig):
    """Apply one image-cell rewrite. Claims a free slot on first contact
    (version -1: deltas arriving, not serving until the commit lands);
    with no matching and no free slot the row is dropped and the replica
    simply never serves."""
    key = int(row[M.F_KEY])
    have = h.rs_keymax == key
    free = h.rs_keymax == SH_KEY
    if not (have.any() or free.any()):
        return outbox, count
    claim = not have.any()
    j = int(np.argmax(free)) if claim else int(np.argmax(have))
    # a reclaimed slot must not leak the previous tenant's image
    keys_j = np.full_like(h.rs_keys[j], ST_KEY) if claim \
        else h.rs_keys[j].copy()
    keys_j[min(max(int(row[M.F_X1]), 0), keys_j.shape[0] - 1)] = \
        row[M.F_X3]
    h.put("rs_keymax", j, key)
    if claim:
        h.put("rs_keymin", j, key)
        h.put("rs_version", j, -1)
        h.put("rs_ttl", j, 0)
    h.put("rs_src", j, int(row[M.F_SRC]))
    h.put("rs_keys", j, keys_j)
    return outbox, count


def h_replica_install(h, hb, me, row, outbox, count, cfg: DiLiConfig):
    """Commit a publication / renew the lease. Only an existing slot
    commits: a commit with no slot is a renewal that outlived an
    eviction, and committing an empty image would serve wrong absences."""
    have = h.rs_keymax == int(row[M.F_KEY])
    if have.any():
        j = int(np.argmax(have))
        h.put("rs_keymin", j, int(row[M.F_X1]))
        h.put("rs_src", j, int(row[M.F_SRC]))
        h.put("rs_version", j, int(row[M.F_X2]))
        h.put("rs_ttl", j, cfg.replica_staleness_rounds)
    return outbox, count


def h_replica_drop(h, hb, me, row, outbox, count, cfg: DiLiConfig):
    """Free the slot the sending primary installed. Matches (keymax, src),
    so a late drop from an earlier primary cannot kill a successor's
    replica; a duplicate finds nothing."""
    have = (h.rs_keymax == int(row[M.F_KEY])) & \
        (h.rs_src == int(row[M.F_SRC]))
    if have.any():
        j = int(np.argmax(have))
        h.put("rs_keymax", j, SH_KEY)
        h.put("rs_keymin", j, SH_KEY)
        h.put("rs_src", j, -1)
        h.put("rs_version", j, -1)
        h.put("rs_ttl", j, 0)
        h.put("rs_keys", j, np.full_like(h.rs_keys[j], ST_KEY))
    return outbox, count


# ------------------------------------------------------ publication step

def replica_step(state: ShardState, me: int, mutated: bool, traffic: bool,
                 outbox, count, cfg: DiLiConfig):
    """Advance every primary-side session by one round and tick the
    replica-side leases, on the state's device. Runs after the serial pass
    and the background step, so a cadence walk sees this round's
    mutations. The rows it emits come to the host in one copy and join
    the (host) outbox with one ``push_many``. Returns
    ``(state, outbox, count)``."""
    i32 = torch.int32
    rep, reg, rs = state.rep, state.registry, state.rslots
    dev = rep.keymax.device
    n_sess, c, nsh = rep.keymax.shape[0], cfg.block_cap, cfg.num_shards

    # replica-side lease tick (ttl saturates at 0, so a cluster at rest
    # goes bit-static)
    occupied = rs.keymax != SH_KEY
    state = state._replace(rslots=rs._replace(
        ttl=torch.where(occupied, (rs.ttl - 1).clamp(min=0), rs.ttl)))
    if not cfg.replication:
        return state, outbox, count

    # session audit: the entry still owned, live and not moving here?
    active = rep.keymax != SH_KEY
    e = REG.get_by_key(reg, rep.keymax)
    ec = e.clamp(0, reg.keymin.shape[0] - 1)
    head_idx = refs.ref_idx(reg.subhead[ec]).clamp(
        0, state.pool.key.shape[0] - 1)
    slot = reg.ctr[ec].clamp(0, state.stct.shape[0] - 1)
    valid = active & (e >= 0) & (reg.keymax[ec] == rep.keymax) & \
        (refs.ref_sid(reg.subhead[ec]) == me) & (state.stct[slot] >= 0) & \
        refs.is_null(state.pool.newloc[head_idx])
    lost = active & ~valid
    drops = rep.drops | torch.where(lost, rep.targets, 0)
    targets = torch.where(lost, 0, rep.targets)
    cursor = torch.where(lost, -1, rep.cursor)

    # age tick (saturating) and the publication triggers: the first
    # publication, then renewals on the refresh cadence once the shard
    # saw traffic or mutations
    refresh = cfg.replica_refresh_rounds
    age = torch.where(active & valid, (rep.age + 1).clamp(max=refresh),
                      rep.age)
    renewal_due = (age >= refresh) & bool(traffic or mutated)
    need_walk = valid & (targets != 0) & (cursor < 0) & \
        ((rep.version == 0) | renewal_due)

    # the image is the packed-block row the fast paths maintain: a valid
    # row is the current chain; an invalid one defers the publication
    images = state.blk.keys[ec]
    can = need_walk & state.blk.valid[ec]
    diff = (images != rep.keys) & can[:, None]
    anydiff = diff.any(1)
    start = can & anydiff
    renew_only = can & ~anydiff & (rep.version > 0)
    keys = torch.where(start[:, None], images, rep.keys)
    diff = torch.where(start[:, None], diff, rep.diff)
    version = torch.where(start, rep.version + 1, rep.version)
    cursor = torch.where(start, 0, cursor)

    # emit: per session, DROPs, then the first replica_batch set diff
    # positions in position order, then the commit — on each FIFO
    # (src, dst) lane a commit lands after the deltas it seals. The sort
    # keys are unique (colix or colix + C), so any sort gives this order.
    tgt = torch.arange(nsh, dtype=i32, device=dev)
    tbit = ((targets[:, None] >> tgt[None, :]) & 1) != 0          # [S, T]
    dbit = ((drops[:, None] >> tgt[None, :]) & 1) != 0
    live = rep.keymax != SH_KEY
    streaming = cursor >= 0
    k = int(cfg.replica_batch)
    colix = torch.arange(c, dtype=i32, device=dev)
    pos = torch.argsort(torch.where(diff, colix, colix + c), dim=1,
                        stable=True)[:, :k]                        # [S, K]
    picked = diff.gather(1, pos)
    sent = live & streaming
    done = sent & (diff.sum(1) <= k)
    commit = done | (live & renew_only)
    livecnt = (keys != ST_KEY).sum(1).to(i32)

    def rows(shape, fields):
        out = torch.zeros(shape + (M.FIELDS,), dtype=i32, device=dev)
        for f, v in fields:
            out[..., f] = v
        return out

    kmax = rep.keymax
    drop_rows = rows((n_sess, nsh), [
        (M.F_KIND, M.MSG_REPLICA_DROP), (M.F_DST, tgt[None, :]),
        (M.F_SRC, me), (M.F_KEY, kmax[:, None]), (M.F_SID, me)])
    delta_rows = rows((n_sess, k, nsh), [
        (M.F_KIND, M.MSG_REPLICA_DELTA), (M.F_DST, tgt[None, None, :]),
        (M.F_SRC, me), (M.F_KEY, kmax[:, None, None]), (M.F_SID, me),
        (M.F_X1, pos[:, :, None].to(i32)),
        (M.F_X2, version[:, None, None]),
        (M.F_X3, keys.gather(1, pos)[:, :, None])])
    commit_rows = rows((n_sess, nsh), [
        (M.F_KIND, M.MSG_REPLICA_INSTALL), (M.F_DST, tgt[None, :]),
        (M.F_SRC, me), (M.F_KEY, kmax[:, None]), (M.F_SID, me),
        (M.F_X1, reg.keymin[ec][:, None]), (M.F_X2, version[:, None]),
        (M.F_X3, livecnt[:, None])])
    delta_ok = picked[:, :, None] & sent[:, None, None] & tbit[:, None, :]
    all_rows = torch.cat(
        [drop_rows, delta_rows.reshape(n_sess, k * nsh, M.FIELDS),
         commit_rows], dim=1).reshape(-1, M.FIELDS)
    all_ok = torch.cat(
        [dbit, delta_ok.reshape(n_sess, k * nsh), commit[:, None] & tbit],
        dim=1).reshape(-1)
    emitted = all_rows[all_ok].cpu().numpy()
    outbox, count = M.push_many(outbox, count, emitted,
                                np.ones((emitted.shape[0],), bool))

    selmask = torch.zeros_like(diff).scatter_(1, pos, picked & sent[:, None])
    diff = diff & ~selmask
    cursor = torch.where(done, -1, cursor)
    age = torch.where(commit, 0, age)

    # free fully retired sessions (no targets, owed drops just flushed)
    gone = live & (targets == 0)
    rep = rep._replace(
        keymax=torch.where(gone, SH_KEY, kmax),
        targets=targets,
        drops=torch.zeros_like(drops),
        version=torch.where(gone, 0, version),
        cursor=torch.where(gone, -1, cursor),
        age=torch.where(gone, 0, age),
        keys=torch.where(gone[:, None], ST_KEY, keys),
        diff=diff & ~gone[:, None])
    return state._replace(rep=rep), outbox, count
