"""One shard's round: process the inbox, apply client ops, advance the
background slot table.

The device does the vectorized work: the packed-block refresh, the
combined FIND/INSERT/REMOVE pre-pass and its ``hybrid_search`` kernel, the
per-entry op counts. The serial pass — the rows no pre-pass answered —
and the background step run on the host, as Python loops over a working
copy of the columns they touch (``core/host.py``), dispatching on each
row's kind; the touched rows are written back to the device at the end of
the round. The reference runs the same two stages as one jitted function
(``lax.while_loop`` + ``lax.switch``).

With ``cfg.range_scan`` the packed blocks are refreshed every round and
the RANGE pre-pass (``range_scan.range_prepass``) serves scan cursors from
them before anything mutates; the rest walk in the serial pass
(``range_scan.h_range``). A round with ``MSG_MOVE_ITEMS`` rows replays
their eligible runs in the batched splice (``bg.replay_prepass``, on the
device) before the serial pass. With ``cfg.replication`` (DESIGN.md §15)
the replica read pre-pass (``replica.replica_serve``, on the device)
answers local FINDs from serving replica slots, and the publication step
(``replica.replica_step``, on the device) runs after the background step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import timing
from . import batch_apply as BA
from . import bg as B
from . import blocks as BL
from . import messages as M
from . import ops as O
from . import range_scan as RS
from . import refs
from . import registry as REG
from . import replica as R
from .host import HostShard, to_numpy
from .types import DiLiConfig, RES_PENDING, SH_KEY, ShardState, clone_state

class RoundOut(NamedTuple):
    """A round's result. ``state``/``bg`` live on the shard's device; the
    host-built outbox and completion lanes are CPU tensors."""
    state: ShardState
    bg: B.BgTable
    outbox: torch.Tensor      # [cap, FIELDS]
    out_count: torch.Tensor
    comp_slot: torch.Tensor   # [K] client slots completed this round (-1 pad)
    comp_val: torch.Tensor    # [K]
    comp_src: torch.Tensor    # [K] shard that executed each completed op
    comp_key: torch.Tensor    # [K] SH_KEY for scalar completions; a real
                              # key marks the row as one RANGE item
    fast_hits: torch.Tensor   # int32 — finds answered by the fast-path
    mut_hits: torch.Tensor    # int32 — mutations applied by the fast-path
    bg_active: torch.Tensor   # int32 — background slots busy after the round
    move_hits: torch.Tensor   # int32 — MoveItems replayed by the splice
    blk_hits: torch.Tensor    # int32 — fast-path lanes answered by the kernel
    rep_hits: torch.Tensor    # int32 — FINDs answered from a replica slot
    range_hits: torch.Tensor  # int32 — RANGE segments served by the pre-pass
    ent_hits: torch.Tensor    # int32[M] — ops attributed to each local entry


# kinds that neither mutate a chain nor shift the registry (the blanket
# packed-block invalidation trigger ignores them)
_PURE_KINDS = (M.MSG_NONE, M.MSG_RESULT, M.MSG_NET_ACK, M.MSG_EPOCH,
               M.MSG_REPLICA_DELTA, M.MSG_REPLICA_INSTALL,
               M.MSG_REPLICA_DROP, M.MSG_RANGE, M.MSG_RANGE_ITEM)


def _handle_op(h, hb, me, row, outbox, count, cfg):
    result, outbox, count = O.apply_op(h, me, row, outbox, count, cfg)
    local_done = (result != RES_PENDING and int(row[M.F_SID]) == me
                  and int(row[M.F_A]) != 0)
    if local_done:
        return (int(row[M.F_TS]), result, me, SH_KEY), outbox, count
    return (-1, 0, me, SH_KEY), outbox, count


def _handle_result(h, hb, me, row, outbox, count, cfg):
    # F_SRC is the shard that executed the op and routed the result home
    return ((int(row[M.F_TS]), int(row[M.F_A]), int(row[M.F_SRC]), SH_KEY),
            outbox, count)


def _wrap_bg(fn):
    def handle(h, hb, me, row, outbox, count, cfg):
        outbox, count = fn(h, hb, me, row, outbox, count, cfg)
        return (-1, 0, 0, SH_KEY), outbox, count
    return handle


def _handle_epoch(h, hb, me, row, outbox, count, cfg):
    # monotone merge of the membership announcement (DESIGN.md §13)
    e = int(row[M.F_KEY])
    if e > h.epoch:
        h.epoch = e
        h.peers = int(row[M.F_X1])
    return (-1, 0, 0, SH_KEY), outbox, count


def _noop(h, hb, me, row, outbox, count, cfg):
    return (-1, 0, 0, SH_KEY), outbox, count


_HANDLERS = {
    M.MSG_NONE: _noop,
    M.MSG_OP: _handle_op,
    M.MSG_RESULT: _handle_result,
    M.MSG_REP_INSERT: _wrap_bg(B.h_rep_insert),
    M.MSG_REP_DELETE: _wrap_bg(B.h_rep_delete),
    M.MSG_ACK_INSERT: _wrap_bg(B.h_ack_insert),
    M.MSG_ACK_DELETE: _wrap_bg(B.h_ack_delete),
    M.MSG_MOVE_SH: _wrap_bg(B.h_move_sh),
    M.MSG_MOVE_SH_ACK: _wrap_bg(B.h_move_sh_ack),
    M.MSG_MOVE_ITEM: _wrap_bg(B.h_move_item),
    # batch-run member the replay pre-pass bounced: same field layout, so
    # the serial per-item replay is the universal fallback
    M.MSG_MOVE_ITEMS: _wrap_bg(B.h_move_item),
    M.MSG_MOVE_ACK: _wrap_bg(B.h_move_ack),
    M.MSG_SWITCH_ST: _wrap_bg(B.h_switch_st),
    M.MSG_SWITCH_ST_ACK: _wrap_bg(B.h_switch_st_ack),
    M.MSG_REG_SPLIT: _wrap_bg(B.h_reg_split),
    M.MSG_SWITCH_SERVER: _wrap_bg(B.h_switch_server),
    M.MSG_REG_MERGED: _wrap_bg(B.h_reg_merged),
    M.MSG_NET_ACK: _noop,   # transport-level; consumed before the round
    M.MSG_EPOCH: _handle_epoch,
    M.MSG_REPLICA_DELTA: _wrap_bg(R.h_replica_delta),
    M.MSG_REPLICA_INSTALL: _wrap_bg(R.h_replica_install),
    M.MSG_REPLICA_DROP: _wrap_bg(R.h_replica_drop),
    M.MSG_RANGE: RS.h_range,
    M.MSG_RANGE_ITEM: RS.h_range_item,
}


assert sorted(_HANDLERS) == list(range(M.N_KINDS)), sorted(_HANDLERS)


def _dispatch(kind: int):
    return _HANDLERS[min(max(kind, 0), M.N_KINDS - 1)]


def _host_rows(x) -> np.ndarray:
    return np.asarray(to_numpy(x), np.int32).reshape(-1, M.FIELDS)


def shard_round(state: ShardState, bg: B.BgTable, me: int, inbox, client,
                cfg: DiLiConfig, *, timer=None) -> RoundOut:
    """``inbox``/``client``: [*, FIELDS] int32 rows (numpy or tensors),
    MSG_NONE-padded. ``state`` and ``bg`` are not modified. ``timer``, if
    given, is a ``timing.PhaseTimer`` that receives the phase breakdown,
    every phase inside the span ``shard_round``."""
    t = timing.tracer(timer)
    with t("shard_round"):
        return _round(state, bg, int(me), inbox, client, cfg, t)


def _round(state, bg, me, inbox, client, cfg, t) -> RoundOut:
    rows_np = np.concatenate([_host_rows(inbox), _host_rows(client)])
    n_rows = rows_np.shape[0]
    dev = state.pool.key.device
    state = clone_state(state)
    rows = torch.from_numpy(rows_np).to(dev)

    # rebuild dirty packed blocks against round-start state, before any
    # mutation (DESIGN.md §12); the RANGE pre-pass serves from them, and
    # replica_step publishes their rows as session images (§15)
    if cfg.block_probe or cfg.replication or cfg.range_scan:
        with t("refresh_blocks"):
            state = BL.refresh_blocks(state, me, cfg)

    # RANGE gather pre-pass (DESIGN.md §16): serve scan cursors from valid
    # packed blocks against the same round-start snapshot; its rows lead
    # the outbox, as in the reference
    outbox, count = M.empty_outbox(cfg.mailbox_cap)
    range_handled = np.zeros((n_rows,), bool)
    range_hits = 0
    if cfg.range_scan:
        with t("range_prepass"):
            outbox, count, range_handled, range_hits = RS.range_prepass(
                state, rows, rows_np, me, outbox, count, cfg)

    with t("round_prepass"):
        pre = BA.round_prepass(state, rows, rows_np, me, cfg,
                               run_find=cfg.find_fastpath,
                               run_mut=cfg.mut_fastpath, timer=t)
    state = pre.state
    # migration rounds get their own pre-pass (any move row makes the round
    # non-benign for the client one): eligible MSG_MOVE_ITEMS runs are
    # spliced and their MOVE_ACKs pushed ahead of the serial rows' messages
    with t("replay_prepass"):
        mrp = B.replay_prepass(state, rows, me, outbox, count, cfg,
                               rows_np=rows_np)
    state, handled, outbox, count = mrp

    # replica read pre-pass (DESIGN.md §15): fresh local FINDs whose key
    # lands in a serving replica slot are answered from its image and skip
    # the serial pass. The Move replay's and the RANGE pre-pass's rows are
    # never MSG_OP rows, so only the client pre-pass's need excluding on
    # the device; the host mask below excludes all three, as the
    # reference does.
    if cfg.replication:
        with t("replica_serve"):
            rep_elig, rep_res = R.replica_serve(state, rows, me, cfg)
            rep_elig = rep_elig & ~pre.find_elig & ~pre.mut_elig
    else:
        rep_elig = torch.zeros((n_rows,), dtype=torch.bool, device=dev)
        rep_res = torch.zeros((n_rows,), dtype=torch.int32, device=dev)

    # per-entry op attribution (pre-reorder), on the device: an MSG_OP row
    # counts at the shard that answers it, an owned entry or a replica
    m_ent = state.registry.keymin.shape[0]
    ent = REG.get_by_key(state.registry, rows[:, M.F_KEY])
    entc = ent.clamp(0, m_ent - 1)
    owned = (ent >= 0) & (refs.ref_sid(state.registry.subhead[entc]) == me)
    count_here = (rows[:, M.F_KIND] == M.MSG_OP) & (owned | rep_elig)
    ent_hits = torch.zeros((m_ent,), dtype=torch.int32, device=dev)
    ent_hits.index_add_(0, entc.long(), count_here.to(torch.int32))

    # one transfer brings the pre-pass verdicts to the host
    pv = to_numpy(torch.cat([pre.find_elig.to(torch.int32),
                             pre.mut_elig.to(torch.int32),
                             torch.where(rep_elig, rep_res, pre.res),
                             rep_elig.to(torch.int32),
                             pre.blk_hits.reshape(1)]))
    find_elig = pv[:n_rows].astype(bool)
    mut_elig = pv[n_rows:2 * n_rows].astype(bool)
    res_all = pv[2 * n_rows:3 * n_rows]
    rep_elig = pv[3 * n_rows:4 * n_rows].astype(bool) & ~handled
    blk_hits = int(pv[-1])

    kind0 = rows_np[:, M.F_KIND]
    skip = (kind0 == M.MSG_NONE) | find_elig | mut_elig | handled \
        | rep_elig | range_handled
    serial_mut = bool(np.any(~skip & ~np.isin(kind0, _PURE_KINDS)))

    # stable-partition the rows the serial pass must execute to the front
    order = np.argsort(skip.astype(np.int64) * n_rows + np.arange(n_rows),
                       kind="stable")
    rows_o = rows_np[order]
    pre_done = (find_elig | mut_elig | rep_elig)[order]
    n_live = int((~skip).sum())

    # completions start pre-filled with the pre-pass answers (those rows
    # sit past n_live); the serial loop overwrites its own rows' slots
    cslots = np.where(pre_done, rows_o[:, M.F_TS], -1).astype(np.int32)
    cvals = np.where(pre_done, res_all[order], 0).astype(np.int32)
    csrcs = np.full((n_rows,), me, np.int32)
    ckeys = np.full((n_rows,), SH_KEY, np.int32)

    h = HostShard(state)
    hb = B.HostBg(bg)
    with t("serial_loop"):
        for i in range(n_live):
            row = rows_o[i]
            fn = _dispatch(int(row[M.F_KIND]))
            comp, outbox, count = fn(h, hb, me, row, outbox, count, cfg)
            cslots[i], cvals[i], csrcs[i], ckeys[i] = comp

    with t("bg_step"):
        bg_busy = bool((hb.f["phase"] != B.BG_IDLE).any())
        outbox, count = B.bg_step(h, hb, me, outbox, count, cfg)
        bg_active = int((hb.f["phase"] != B.BG_IDLE).sum())
        bg_busy = bg_busy or bg_active > 0
    with t("write_back"):
        state = h.commit()
        bg = hb.table()

    # publication step (DESIGN.md §15): after the serial pass and the bg
    # step, so a fresh image already holds this round's mutations
    if cfg.replication:
        with t("replica_step"):
            traffic = bool(np.any(kind0 != M.MSG_NONE))
            mutated = serial_mut or bool(mut_elig.any()) or bg_busy
            state, outbox, count = R.replica_step(
                state, me, mutated, traffic, outbox, count, cfg)

    # blanket invalidation: serial mutating rows or any bg slot active
    # around bg_step (DESIGN.md §12)
    if serial_mut or bg_busy or handled.any():
        state.blk.valid.zero_()

    i32 = torch.int32
    return RoundOut(
        state=state, bg=bg,
        outbox=torch.from_numpy(outbox),
        out_count=torch.tensor(count, dtype=i32),
        comp_slot=torch.from_numpy(cslots),
        comp_val=torch.from_numpy(cvals),
        comp_src=torch.from_numpy(csrcs),
        comp_key=torch.from_numpy(ckeys),
        fast_hits=torch.tensor(int(find_elig.sum()), dtype=i32),
        mut_hits=torch.tensor(int(mut_elig.sum()), dtype=i32),
        bg_active=torch.tensor(bg_active, dtype=i32),
        move_hits=torch.tensor(int(handled.sum()), dtype=i32),
        blk_hits=torch.tensor(blk_hits, dtype=i32),
        rep_hits=torch.tensor(int(rep_elig.sum()), dtype=i32),
        range_hits=torch.tensor(range_hits, dtype=i32),
        ent_hits=ent_hits)

