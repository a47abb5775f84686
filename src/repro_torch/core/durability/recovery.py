"""Crash recovery: snapshot + WAL replay through ``shard_round``.

``shard_round`` is a pure function of ``(state, bg, inbox, client,
cfg)``, so the WAL journals a round's *inputs* (the backlog rows appended
by routing, the client feed consumed) and replay is literal
re-execution on the shard's device. The rebuilt state, BgTable and
backlog are bit-identical to what the dead process held at its last
durable round.

Replayed outboxes are discarded: the journaled lane image already holds
every frame the shard had sent and not yet seen acked (the retransmit
ring), and everything acked was delivered at the peer.

Every replayed round's completions (and post-round bg phases / epoch)
are audited against the journaled ones; a mismatch raises
``RecoveryError`` rather than resurrecting a shard with different
history. The journaled host commands are re-queued where the live run
queued them: split/move/merge into the BgTable, replicate/drop_replica
into the shard's replication sessions (DESIGN.md §15).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import bg as B
from .. import messages as M
from .. import replica as R
from ..shard import shard_round
from ..types import DiLiConfig
from .snapshot import ShardSnapshots
from .wal import (CMD_DROP_REPLICA, CMD_MERGE, CMD_MOVE, CMD_REPLICATE,
                  CMD_SPLIT, KIND_COMMAND, KIND_SUBMIT, WriteAheadLog)

_LANE = "lane/"


class RecoveryError(RuntimeError):
    """WAL replay diverged from the journaled run (or no durable base)."""


class RecoveredShard(NamedTuple):
    state: object            # ShardState at the last durable round
    bg: object               # BgTable at the last durable round
    backlog: np.ndarray      # host backlog (delivered-but-unconsumed rows)
    lanes: Dict[str, np.ndarray]   # transport lane image to reinstall
    last_round: int          # the last durable round replay reached
    replayed_rounds: int     # WAL rounds re-executed on top of snapshot


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def completions_array(out) -> np.ndarray:
    """The (op_id, result, src, key) rows one RoundOut completed, in row
    order: what the live cluster journals, so replay compares bit for
    bit. ``key`` is SH_KEY for scalar completions and the scanned key for
    RANGE item rows (DESIGN.md §16)."""
    cs, cv, cr, ck = (_np(out.comp_slot), _np(out.comp_val),
                      _np(out.comp_src), _np(out.comp_key))
    done = cs >= 0
    return np.stack([cs[done], cv[done], cr[done], ck[done]],
                    axis=1).astype(np.int32)


def lane_image_of(record: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k[len(_LANE):]: v for k, v in record.items()
            if k.startswith(_LANE)}


def recover_shard(cfg: DiLiConfig, shard: int, wal: WriteAheadLog,
                  snaps: ShardSnapshots, *, in_cap: int,
                  device="cuda") -> RecoveredShard:
    """Rebuild ``shard`` on ``device`` from its latest snapshot + WAL
    suffix."""
    base = snaps.load_latest(cfg, device)
    if base is None:
        raise RecoveryError(
            f"shard {shard}: no snapshot on disk — the genesis snapshot "
            f"is written at attach time, so this slot never attached")
    state, bg = base["state"], base["bg"]
    backlog = base["backlog"]
    lanes = base["lanes"]
    last_round = base["round"]
    replayed = 0
    for rec in wal.records():
        rnd = int(rec["round"])
        if rnd <= base["round"]:
            continue           # pre-snapshot leftovers (truncation is lazy)
        if int(rec["kind"]) == KIND_SUBMIT:
            rows = np.asarray(rec["appends"], np.int32)
            if rows.size:
                backlog = np.concatenate([backlog, rows], axis=0)
            continue
        if int(rec["kind"]) == KIND_COMMAND:
            # re-queue the host-side balancer command exactly where the
            # live run did (stream order = queue order)
            args = [int(a) for a in np.asarray(rec["args"]).ravel()]
            cmd = int(rec["cmd"])
            if cmd in (CMD_REPLICATE, CMD_DROP_REPLICA):
                # replication commands edit ShardState.rep, not the
                # BgTable: same journal, other substrate
                fn = (R.queue_replicate if cmd == CMD_REPLICATE
                      else R.queue_drop_replica)
                state, ok = fn(state, cfg, *args)
            else:
                queue = {CMD_SPLIT: B.queue_split, CMD_MOVE: B.queue_move,
                         CMD_MERGE: B.queue_merge}[cmd]
                bg, ok = queue(bg, *args)
            if bool(ok) != bool(int(rec["ok"])):
                raise RecoveryError(
                    f"shard {shard} round {rnd}: replayed command "
                    f"cmd={cmd} args={args} accepted={bool(ok)} != "
                    f"journaled {bool(int(rec['ok']))}")
            continue
        # mirror the live feed discipline exactly: bounded FIFO pop,
        # zero-padded inbox, the journaled client feed, then the round's
        # routed appends land behind whatever was left over
        feed = backlog[:in_cap]
        backlog = backlog[in_cap:]
        inbox = np.zeros((in_cap, M.FIELDS), np.int32)
        inbox[:feed.shape[0]] = feed
        client = np.asarray(rec["client"], np.int32).reshape(-1, M.FIELDS)
        out = shard_round(state, bg, shard, inbox, client, cfg)
        state, bg = out.state, out.bg
        comp = completions_array(out)
        want = np.asarray(rec["comp"], np.int32).reshape(-1, 4)
        if not np.array_equal(comp, want):
            raise RecoveryError(
                f"shard {shard} round {rnd}: replayed completions "
                f"{comp.tolist()} != journaled {want.tolist()} — replay "
                f"diverged from the live run")
        phases = B.slot_phases(bg)
        if not np.array_equal(phases, np.asarray(rec["bg_phases"])):
            raise RecoveryError(
                f"shard {shard} round {rnd}: replayed bg phases "
                f"{phases.tolist()} != journaled "
                f"{np.asarray(rec['bg_phases']).tolist()}")
        if int(state.epoch) != int(rec["epoch"]):
            raise RecoveryError(
                f"shard {shard} round {rnd}: replayed epoch "
                f"{int(state.epoch)} != journaled {int(rec['epoch'])}")
        appends = np.asarray(rec["appends"], np.int32)
        if appends.size:
            backlog = np.concatenate([backlog, appends], axis=0)
        lanes = lane_image_of(rec)
        last_round = rnd
        replayed += 1
    return RecoveredShard(state, bg, backlog, lanes, last_round, replayed)
