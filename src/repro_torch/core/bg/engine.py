"""The slotted background engine: per-round slot stepping + host commands.

``bg_step`` advances every slot of a shard's table by one phase per round,
in slot order (slot j+1 sees slot j's writes), as the reference's
``lax.scan`` over slots does. It runs on the round's host working copies,
so one shard can split one sublist while moving a second and merging two
others in the same rounds.

``queue_split/move/merge`` are the host commands: each claims the first
idle slot, unless the named registry entry (or a merge's partner) is
already claimed by an active slot (DESIGN.md §10). They return
``(table, ok)``; ``ok`` is False when the command was dropped.
"""
from __future__ import annotations

import numpy as np

from ..types import DiLiConfig, SH_KEY
from .fsm import (BG_IDLE, BG_MERGE_EXEC, BG_MERGE_WAIT, BG_MOVE_COPY,
                  BG_MOVE_SH, BG_MOVE_STABLE, BG_NUM_PHASES, BG_QUAR,
                  BG_SPLIT_EXEC, BG_SPLIT_WAIT, BG_SWITCH_REG, BG_SWITCH_ST,
                  BgTable, HostBg)
from .phases import merge as PM
from .phases import move as PV
from .phases import split as PS

_PHASES = {
    BG_SPLIT_EXEC: PS.split_exec,
    BG_SPLIT_WAIT: PS.split_wait,
    BG_MOVE_SH: PV.move_sh,
    BG_MOVE_COPY: PV.move_copy,
    BG_MOVE_STABLE: PV.move_stable,
    BG_SWITCH_ST: PV.switch_st_phase,
    BG_SWITCH_REG: PV.switch_reg,
    BG_QUAR: PV.quarantine,
    BG_MERGE_EXEC: PM.merge_exec,
    BG_MERGE_WAIT: PM.merge_wait,
}
# a phase key outside the dispatch range would silently alias the no-op
# branch (the clip below) — refuse to import in that state
assert all(0 <= ph < BG_NUM_PHASES for ph in _PHASES), sorted(_PHASES)


def bg_step(h, hb, me, outbox, count, cfg: DiLiConfig):
    """Advance every background slot of ``hb`` (a ``HostBg``) by one phase
    this round against the shard's ``HostShard`` ``h``. The waiting
    phases (``MOVE_SH_WAIT``, ``SWITCH_ST_WAIT``) advance only through
    their acks' handlers, so they step as no-ops here."""
    for j in range(hb.slots):
        s = hb.slot(j)
        fn = _PHASES.get(min(max(s["phase"], 0), BG_NUM_PHASES - 1))
        if fn is not None:
            outbox, count = fn(h, s, me, j, outbox, count, cfg)
        s["round"] += 1
        hb.store(j, s)
    return outbox, count


# ============================================================ host commands

def _claim(hb, key_a: int, key_b=None):
    """First idle slot + whether ``key_a``/``key_b`` are unclaimed."""
    active = hb.f["phase"] != BG_IDLE

    def taken(k):
        return bool(np.any(active & ((hb.f["entry_key"] == k)
                                     | (hb.f["merge_key"] == k))))

    conflict = taken(key_a) or (key_b is not None and taken(key_b))
    j = int(np.argmin(active.astype(np.int32)))   # first idle slot, if any
    return j, (not active[j]) and not conflict


def _queue(table: BgTable, keys, **fields):
    hb = HostBg(table)
    j, ok = _claim(hb, *keys)
    if ok:
        hb.store(j, fields)
        table = hb.table()
    return table, ok


def queue_split(table: BgTable, entry_key, sitem_idx):
    """Host command: split ``entry`` (identified by keymax) at pool idx.
    Returns (table, ok)."""
    k = int(entry_key)
    return _queue(table, (k,), phase=BG_SPLIT_EXEC, entry_key=k,
                  sitem=int(sitem_idx), merge_key=SH_KEY)


def queue_move(table: BgTable, entry_key, target):
    """Host command: move ``entry`` (identified by keymax) to ``target``.
    Returns (table, ok)."""
    k = int(entry_key)
    return _queue(table, (k,), phase=BG_MOVE_SH, entry_key=k,
                  target=int(target), merge_key=SH_KEY)


def queue_merge(table: BgTable, left_keymax, right_keymax):
    """Host command: merge two adjacent sublists owned by this shard.
    Returns (table, ok)."""
    ka, kb = int(left_keymax), int(right_keymax)
    return _queue(table, (ka, kb), phase=BG_MERGE_EXEC, entry_key=ka,
                  merge_key=kb)
