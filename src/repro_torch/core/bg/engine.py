"""The slotted background engine: per-round slot stepping + host commands.

``bg_step`` advances every slot of a shard's table by one phase per round,
in slot order (slot j+1 sees slot j's writes), as the reference's
``lax.scan`` over slots does. It runs on the round's host working copies.
This slice steps the Split phases; any other active phase raises, naming
the slice that ports it.

``queue_split`` is the host command that claims the first idle slot unless
the named registry entry is already claimed (DESIGN.md §10).
"""
from __future__ import annotations

import numpy as np

from ..types import DiLiConfig, SH_KEY
from .fsm import (BG_IDLE, BG_NUM_PHASES, BG_SPLIT_EXEC, BG_SPLIT_WAIT,
                  BgTable, HostBg)
from .phases import split as PS

_PHASES = {
    BG_SPLIT_EXEC: PS.split_exec,
    BG_SPLIT_WAIT: PS.split_wait,
}

LATER_SLICE = ("the Move/Merge/Switch slice of the port (ROADMAP Queue 1 "
               "item 7)")


def bg_step(h, hb, me, outbox, count, cfg: DiLiConfig):
    """Advance every background slot of ``hb`` (a ``HostBg``) by one phase
    this round against the shard's ``HostShard`` ``h``."""
    for j in range(hb.slots):
        s = hb.slot(j)
        ph = min(max(s["phase"], 0), BG_NUM_PHASES - 1)
        if ph != BG_IDLE:
            fn = _PHASES.get(ph)
            if fn is None:
                raise NotImplementedError(
                    f"background phase {ph} is not ported yet: it comes "
                    f"with {LATER_SLICE}")
            outbox, count = fn(h, s, me, j, outbox, count, cfg)
        s["round"] += 1
        hb.store(j, s)
    return outbox, count


def _claim(hb, key_a: int):
    """First idle slot + whether ``key_a`` is unclaimed."""
    active = hb.f["phase"] != BG_IDLE
    conflict = bool(np.any(active & ((hb.f["entry_key"] == key_a)
                                     | (hb.f["merge_key"] == key_a))))
    j = int(np.argmin(active.astype(np.int32)))   # first idle slot, if any
    return j, (not active[j]) and not conflict


def queue_split(table: BgTable, entry_key: int, sitem_idx: int):
    """Host command: split ``entry`` (identified by keymax) at pool idx.
    Returns (table, ok)."""
    hb = HostBg(table)
    j, ok = _claim(hb, int(entry_key))
    if ok:
        hb.store(j, dict(phase=BG_SPLIT_EXEC, entry_key=int(entry_key),
                         sitem=int(sitem_idx), merge_key=SH_KEY))
        table = hb.table()
    return table, ok


def queue_move(table: BgTable, entry_key, target):
    raise NotImplementedError(f"Move comes with {LATER_SLICE}")


def queue_merge(table: BgTable, left_keymax, right_keymax):
    raise NotImplementedError(f"Merge comes with {LATER_SLICE}")
