"""Background FSM state: phases, flags, and the slotted ``BgTable``.

A shard runs up to ``cfg.bg_slots`` background operations; its table is a
``BgState`` whose leaves are ``[bg_slots]`` int32 tensors (refs as int32
bit patterns). Phase graph and claim discipline as in the reference
(DESIGN.md §10)::

   IDLE -> SPLIT_EXEC -> SPLIT_WAIT -> IDLE
   IDLE -> MOVE_SH -> MOVE_SH_WAIT -> MOVE_COPY -> MOVE_STABLE
        -> SWITCH_ST [-> SWITCH_ST_WAIT] -> SWITCH_REG -> QUAR -> IDLE
   IDLE -> MERGE_EXEC -> MERGE_WAIT -> IDLE          (Appendix B)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import refs
from ..host import to_numpy as _np
from ..types import DiLiConfig, SH_KEY, resolve_device

# ------------------------------------------------------------------ phases
BG_IDLE = 0
BG_SPLIT_EXEC = 1
BG_SPLIT_WAIT = 2
BG_MOVE_SH = 3
BG_MOVE_SH_WAIT = 4
BG_MOVE_COPY = 5
BG_MOVE_STABLE = 6
BG_SWITCH_ST = 7
BG_SWITCH_ST_WAIT = 8
BG_SWITCH_REG = 9
BG_QUAR = 10
BG_MERGE_EXEC = 11
BG_MERGE_WAIT = 12
BG_NUM_PHASES = 13

# MOVE_ITEM / MOVE_ACK flag bits (message field F_A)
FL_MARKED = 1
FL_ST = 2


class BgState(NamedTuple):
    """One shard's slotted table: every leaf is an int32 ``[bg_slots]``
    tensor (same fields and order as the reference)."""
    phase: torch.Tensor
    entry_key: torch.Tensor
    target: torch.Tensor
    sitem: torch.Tensor
    cursor: torch.Tensor
    send_prev: torch.Tensor
    sent: torch.Tensor
    acked: torch.Tensor
    st_sent: torch.Tensor
    st_acked: torch.Tensor
    sh_star: torch.Tensor
    st_star: torch.Tensor
    old_head: torch.Tensor
    quar_round: torch.Tensor
    round: torch.Tensor
    new_slot: torch.Tensor
    old_slot: torch.Tensor
    split_key: torch.Tensor
    sh_new: torch.Tensor
    st_new: torch.Tensor
    old_keymax: torch.Tensor
    merge_key: torch.Tensor


BgTable = BgState

# initial value of each field (all others 0)
_INIT = {"sh_star": refs.NULL_REF, "st_star": refs.NULL_REF,
         "merge_key": SH_KEY}


def init_bg_table(cfg: DiLiConfig, device="cuda") -> BgTable:
    """Fresh all-idle table of ``cfg.bg_slots`` background slots."""
    device = resolve_device(device)
    return BgState(*(torch.full((cfg.bg_slots,), _INIT.get(f, 0),
                                dtype=torch.int32, device=device)
                     for f in BgState._fields))


# ----------------------------------------------------- host-side inspection

def slot_phases(table: BgTable) -> np.ndarray:
    return _np(table.phase)


def any_active(table: BgTable) -> bool:
    """True if any slot is running a background op."""
    return bool((slot_phases(table) != BG_IDLE).any())


def free_slots(table: BgTable) -> int:
    return int((slot_phases(table) == BG_IDLE).sum())


def claimed_keys(table: BgTable):
    """Registry-entry keymaxes currently claimed by active slots."""
    phases = slot_phases(table).reshape(-1)
    ek = _np(table.entry_key).reshape(-1)
    mk = _np(table.merge_key).reshape(-1)
    out = set()
    for ph, a, b in zip(phases, ek, mk):
        if ph != BG_IDLE:
            out.add(int(a))
            if int(b) != SH_KEY:
                out.add(int(b))
    return out


def active_moves(table: BgTable):
    """(entry_keymax, target) of every in-flight Move whose registry
    transfer has not landed yet."""
    phases = slot_phases(table).reshape(-1)
    ek = _np(table.entry_key).reshape(-1)
    tg = _np(table.target).reshape(-1)
    pre_transfer = {BG_MOVE_SH, BG_MOVE_SH_WAIT, BG_MOVE_COPY,
                    BG_MOVE_STABLE, BG_SWITCH_ST, BG_SWITCH_ST_WAIT,
                    BG_SWITCH_REG}
    return [(int(k), int(t)) for ph, k, t in zip(phases, ek, tg)
            if int(ph) in pre_transfer]


class HostBg:
    """Host copy of one shard's BgTable: one numpy int32 row per field."""

    def __init__(self, table: BgState):
        self.device = table.phase.device
        self.arr = _np(torch.stack(list(table))).copy()
        self.f = dict(zip(BgState._fields, self.arr))

    @property
    def slots(self) -> int:
        return self.arr.shape[1]

    def slot(self, j: int) -> dict:
        return {k: int(v[j]) for k, v in self.f.items()}

    def store(self, j: int, s: dict) -> None:
        for k, v in s.items():
            self.f[k][j] = v

    def table(self) -> BgState:
        t = torch.from_numpy(self.arr).to(self.device)
        return BgState(*t.unbind(0))
