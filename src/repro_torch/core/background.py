"""Compatibility shim: the background engine lives in
``repro_torch.core.bg`` (fsm / util / handlers / phases / replay /
engine). This module re-exports its surface under the reference's
``repro.core.background`` names."""
from .bg import (  # noqa: F401
    BG_IDLE, BG_MERGE_EXEC, BG_MERGE_WAIT, BG_MOVE_COPY, BG_MOVE_SH,
    BG_MOVE_SH_WAIT, BG_MOVE_STABLE, BG_NUM_PHASES, BG_QUAR, BG_SPLIT_EXEC,
    BG_SPLIT_WAIT, BG_SWITCH_REG, BG_SWITCH_ST, BG_SWITCH_ST_WAIT,
    FL_MARKED, FL_ST, BgState, BgTable, ReplayOut, active_moves, any_active,
    bg_step, claimed_keys, free_slots, h_ack_delete, h_ack_insert, h_move_ack,
    h_move_item, h_move_sh, h_move_sh_ack, h_reg_merged, h_reg_split,
    h_rep_delete, h_rep_insert, h_switch_server, h_switch_st,
    h_switch_st_ack, init_bg_table, queue_merge, queue_move, queue_split,
    replay_prepass, slot_phases)
from .bg.util import (  # noqa: F401
    find_by_identity as _find_by_identity,
    replay_insert as _replay_insert)
