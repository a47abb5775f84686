"""Background operations as a slotted engine — the Split part (§5.3).

* ``fsm``      — phase constants, ``BgState``/``BgTable``, host inspection
                 helpers and the ``HostBg`` working copy;
* ``util``     — registry lookups and node allocation on the host;
* ``handlers`` — the registry broadcast a Split sends (``h_reg_split``);
* ``phases``   — ``split_exec`` / ``split_wait``;
* ``replay``   — the batched move replay, as its gate;
* ``engine``   — ``bg_step`` and the ``queue_split`` host command.
"""
from .engine import bg_step, queue_merge, queue_move, queue_split  # noqa: F401
from .fsm import (BG_IDLE, BG_MERGE_EXEC, BG_MERGE_WAIT,  # noqa: F401
                  BG_MOVE_COPY, BG_MOVE_SH, BG_MOVE_SH_WAIT, BG_MOVE_STABLE,
                  BG_NUM_PHASES, BG_QUAR, BG_SPLIT_EXEC, BG_SPLIT_WAIT,
                  BG_SWITCH_REG, BG_SWITCH_ST, BG_SWITCH_ST_WAIT, FL_MARKED,
                  FL_ST, BgState, BgTable, HostBg, active_moves, any_active,
                  claimed_keys, free_slots, init_bg_table, slot_phases)
from .handlers import h_reg_split  # noqa: F401
from .replay import replay_prepass  # noqa: F401
