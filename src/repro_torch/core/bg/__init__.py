"""Background operations: Split (§5.3), Move + Replay (§5.4), Switch
(Alg. 5), Merge (Appendix B) — as a slotted concurrent engine.

* ``fsm``      — phase constants, ``BgState``/``BgTable``, host inspection
                 helpers and the ``HostBg`` working copy;
* ``util``     — identity walks, the serial Replay insert, allocation and
                 registry lookups on the host;
* ``handlers`` — message handlers (replicates, move/switch acks, registry
                 broadcasts), slot-addressed where acks credit a slot;
* ``phases``   — per-phase step functions (``split``/``move``/``merge``);
* ``replay``   — the batched target-side replay of MoveItem runs, on the
                 device;
* ``engine``   — ``bg_step`` over the slot table + the claiming
                 ``queue_split/move/merge`` host commands.

``repro_torch.core.background`` re-exports this surface, as the
reference's ``repro.core.background`` does.
"""
from .engine import bg_step, queue_merge, queue_move, queue_split  # noqa: F401
from .fsm import (BG_IDLE, BG_MERGE_EXEC, BG_MERGE_WAIT,  # noqa: F401
                  BG_MOVE_COPY, BG_MOVE_SH, BG_MOVE_SH_WAIT, BG_MOVE_STABLE,
                  BG_NUM_PHASES, BG_QUAR, BG_SPLIT_EXEC, BG_SPLIT_WAIT,
                  BG_SWITCH_REG, BG_SWITCH_ST, BG_SWITCH_ST_WAIT, FL_MARKED,
                  FL_ST, BgState, BgTable, HostBg, active_moves, any_active,
                  claimed_keys, free_slots, init_bg_table, slot_phases)
from .handlers import (h_ack_delete, h_ack_insert, h_move_ack,  # noqa: F401
                       h_move_item, h_move_sh, h_move_sh_ack, h_reg_merged,
                       h_reg_split, h_rep_delete, h_rep_insert,
                       h_switch_server, h_switch_st, h_switch_st_ack)
from .replay import ReplayOut, replay_prepass  # noqa: F401
