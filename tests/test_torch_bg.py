"""Move, Switch and the batched replay: the port against the reference,
bit for bit, on the CPU.

B1  The Move workloads of ``tests/test_background.py`` (a quiet move,
    moves under write load and under channel delays, a split then a move
    of each half over three shards) through both packages: op results,
    final key sets, stats, round counts, sublists and a digest of every
    shard's state and background table after every round agree, and the
    port passes the reference test's own oracle checks.
B2  ``bg.replay_prepass`` called directly on a target shard's state and
    the MSG_MOVE_ITEMS rows a live move delivers to it: one eligible run,
    one run bounced by broken contiguity, one round bounced by the lane
    gate (``_MAX_LANES``). The handled mask, the state and the outbox
    equal the reference's.
B3  The ``core.background`` shim re-exports the engine's surface, and
    every phase fits the dispatch table.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core.bg as JBG
import repro.core.messages as JM
import repro.core.sim as JSIM
import repro.core.types as JT
import repro_torch.core.background as TBACK
import repro_torch.core.bg as TBG
import repro_torch.core.types as TT
from repro_torch import convert
from repro_torch.core import messages as TM
from repro_torch.core.bg import engine as TENG
from repro_torch.core.bg import replay as TREP

import torch_bg_workloads as W
from torch_parity import assert_trees_equal


# ------------------------------------------------------------------ B1

@pytest.mark.parametrize("workload,args", [
    (W.move_quiet, ()),
    (W.move_under_write_load, (0,)),
    (W.move_under_write_load, (1,)),
    (W.move_under_write_load, (2,)),
    (W.move_with_channel_delays, (0,)),
    (W.move_with_channel_delays, (1,)),
    (W.split_then_move_each_half, ()),
], ids=["quiet", "write_load_0", "write_load_1", "write_load_2",
        "delays_0", "delays_1", "split_then_move"])
def test_move_workload_matches_reference(workload, args):
    ref, got = W.run(workload, *args)
    W.assert_same(ref, got)
    # non-vacuous: ownership changed hands
    assert any(e["owner"] != 0 for e in got["sublists"][0])


# ------------------------------------------------------------------ B2

def _move_round():
    """A reference cluster paused at the first round whose inbox at shard
    1 holds MSG_MOVE_ITEMS rows: (cfg kwargs, target state, inbox)."""
    kw = dict(W.BG, move_batch=8)
    cl = JSIM.Cluster(JT.DiLiConfig(**kw))
    keys = list(range(5, 125, 3))
    cl.submit(0, [JT.OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    assert cl.move(0, cl.sublists(0)[0]["keymax"], 1)
    for _ in range(20):
        if (cl.backlog[1][:, JM.F_KIND] == JM.MSG_MOVE_ITEMS).any():
            break
        cl.step()
    rows = cl.backlog[1][:cl.in_cap]
    assert (rows[:, JM.F_KIND] == JM.MSG_MOVE_ITEMS).sum() == 8
    inbox = np.zeros((cl.in_cap, JM.FIELDS), np.int32)
    inbox[:rows.shape[0]] = rows
    return kw, cl.states[1], inbox


def _break_contiguity(inbox):
    rows = inbox.copy()
    mv = np.nonzero(rows[:, TM.F_KIND] == TM.MSG_MOVE_ITEMS)[0]
    rows[mv[3], TM.F_X3] += 1        # lane 3's predecessor is not lane 2
    return rows


def _past_lane_gate(inbox):
    mv = inbox[inbox[:, TM.F_KIND] == TM.MSG_MOVE_ITEMS]
    extra = np.repeat(mv, -(-(TREP._MAX_LANES + 1 - len(mv)) // len(mv)),
                      axis=0)
    extra[:, TM.F_SLOT] = 1           # another channel's run
    rows = np.concatenate([mv, extra])[:TREP._MAX_LANES + 1]
    return np.concatenate([rows, np.zeros((7, TM.FIELDS), np.int32)])


@pytest.mark.parametrize("case", ["eligible", "contiguity", "lane_gate"])
def test_replay_prepass_matches_reference(case):
    kw, j_state, inbox = _move_round()
    rows = {"eligible": inbox, "contiguity": _break_contiguity(inbox),
            "lane_gate": _past_lane_gate(inbox)}[case]
    j_cfg, t_cfg = JT.DiLiConfig(**kw), TT.DiLiConfig(**kw)
    ob_j, ct_j = JM.empty_outbox(kw["mailbox_cap"])
    j_out = JBG.replay_prepass(j_state, jnp.asarray(rows), 1, ob_j, ct_j,
                               j_cfg)
    t_state = convert.shard_state_from_numpy(
        convert.shard_state_to_numpy(j_state), device="cpu")
    ob_t, ct_t = TM.empty_outbox(kw["mailbox_cap"])
    import torch
    t_out = TBG.replay_prepass(t_state, torch.from_numpy(rows), 1, ob_t,
                               ct_t, t_cfg)
    handled = np.asarray(j_out.handled)
    np.testing.assert_array_equal(t_out.handled, handled)
    assert int(t_out.count) == int(j_out.count)
    np.testing.assert_array_equal(t_out.outbox, np.asarray(j_out.outbox))
    assert_trees_equal(j_out.state, t_out.state)
    n_mv = int((rows[:, TM.F_KIND] == TM.MSG_MOVE_ITEMS).sum())
    if case == "eligible":
        assert handled.sum() == n_mv == 8
    elif case == "contiguity":
        assert handled.sum() == 0      # the run bounces whole
    else:
        assert n_mv > TREP._MAX_LANES and handled.sum() == 0


# ------------------------------------------------------------------ B3

def test_background_shim_reexports():
    for name in ("BgState", "BgTable", "init_bg_table", "bg_step",
                 "queue_split", "queue_move", "queue_merge",
                 "h_rep_insert", "h_rep_delete", "h_ack_insert",
                 "h_ack_delete", "h_move_sh", "h_move_sh_ack",
                 "h_move_item", "h_move_ack", "h_switch_st",
                 "h_switch_st_ack", "h_reg_split", "h_switch_server",
                 "h_reg_merged", "replay_prepass", "ReplayOut", "BG_IDLE",
                 "BG_SPLIT_EXEC", "BG_SPLIT_WAIT", "BG_MOVE_SH",
                 "BG_MOVE_SH_WAIT", "BG_MOVE_COPY", "BG_MOVE_STABLE",
                 "BG_SWITCH_ST", "BG_SWITCH_ST_WAIT", "BG_SWITCH_REG",
                 "BG_QUAR", "BG_MERGE_EXEC", "BG_MERGE_WAIT",
                 "BG_NUM_PHASES", "FL_MARKED", "FL_ST", "any_active",
                 "free_slots", "claimed_keys", "slot_phases",
                 "active_moves"):
        assert hasattr(TBACK, name), f"shim lost {name}"
        assert getattr(TBACK, name) is getattr(TBG, name), name
        assert hasattr(JBG, name), name          # the reference's surface
    assert all(0 <= ph < TBACK.BG_NUM_PHASES for ph in TENG._PHASES)
    # every phase the reference steps, the port steps
    from repro.core.bg.engine import _PHASES as J_PHASES
    assert sorted(TENG._PHASES) == sorted(J_PHASES)
    assert TBACK.init_bg_table(TT.DiLiConfig(bg_slots=5),
                               device="cpu").phase.shape == (5,)
