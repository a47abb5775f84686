"""``shard_round`` in both packages on the same rows, round by round: every
``RoundOut`` leaf (state, background table, outbox, completions, hit
counters, per-entry op counts) is equal bit for bit, with the packed-block
probe and both batched pre-passes switched on and off. Two background
Splits run through ``bg_step`` mid-stream, so the Split phases, the
packed-block invalidation around them and the blocks of the new entries
are covered too."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import bg as JB
from repro.core import shard as JS
from repro.core import types as JT
from repro_torch.core import bg as TB
from repro_torch.core import messages as TM
from repro_torch.core import shard as TS
from repro_torch.core import types as TT
from repro_torch.core.sim import chain_keys, make_op_row

from torch_parity import assert_trees_equal

BASE = dict(num_shards=1, pool_capacity=1024, max_sublists=16, max_ctrs=16,
            max_scan=1024, batch_size=16, mailbox_cap=64, split_threshold=48)
ROUNDS = 20
SPLIT_AT = (6, 13)
IN_CAP = 32


def _rows(rng, round_no, n):
    kinds = rng.choice([TT.OP_FIND, TT.OP_INSERT, TT.OP_REMOVE], n,
                       p=[0.5, 0.3, 0.2])
    keys = rng.integers(1, 140, n)
    return np.stack([make_op_row(0, int(k), int(x), int(x) * 3,
                                 round_no * 100 + i)
                     for i, (k, x) in enumerate(zip(kinds, keys))])


def _split_cmd(state, cfg):
    """(entry keymax, middle item) of the largest owned entry."""
    reg = state.registry
    size = int(reg.size)
    best = None
    for e in range(size):
        head = int(reg.subhead[e]) & 0x3FFFFF
        items = chain_keys(cfg, [state], 0, head, include_meta=True)
        if best is None or len(items) > best[0]:
            best = (len(items), int(reg.keymax[e]), items[len(items) // 2][1])
    return best[1], best[2]


@pytest.mark.parametrize("flags", [
    dict(block_probe=True, find_fastpath=True, mut_fastpath=True),
    dict(block_probe=False, find_fastpath=True, mut_fastpath=True),
    dict(block_probe=True, find_fastpath=True, mut_fastpath=False),
    dict(block_probe=False, find_fastpath=False, mut_fastpath=False),
], ids=["blk+find+mut", "find+mut", "blk+find", "serial"])
def test_shard_round_matches_round_by_round(flags):
    jcfg = JT.DiLiConfig(**BASE, **flags)
    tcfg = TT.DiLiConfig(**BASE, **flags)
    j_state = JT.init_shard(jcfg, 0, bootstrap=True)
    j_bg = JB.init_bg_table(jcfg)
    t_state = TT.init_shard(tcfg, 0, bootstrap=True, device="cpu")
    t_bg = TB.init_bg_table(tcfg, device="cpu")

    rng = np.random.default_rng(5)
    inbox = np.zeros((IN_CAP, TM.FIELDS), np.int32)
    totals = dict(fast_hits=0, mut_hits=0, blk_hits=0, splits=0)
    for r in range(ROUNDS):
        client = _rows(rng, r, tcfg.batch_size)
        if r in SPLIT_AT:
            kmax, sitem = _split_cmd(t_state, tcfg)
            j_bg, j_ok = JB.queue_split(j_bg, kmax, sitem)
            t_bg, t_ok = TB.queue_split(t_bg, kmax, sitem)
            assert bool(j_ok) and t_ok
        j_out = JS.shard_round(j_state, j_bg, 0, jnp.asarray(inbox),
                               jnp.asarray(client), jcfg)
        t_out = TS.shard_round(t_state, t_bg, 0, inbox, client, tcfg)
        assert_trees_equal(j_out, t_out, f"round {r}: RoundOut")
        j_state, j_bg = j_out.state, j_out.bg
        t_state, t_bg = t_out.state, t_out.bg
        for k in ("fast_hits", "mut_hits", "blk_hits"):
            totals[k] += int(getattr(t_out, k))
        # one shard: its outbox rows are retries addressed to itself
        cnt = int(t_out.out_count)
        assert cnt <= IN_CAP
        inbox = np.zeros((IN_CAP, TM.FIELDS), np.int32)
        inbox[:cnt] = t_out.outbox.numpy()[:cnt]

    assert int(t_state.registry.size) == 1 + len(SPLIT_AT)
    if flags["find_fastpath"]:
        assert totals["fast_hits"] > 0
    if flags["mut_fastpath"]:
        assert totals["mut_hits"] > 0
    assert (totals["blk_hits"] > 0) == flags["block_probe"]
