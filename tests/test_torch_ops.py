"""The serial op path (``ops.apply_op`` over ``traverse.search``): the
workloads of ``tests/test_core_ops.py`` through both packages give the
same results, the same messages and the same state arrays, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import messages as JM
from repro.core import refs as JREFS
from repro.core.ops import apply_op as j_apply_op
from repro.core.oracle import OracleList
from repro.core.types import DiLiConfig as JC, init_shard as j_init_shard
from repro_torch.core import messages as TM
from repro_torch.core import refs as TREFS
from repro_torch.core.host import HostShard
from repro_torch.core.ops import apply_op as t_apply_op
from repro_torch.core.types import (DiLiConfig as TC, OP_FIND, OP_INSERT,
                                    OP_REMOVE, init_shard as t_init_shard)

from torch_parity import assert_trees_equal

KW = dict(num_shards=1, pool_capacity=1024, max_sublists=16, max_ctrs=16,
          max_scan=1024, batch_size=32, mailbox_cap=64)


@jax.jit
def _j_batch(state, kinds, keys):
    cfg = JC(**KW)

    def step(carry, x):
        st, ob, ct = carry
        kind, key = x
        row = JM.make_row(JM.MSG_OP, 0, 0, a=kind, key=key,
                          ref1=JM.ref2i(JREFS.null_ref()), sid=0, ts=0)
        out = j_apply_op(st, 0, row, ob, ct, cfg)
        return (out.state, out.outbox, out.count), out.result

    ob, ct = JM.empty_outbox(cfg.mailbox_cap)
    (state, ob, ct), res = jax.lax.scan(step, (state, ob, ct), (kinds, keys))
    return state, res, ob, ct


def run_both(kinds, keys):
    kinds = np.asarray(kinds, np.int32)
    keys = np.asarray(keys, np.int32)
    j_state, j_res, j_ob, j_ct = _j_batch(
        j_init_shard(JC(**KW), 0, bootstrap=True), jnp.asarray(kinds),
        jnp.asarray(keys))

    cfg = TC(**KW)
    h = HostShard(t_init_shard(cfg, 0, bootstrap=True, device="cpu"))
    ob, ct = TM.empty_outbox(cfg.mailbox_cap)
    res = []
    for kind, key in zip(kinds, keys):
        row = TM.make_row(TM.MSG_OP, 0, 0, a=int(kind), key=int(key),
                          ref1=TREFS.NULL_REF, sid=0, ts=0)
        r, ob, ct = t_apply_op(h, 0, row, ob, ct, cfg)
        res.append(r)
    t_state = h.commit()

    assert res == np.asarray(j_res).tolist()
    assert ct == int(j_ct)
    np.testing.assert_array_equal(ob, np.asarray(j_ob))
    assert_trees_equal(j_state.pool, t_state.pool, "pool")
    assert_trees_equal(j_state, t_state)
    return res, t_state


def test_insert_find_remove_basic():
    kinds = [OP_INSERT, OP_INSERT, OP_INSERT, OP_FIND, OP_FIND,
             OP_REMOVE, OP_FIND, OP_INSERT, OP_REMOVE, OP_REMOVE]
    keys = [10, 5, 20, 5, 7, 5, 5, 5, 5, 99]
    res, _ = run_both(kinds, keys)
    assert [bool(r) for r in res] == OracleList().apply_batch(kinds, keys)


def test_duplicate_inserts_and_reinserts():
    kinds = [OP_INSERT] * 4 + [OP_REMOVE, OP_INSERT, OP_FIND]
    keys = [42, 42, 41, 43, 42, 42, 42]
    res, _ = run_both(kinds, keys)
    assert [bool(r) for r in res] == [True, False, True, True,
                                      True, True, True]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_stream_matches(seed):
    rng = np.random.default_rng(seed)
    n = 200
    kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], size=n,
                       p=[0.3, 0.4, 0.3]).astype(np.int32)
    keys = rng.integers(1, 40, size=n).astype(np.int32)
    res, _ = run_both(kinds, keys)
    assert [bool(r) for r in res] == OracleList().apply_batch(kinds, keys)


def test_free_list_reuse():
    kinds = [OP_INSERT] * 8 + [OP_REMOVE] * 8 + [OP_FIND] * 8 + \
        [OP_INSERT] * 8
    keys = list(range(1, 9)) * 4
    res, state = run_both(kinds, keys)
    assert all(res[:16]) and not any(res[16:24]) and all(res[24:])
    assert int(state.alloc_top) <= 2 + 8 + 8
