"""The port's skip-list baseline against the reference, bit for bit.

The reference's ``tests/test_skiplist.py`` workloads (seeds 0-2, slot
reuse) go through both packages batch by batch; after every batch the
results and every ``SkipList`` field — the stale ``nxt`` rows and heights
of removed nodes included — must be equal. Also: capacity exhaustion,
kinds other than FIND/INSERT/REMOVE (``OP_NOP`` and an unknown kind),
``_key_height`` over a sweep with negative keys and the int32 extremes,
and the chip smoke's fig3a skip-list digests (``SKIPLIST_EXPECTED``),
recomputed from the reference with ``benchmarks/run.py::fig3a``'s loop
and from the port on the CPU with the smoke's own run.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as P
from repro.core import skiplist as JS
from repro.core.oracle import OracleList
from repro.core.types import OP_FIND, OP_INSERT, OP_NOP, OP_REMOVE
from repro_torch.core import skiplist as TS

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEVELS = 8


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


def _both(capacity, levels=LEVELS):
    return (JS.init(capacity=capacity, max_level=levels),
            TS.init(capacity, levels, device="cpu"))


def _step(levels):
    return jax.jit(lambda s, k, x: JS.apply_batch(s, k, x, levels))


def _run_batches(batches, capacity, levels=LEVELS):
    """Every batch through both packages; equal after each. Returns the
    port's results per batch and its final state."""
    js, ts = _both(capacity, levels)
    step = _step(levels)
    out = []
    for i, (kinds, keys) in enumerate(batches):
        kinds = np.asarray(kinds, np.int32)
        keys = np.asarray(keys, np.int32)
        js, rj = step(js, kinds, keys)
        ts, rt = TS.apply_batch(ts, kinds, keys, levels)
        assert rt.dtype == torch.int32 and rt.device.type == "cpu"
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj),
                                      err_msg=f"results of batch {i}")
        P.assert_trees_equal(js, ts, what=f"batch {i}: SkipList")
        out.append(rt.numpy())
    return out, ts


def _chain(sl):
    nxt, key = sl.nxt.numpy(), sl.key.numpy()
    out, node = [], int(nxt[0, TS.HEAD])
    while node != TS.NIL:
        out.append(int(key[node]))
        node = int(nxt[0, node])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skiplist_workload_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], n,
                       p=[0.2, 0.5, 0.3]).astype(np.int32)
    keys = rng.integers(1, 200, n).astype(np.int32)
    # the reference test's one batch of 400, cut in four here so the
    # states are compared between batches too
    res, ts = _run_batches([(kinds[i:i + 100], keys[i:i + 100])
                            for i in range(0, n, 100)], capacity=2048)
    oracle = OracleList()
    assert [bool(r) for r in np.concatenate(res)] == \
        oracle.apply_batch(kinds, keys)
    assert _chain(ts) == sorted(oracle.snapshot())


def test_skiplist_reuse_slots_matches_reference():
    ks = list(range(1, 31))
    res, ts = _run_batches([([OP_INSERT] * 30, ks), ([OP_REMOVE] * 30, ks),
                            ([OP_INSERT] * 30, ks)], capacity=64)
    assert all(all(r) for r in res)
    assert int(ts.alloc_top) <= 31      # slots recycled (LIFO free list)


def test_skiplist_capacity_exhaustion_matches_reference():
    # 16 slots (HEAD + 15): inserts past them answer False and change
    # nothing; removes free slots that the next inserts pop
    ins = list(range(100, 130))
    res, ts = _run_batches([([OP_INSERT] * 30, ins),
                            ([OP_REMOVE] * 5, ins[:5]),
                            ([OP_INSERT] * 10, ins[20:30]),
                            ([OP_FIND] * 30, ins)], capacity=16)
    assert res[0].tolist() == [1] * 15 + [0] * 15
    assert res[2].tolist() == [1] * 5 + [0] * 5
    assert int(ts.alloc_top) == 16 and int(ts.free_top) == 0


def test_skiplist_other_kinds_leave_state_and_answer_presence():
    rng = np.random.default_rng(5)
    kinds = rng.choice([OP_NOP, OP_FIND, OP_INSERT, OP_REMOVE, 7], 300,
                       p=[0.15, 0.15, 0.4, 0.2, 0.1]).astype(np.int32)
    keys = rng.integers(-40, 40, 300).astype(np.int32)
    res, _ = _run_batches([(kinds[i:i + 60], keys[i:i + 60])
                           for i in range(0, 300, 60)], capacity=256)
    # OP_NOP and kind 7 answer like FIND: the key's presence
    oracle = OracleList()
    for kind, key, r in zip(kinds, keys, np.concatenate(res)):
        if kind in (OP_NOP, 7):
            assert bool(r) == oracle.find(int(key))
        else:
            assert bool(r) == oracle.apply(int(kind), int(key))


def test_key_height_sweep_matches_reference():
    i32 = np.iinfo(np.int32)
    keys = np.concatenate([
        np.array([i32.min, i32.min + 1, i32.max, i32.max - 1, -1, 0, 1],
                 np.int64),
        np.arange(-3000, 3000),
        np.random.default_rng(0).integers(i32.min, i32.max, 4000,
                                          dtype=np.int64)]).astype(np.int32)
    for levels in (1, 2, 8, 14, 32):
        ref = np.asarray(JS._key_height(jnp.asarray(keys), levels))
        got = np.array([TS._key_height(int(k), levels) for k in keys])
        np.testing.assert_array_equal(got, ref, err_msg=f"L={levels}")


def test_skiplist_extreme_keys_match_reference():
    i32 = np.iinfo(np.int32)
    ks = [i32.max, i32.min + 1, -1, 0, 5, i32.max - 1, -7]
    _run_batches([([OP_INSERT] * len(ks), ks), ([OP_FIND] * len(ks), ks),
                  ([OP_REMOVE] * 3, ks[:3]), ([OP_INSERT] * 3, ks[:3])],
                 capacity=32, levels=14)


def test_single_op_functions_match_reference():
    js, ts = _both(64)
    rng = np.random.default_rng(9)
    for kind, key in zip(rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 60),
                         rng.integers(0, 30, 60)):
        if kind == OP_FIND:
            r_j = JS.find(js, jnp.int32(key), LEVELS)
            r_t = TS.find(ts, int(key), LEVELS)
        elif kind == OP_INSERT:
            js, r_j = JS.insert(js, jnp.int32(key), LEVELS)
            ts, r_t = TS.insert(ts, int(key), LEVELS)
        else:
            js, r_j = JS.remove(js, jnp.int32(key), LEVELS)
            ts, r_t = TS.remove(ts, int(key), LEVELS)
        assert bool(r_j) == r_t
        P.assert_trees_equal(js, ts, what=f"{kind} {key}: SkipList")


def _reference_fig3a(read_pct):
    """benchmarks/run.py::fig3a's skip-list loop: the load in one batch,
    the mix in batches of 64."""
    from repro.data.ycsb import load_phase, mixed_phase
    load_kinds, load_keys = load_phase(2000, 8000, seed=1)
    kinds, keys = mixed_phase(4000, 8000, read_pct / 100, seed=2)
    sl = JS.init(capacity=SMOKE.SKIP["capacity"],
                 max_level=SMOKE.SKIP["levels"])
    step = _step(SMOKE.SKIP["levels"])
    sl, r_load = step(sl, jnp.asarray(load_kinds), jnp.asarray(load_keys))
    res = []
    for i in range(0, len(kinds), SMOKE.SKIP["batch"]):
        sl, r = step(sl, jnp.asarray(kinds[i:i + SMOKE.SKIP["batch"]]),
                     jnp.asarray(keys[i:i + SMOKE.SKIP["batch"]]))
        res.append(np.asarray(r))
    return SMOKE.skiplist_digest(np.asarray(r_load), np.concatenate(res),
                                 jax.tree_util.tree_map(np.asarray, sl))


@pytest.mark.parametrize("read_pct", [10, 50, 90])
def test_fig3a_skiplist_digest_equals_smoke_constant(read_pct):
    ref = _reference_fig3a(read_pct)
    run = SMOKE.skiplist_run(read_pct, device="cpu")
    assert run["digest"] == ref == SMOKE.SKIPLIST_EXPECTED[read_pct]
