"""RANGE scans: the port against the reference, bit for bit, on one shard
with splits (Move is not ported, so the list is spread over several
sublists of one shard instead of several shards).

R1  The boundary matrix of ``tests/test_range_scan.py``: empty, singleton,
    full-space and cross-sublist spans, limit truncation. Items, counts,
    ``range_hits``, rounds and the shard's state digest agree.
R2  The bad-argument guards raise as the reference's do.
R3  Span holds: a mutation queued after a scan into its span is held
    until the scan resolves; one queued before is in the snapshot.
R4  A seeded differential of mixed point ops and scans under the
    balancer's splits, with a small ``range_batch`` and ``block_cap`` so
    both the block pre-pass and the serial walk serve (and truncate)
    segments: every result, every scan's items, the stats and the round
    count agree, and the final key set equals the oracle's.
"""
import numpy as np
import pytest

import repro.api as JA
import repro.core.balancer as JBAL
import repro.core.types as JT
import repro_torch.api as TA
import repro_torch.core.balancer as TBAL
import repro_torch.core.types as TT
from repro.core.oracle import OracleList

from torch_parity import digest

PKGS = {"jax": (JA, JT, JBAL, {}),
        "torch": (TA, TT, TBAL, dict(device="cpu"))}


def _cfg(types, **kw):
    base = dict(num_shards=1, pool_capacity=4096, max_sublists=32,
                max_ctrs=32, max_scan=4096, batch_size=16, mailbox_cap=256,
                move_batch=8, range_scan=True)
    base.update(kw)
    return types.DiLiConfig(**base)


def _client(pkg, seed=7, **kw):
    api, types, _, extra = PKGS[pkg]
    return api.DiLiClient(api.LocalBackend(_cfg(types, **kw), seed=seed,
                                           **extra))


def _split_client(pkg, keys, values, n_splits=3):
    """One shard whose list is cut into ``n_splits + 1`` sublists."""
    c = _client(pkg)
    c.insert_batch(keys, values).results()
    for _ in range(n_splits):
        subs = [e for e in c.backend.sublists(0) if e["size"] is not None]
        big = max(subs, key=lambda e: e["size"])
        mid = c.backend.middle_item(0, big["head_idx"])
        assert c.backend.split(0, big["keymax"], mid)
        c.drain()
    assert len(c.backend.sublists(0)) == n_splits + 1
    return c


def _boundary_run(pkg):
    keys = list(range(10, 610, 5))
    vals = [k * 7 for k in keys]
    c = _split_client(pkg, keys, vals)
    types = PKGS[pkg][1]
    lo_all, hi_all = types.KEY_MIN, types.KEY_MAX + 1
    spans = [(0, 10), (11, 15), (700, 9000), (50, 50), (60, 40),
             (10, 11), (605, 606), (10, 15), (11, 16),
             (lo_all, hi_all), (200, 400),
             (lo_all, hi_all, 7), (200, 400, 1)]
    out = []
    for sp in spans:
        lo, hi = sp[:2]
        limit = sp[2] if len(sp) > 2 else 10_000
        r = c.range(lo, hi, limit)
        out.append((r.items(), r.count()))
    return out, dict(c.backend.stats), digest(c.backend.states), \
        dict(zip(keys, vals))


def test_range_boundary_matrix_matches_reference():
    ref, ref_stats, ref_dig, kv = _boundary_run("jax")
    got, got_stats, got_dig, _ = _boundary_run("torch")
    assert got == ref
    assert got_stats == ref_stats
    assert got_dig == ref_dig
    # and the matrix itself, as the reference suite states it
    items = [it for it, _ in got]
    assert items[:5] == [[]] * 5
    assert items[5] == [(10, 70)] and items[6] == [(605, 4235)]
    assert items[7] == [(10, 70)] and items[8] == [(15, 105)]
    assert items[9] == sorted(kv.items())
    expect = [(k, kv[k]) for k in sorted(kv) if 200 <= k < 400]
    assert items[10] == expect
    assert items[11] == sorted(kv.items())[:7]
    assert items[12] == expect[:1]
    assert got_stats["range_hits"] > 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_range_rejects_bad_args(pkg):
    api, types, _, extra = PKGS[pkg]
    c = _client(pkg, seed=1)
    with pytest.raises(ValueError):
        c.range(0, 10, limit=0)
    with pytest.raises(ValueError):
        c.backend.submit_range(0, types.KEY_MIN - 2, 10, 5)
    with pytest.raises(ValueError):
        c.backend.submit_range(0, 0, types.KEY_MAX + 2, 5)
    off = api.DiLiClient(api.LocalBackend(types.DiLiConfig(num_shards=1),
                                          seed=1, **extra))
    with pytest.raises(ValueError):
        off.range(0, 10)
    with pytest.raises(ValueError):
        off.backend.submit_range(0, 0, 10, 5)


def _span_hold_run(pkg):
    c = _client(pkg, seed=3)
    c.insert_batch(list(range(0, 200, 2))).results()
    ins = c.insert(101)            # queued first: in the snapshot
    r = c.range(0, 200, limit=500)
    rm = c.remove(100)             # queued after: held until r resolves
    c.drain()
    got = r.keys(wait=False)
    return (got, ins.result(wait=False), rm.result(wait=False),
            c.find(100).result(), dict(c.backend.stats))


def test_range_span_hold_orders_mutations():
    ref = _span_hold_run("jax")
    got = _span_hold_run("torch")
    assert got == ref
    keys, ins, rm, found, _ = got
    assert 101 in keys and 100 in keys
    assert ins is True and rm is True and found is False


def _differential(pkg, seed):
    api, types, bal, extra = PKGS[pkg]
    cfg = _cfg(types, range_batch=8, block_cap=24, split_threshold=24)
    backend = api.LocalBackend(cfg, seed=seed, **extra)
    c = api.DiLiClient(backend, balance=bal.Balancer(backend))
    rng = np.random.default_rng(seed)
    futs = []
    for batch in range(12):
        kinds = rng.choice([types.OP_FIND, types.OP_INSERT,
                            types.OP_REMOVE], 24, p=[0.3, 0.5, 0.2])
        keys = rng.integers(0, 400, 24)
        futs.append(("ops", c.submit(kinds.tolist(), keys.tolist()),
                     kinds.tolist(), keys.tolist()))
        lo = int(rng.integers(0, 380))
        span = int(rng.integers(1, 200))
        futs.append(("scan", c.range(lo, lo + span,
                                     int(rng.integers(1, 60)))))
        for _ in range(3):
            c.pump()
    c.drain()
    c.settle()
    out = []
    for f in futs:
        if f[0] == "ops":
            out.append(f[1].results(wait=False))
        else:
            out.append((f[1].items(wait=False), f[1].raw()))
    return out, dict(c.backend.stats), c.all_keys(), futs


@pytest.mark.parametrize("seed", [11, 12])
def test_range_differential_matches_reference(seed):
    ref, ref_stats, ref_keys, _ = _differential("jax", seed)
    got, got_stats, got_keys, futs = _differential("torch", seed)
    assert got == ref
    assert got_stats == ref_stats
    assert got_keys == ref_keys
    # non-vacuous: splits happened, both serving paths ran, scans saw keys
    assert got_stats["range_hits"] > 0
    assert any(items for items, n in (x for x in got if isinstance(x, tuple)))
    oracle = OracleList()
    for f in futs:
        if f[0] == "ops":
            oracle.apply_batch(f[2], f[3])
    assert got_keys == sorted(oracle.snapshot())
