"""Background-operation workloads of the reference's tests
(``tests/test_background.py``, ``test_bg_concurrent.py``,
``test_merge_balancer.py``), written once against a package namespace so
``tests/test_torch_bg*.py`` can drive each through the JAX reference and
through the port on the CPU and compare the two runs bit for bit.

A workload takes a ``Pkg`` and returns the cluster it drove plus the
op ids whose results it checks against the oracle; ``run`` records a
state digest after every round (every shard's state and background
table) and returns what the two runs must agree on.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

import repro.core.balancer as JBAL
import repro.core.bg as JBG
import repro.core.sim as JSIM
import repro.core.types as JT
import repro_torch.core.balancer as TBAL
import repro_torch.core.bg as TBG
import repro_torch.core.sim as TSIM
import repro_torch.core.types as TT
from repro.core.oracle import OracleList
from repro_torch.core import messages as TM
from repro_torch.core import refs as TREFS

from torch_parity import digest

OP_FIND, OP_INSERT, OP_REMOVE = JT.OP_FIND, JT.OP_INSERT, JT.OP_REMOVE


def _jax_scalar(v):
    import jax.numpy as jnp
    return jnp.asarray(v, jnp.int32)


def _torch_scalar(v):
    import torch
    return torch.tensor(v, dtype=torch.int32)


PKGS = {
    "jax": SimpleNamespace(name="jax", sim=JSIM, types=JT, bal=JBAL, bg=JBG,
                           extra={}, scalar=_jax_scalar),
    "torch": SimpleNamespace(name="torch", sim=TSIM, types=TT, bal=TBAL,
                             bg=TBG, extra=dict(device="cpu"),
                             scalar=_torch_scalar),
}


def cluster(P, cfg_kw, **kw):
    """A Cluster of package ``P`` whose every round appends a digest of
    all shards' states and background tables to ``cl.digests``."""
    cl = P.sim.Cluster(P.types.DiLiConfig(**cfg_kw), **kw, **P.extra)
    cl.digests = []
    step = cl.step

    def recorded():
        out = step()
        cl.digests.append(digest(cl.states, cl.bgs))
        return out

    cl.step = recorded
    return cl


def outcome(cl) -> dict:
    return dict(results=dict(cl.results), keys=cl.all_keys(),
                stats=dict(cl.stats), rounds=cl.round_no,
                digests=cl.digests,
                sublists=[cl.sublists(s) for s in range(cl.n)])


class Expect:
    """Op ids paired with the sequential oracle's answers."""

    def __init__(self):
        self.oracle = OracleList()
        self.pairs = []

    def submit(self, cl, shard, kinds, keys):
        ids = cl.submit(shard, kinds, keys)
        self.pairs += list(zip(ids, self.oracle.apply_batch(kinds, keys)))
        return ids

    def check(self, cl):
        for op_id, exp in self.pairs:
            assert op_id in cl.results, f"op {op_id} never completed"
            got = cl.results[op_id]
            assert got in (0, 1), f"op {op_id} error code {got}"
            assert bool(got) == exp, f"op {op_id}: got {got}, want {exp}"
        assert cl.all_keys() == sorted(self.oracle.snapshot())


# ------------------------------------------------- tests/test_background.py

BG = dict(num_shards=2, pool_capacity=2048, max_sublists=32, max_ctrs=32,
          max_scan=2048, batch_size=32, mailbox_cap=256, move_batch=8)


def move_quiet(P):
    cl, ex = cluster(P, BG), Expect()
    keys = list(range(5, 65, 3))
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    assert cl.move(0, cl.sublists(0)[0]["keymax"], 1)
    cl.run_until_quiet(400)
    for s in range(2):
        subs = cl.sublists(s)
        assert len(subs) == 1 and subs[0]["owner"] == 1, subs
    ex.submit(cl, 0, [OP_FIND, OP_REMOVE, OP_INSERT, OP_FIND], [5] * 4)
    cl.run_until_quiet()
    ex.submit(cl, 1, [OP_FIND], [8])
    cl.run_until_quiet()
    ex.check(cl)
    return cl


def move_under_write_load(P, seed):
    cl, ex = cluster(P, BG), Expect()
    rng = np.random.default_rng(seed)
    keys = sorted(rng.choice(np.arange(1, 500), 60, replace=False).tolist())
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    assert cl.move(0, cl.sublists(0)[0]["keymax"], 1)
    for i in range(12):
        kinds = rng.choice([OP_INSERT, OP_REMOVE, OP_FIND], 8,
                           p=[0.45, 0.45, 0.1]).tolist()
        ex.submit(cl, i % 2, kinds, rng.integers(1, 500, 8).tolist())
        cl.step()
    cl.run_until_quiet(600)
    ex.check(cl)
    for s in range(2):
        assert all(e["owner"] == 1 for e in cl.sublists(s))
    assert cl.stats["max_hops"] <= 4, cl.stats
    return cl


def move_with_channel_delays(P, seed):
    cl, ex = cluster(P, BG, delay_prob=0.35, seed=seed), Expect()
    rng = np.random.default_rng(seed + 100)
    keys = sorted(rng.choice(np.arange(1, 300), 40, replace=False).tolist())
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(400)
    assert cl.move(0, cl.sublists(0)[0]["keymax"], 1)
    for i in range(16):
        kinds = rng.choice([OP_INSERT, OP_REMOVE], 6).tolist()
        ex.submit(cl, i % 2, kinds, rng.integers(1, 300, 6).tolist())
        cl.step()
    cl.run_until_quiet(800)
    ex.check(cl)
    return cl


def split_then_move_each_half(P):
    cl, ex = cluster(P, dict(BG, num_shards=3)), Expect()
    keys = list(range(2, 202, 4))
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    subs = cl.sublists(0)
    assert cl.split(0, subs[0]["keymax"],
                    cl.middle_item(0, subs[0]["head_idx"]))
    cl.run_until_quiet()
    subs = cl.sublists(0)
    assert len(subs) == 2
    assert cl.move(0, subs[0]["keymax"], 1)
    cl.run_until_quiet(400)
    assert cl.move(0, subs[1]["keymax"], 2)
    cl.run_until_quiet(400)
    assert sorted(e["owner"] for e in cl.sublists(0)) == [1, 2]
    rng = np.random.default_rng(7)
    for s in range(3):
        kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 12).tolist()
        ex.submit(cl, s, kinds, rng.integers(1, 220, 12).tolist())
    cl.run_until_quiet(400)
    ex.check(cl)
    return cl


# ------------------------------------------------ tests/test_bg_concurrent.py

CONC = dict(num_shards=2, pool_capacity=4096, max_sublists=32, max_ctrs=32,
            max_scan=4096, batch_size=32, mailbox_cap=256, move_batch=4,
            bg_slots=3)


def _grow_sublists(cl, ex, keys, want):
    """Insert ``keys`` then split shard 0's largest sublist until it owns
    ``want`` sublists."""
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(600)
    for _ in range(want * 2):
        owned = [e for e in cl.sublists(0) if e["owner"] == 0]
        if len(owned) >= want:
            break
        e = max(owned, key=lambda x: x["size"])
        assert cl.split(0, e["keymax"], cl.middle_item(0, e["head_idx"]))
        cl.run_until_quiet(600)
    owned = sorted((e for e in cl.sublists(0) if e["owner"] == 0),
                   key=lambda x: x["keymin"])
    assert len(owned) >= want, owned
    return owned


def concurrent_split_move_merge(P, delay, move_fastpath):
    cl = cluster(P, dict(CONC, move_fastpath=move_fastpath), seed=11,
                 delay_prob=delay)
    ex = Expect()
    owned = _grow_sublists(cl, ex, list(range(2, 242, 2)), want=4)
    e_ml, e_mr, e_move, e_split = owned[:4]
    assert cl.merge(0, e_ml["keymax"], e_mr["keymax"])
    assert cl.move(0, e_move["keymax"], 1)
    assert cl.split(0, e_split["keymax"],
                    cl.middle_item(0, e_split["head_idx"]))
    assert P.bg.free_slots(cl.bgs[0]) == 0
    rng = np.random.default_rng(5)
    max_active = 0
    for i in range(14):
        kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 8,
                           p=[0.2, 0.4, 0.4]).tolist()
        ex.submit(cl, i % 2, kinds, rng.integers(1, 260, 8).tolist())
        cl.step()
        max_active = max(max_active, int(
            (P.bg.slot_phases(cl.bgs[0]) != P.bg.BG_IDLE).sum()))
    cl.run_until_quiet(2000)
    assert max_active >= 2 and cl.stats["max_bg_active"] >= 2
    ex.check(cl)
    movers = [e for s in range(2) for e in cl.sublists(s)
              if e["keymax"] == e_move["keymax"]]
    assert movers and all(e["owner"] == 1 for e in movers)
    if move_fastpath and delay == 0.0:
        assert cl.stats["move_hits"] > 0
    return cl


def entry_claims_are_exclusive(P):
    cl, ex = cluster(P, CONC), Expect()
    owned = _grow_sublists(cl, ex, list(range(5, 165, 2)), want=2)
    e = owned[0]
    assert cl.move(0, e["keymax"], 1)
    assert P.bg.free_slots(cl.bgs[0]) == CONC["bg_slots"] - 1
    assert cl.split(0, e["keymax"], cl.middle_item(0, e["head_idx"])) \
        is False
    assert cl.move(0, e["keymax"], 1) is False
    assert e["keymax"] in P.bg.claimed_keys(cl.bgs[0])
    other = owned[1]
    assert cl.split(0, other["keymax"],
                    cl.middle_item(0, other["head_idx"]))
    cl.run_until_quiet(800)
    assert P.bg.free_slots(cl.bgs[0]) == CONC["bg_slots"]
    assert P.bg.claimed_keys(cl.bgs[0]) == set()
    ex.check(cl)
    return cl


def no_free_slot_drops_command(P):
    cl, ex = cluster(P, dict(CONC, bg_slots=1)), Expect()
    owned = _grow_sublists(cl, ex, list(range(5, 165, 2)), want=2)
    assert cl.move(0, owned[0]["keymax"], 1)
    assert cl.split(0, owned[1]["keymax"],
                    cl.middle_item(0, owned[1]["head_idx"])) is False
    cl.run_until_quiet(800)
    ex.check(cl)
    return cl


def move_nack_frees_slot_and_claim(P):
    cl, ex = cluster(P, CONC), Expect()
    owned = _grow_sublists(cl, ex, list(range(5, 105, 2)), want=1)
    # exhaust the target's counter slots: h_move_sh must ack with a=0
    cl.states[1] = cl.states[1]._replace(
        ctr_top=P.scalar(CONC["max_ctrs"]))
    assert cl.move(0, owned[0]["keymax"], 1)
    cl.run_until_quiet(400)
    assert P.bg.free_slots(cl.bgs[0]) == CONC["bg_slots"]
    assert P.bg.claimed_keys(cl.bgs[0]) == set()
    assert all(e["owner"] == 0 for e in cl.sublists(0))
    ex.check(cl)
    return cl


def stale_delegation_through_quarantine(P):
    cl = cluster(P, dict(CONC, quarantine_rounds=64, move_batch=8))
    ex = Expect()
    owned = _grow_sublists(cl, ex, list(range(4, 244, 3)), want=2)
    e_a, e_b = owned[0], owned[1]
    probe_key = next(k for k in sorted(ex.oracle.snapshot())
                     if e_a["keymin"] < k <= e_a["keymax"])
    assert cl.move(0, e_a["keymax"], 1)
    for _ in range(200):
        cl.step()
        if any(e["keymax"] == e_a["keymax"] and e["switched"]
               for e in cl.sublists(0)):
            break
    else:
        raise AssertionError("move A never reached the quarantine window")
    assert cl.move(0, e_b["keymax"], 1)
    # an op whose hint is the old (quarantined) subhead of A
    row = P.sim.make_op_row(0, OP_FIND, probe_key, 0, slot=1 << 20)
    row[TM.F_REF1] = TREFS.make_ref(0, e_a["head_idx"])
    cl.backlog[0] = np.concatenate([cl.backlog[0], row[None]], axis=0)
    exp = ex.oracle.apply(OP_FIND, probe_key)
    cl.run_until_quiet(2000)
    assert bool(cl.results[1 << 20]) == exp is True
    ex.check(cl)
    for s in range(2):
        assert all(e["owner"] == 1 for e in cl.sublists(s))
    return cl


# ----------------------------------------------- tests/test_merge_balancer.py

MB = dict(num_shards=2, pool_capacity=4096, max_sublists=64, max_ctrs=64,
          max_scan=4096, batch_size=32, mailbox_cap=256, move_batch=16)


def merge_after_split_roundtrip(P):
    cl, ex = cluster(P, MB), Expect()
    keys = list(range(10, 90))
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    subs = cl.sublists(0)
    assert cl.split(0, subs[0]["keymax"],
                    cl.middle_item(0, subs[0]["head_idx"]))
    cl.run_until_quiet()
    subs = sorted(cl.sublists(0), key=lambda e: e["keymin"])
    assert len(subs) == 2
    assert cl.merge(0, subs[0]["keymax"], subs[1]["keymax"])
    cl.run_until_quiet()
    for s in range(2):
        assert len(cl.sublists(s)) == 1, cl.sublists(s)
    ex.submit(cl, 1, [OP_FIND, OP_REMOVE, OP_FIND, OP_INSERT], [50] * 4)
    cl.run_until_quiet()
    ex.check(cl)
    return cl


def merge_under_concurrent_ops(P):
    cl, ex = cluster(P, dict(MB, num_shards=1)), Expect()
    rng = np.random.default_rng(3)
    keys = list(range(0, 300, 3))[1:]
    ex.submit(cl, 0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet()
    subs = cl.sublists(0)
    assert cl.split(0, subs[0]["keymax"],
                    cl.middle_item(0, subs[0]["head_idx"]))
    cl.run_until_quiet()
    subs = sorted(cl.sublists(0), key=lambda e: e["keymin"])
    assert cl.merge(0, subs[0]["keymax"], subs[1]["keymax"])
    for _ in range(5):
        kinds = rng.choice([OP_INSERT, OP_REMOVE, OP_FIND], 8).tolist()
        ex.submit(cl, 0, kinds, rng.integers(1, 320, 8).tolist())
        cl.step()
    cl.run_until_quiet()
    ex.check(cl)
    assert len(cl.sublists(0)) == 1
    return cl


def balancer_end_to_end(P, nshards):
    cl = cluster(P, dict(MB, num_shards=nshards, split_threshold=40,
                         pool_capacity=8192, max_scan=8192))
    bal, ex = P.bal.Balancer(cl), Expect()
    rng = np.random.default_rng(11)
    keyspace = rng.permutation(np.arange(1, 2000))[:600]
    for ch in np.array_split(keyspace, 30):
        ks = ch.tolist()
        ex.submit(cl, 0, [OP_INSERT] * len(ks), ks)
        cl.step()
        bal.step()
    cl.run_until_quiet(600)
    passes = []
    for _ in range(100):
        issued = bal.step()
        passes.append(dict(issued))
        cl.run_until_quiet(600)
        if not any(issued.values()):
            break
    cl.passes = passes
    ex.check(cl)
    loads = [sum(e["size"] or 0 for e in cl.sublists(s) if e["owner"] == s)
             for s in range(nshards)]
    assert max(loads) <= 1.7 * (sum(loads) / nshards) + 50, loads
    assert sum(e["owner"] != 0 for e in cl.sublists(0)) > 0   # moves ran
    return cl


def run(workload, *args) -> dict:
    """The workload through both packages: (reference, port) outcomes."""
    out = []
    for name in ("jax", "torch"):
        cl = workload(PKGS[name], *args)
        o = outcome(cl)
        o["passes"] = getattr(cl, "passes", None)
        out.append(o)
    return out


def assert_same(ref: dict, got: dict) -> None:
    assert got["rounds"] == ref["rounds"] == len(got["digests"])
    for r, (a, b) in enumerate(zip(ref["digests"], got["digests"])):
        assert a == b, f"state digest differs after round {r + 1}"
    for k in ("results", "keys", "stats", "sublists", "passes"):
        assert got[k] == ref[k], k
