"""Read replication under the nemesis, through the port, held to the
reference run for run (``tests/test_replica.py`` R6-R7 and
``tests/test_nemesis.py``'s idempotence matrix).

R6  The differential under ``default_nemesis(0.10)`` with replication
    forced on (seed 47, 400 ops): the windowed referee holds both
    packages, the round traces are equal line for line and digest to the
    chip smoke's ``REPLICA_NEMESIS_DIGEST``, and replicas served FINDs.
    The smoke's copies of the schedule equal the reference test's.
R7  The same differential across a crash-restart of server 1: equal
    traces, one recovery each.
N2  The idempotence matrix: the scripted 3-slot workload (split, two
    Moves with racing ops, a merge, a replicated entry with mutations
    racing its delta stream and then retired, cross-shard FINDs, a join
    and a Move onto it) on both packages in lockstep, state for state;
    then every recorded kind's traffic, all three ``MSG_REPLICA_*`` kinds
    included, re-delivered twice leaves the port's state unchanged and
    equal to the reference's.
"""
import importlib.util
import pathlib

import numpy as np

import repro.core.messages as RM
import repro.core.net as RN
import repro.core.sim as RSIM
import repro_torch.core.messages as TM
import repro_torch.core.net as TN
import repro_torch.core.sim as TSIM
from nemesis_harness import check, default_nemesis, run_differential, \
    small_cfg
from repro_torch.core.net import state_digest, trace_digest
from repro_torch.core.types import DiLiConfig, OP_FIND, OP_INSERT, \
    OP_REMOVE
from torch_parity import assert_trees_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


def _pair(seed, nem, n_ops):
    """The replication differential through both packages; returns the
    reference's and the port's result dicts, both already checked."""
    ref = run_differential("local", seed, RN.NemesisConfig.from_dict(nem),
                           n_ops=n_ops, cfg_overrides=SMOKE.REP_OVERRIDES,
                           balancer_kwargs=SMOKE.REP_BAL, keep_backend=True)
    got = SMOKE.nemesis_differential(
        seed, TN.NemesisConfig.from_dict(nem), n_ops=n_ops,
        cfg_overrides=SMOKE.REP_OVERRIDES, balancer_kwargs=SMOKE.REP_BAL,
        device="cpu")
    check(ref, f"reference seed={seed}")
    check(got, f"port seed={seed}")
    assert got["trace"] == ref["trace"]
    assert got["final_keys"] == ref["final_keys"]
    assert got["net_stats"] == ref["net_stats"]
    assert got["backend"].stats == ref["backend"].stats
    assert got["replica_window"] > 0
    return ref, got


def test_r6_nemesis_differential_with_replication_and_digest():
    e = SMOKE.REPLICA_NEMESIS
    # the smoke's copies are the reference test's schedule
    import test_replica as RT
    assert e["faults"] == {k: v for k, v in
                           default_nemesis(0.10).to_dict().items()
                           if k in e["faults"]}
    assert default_nemesis(0.10).to_dict() == \
        RN.NemesisConfig(**e["faults"]).to_dict()
    assert (SMOKE.REP_OVERRIDES, SMOKE.REP_BAL) == (RT.REP_OVERRIDES,
                                                     RT.REP_BAL)
    ref, got = _pair(e["seed"], e["faults"], e["n_ops"])
    assert got["backend"].stats["rep_hits"] > 0
    assert trace_digest(got["trace"]) == SMOKE.REPLICA_NEMESIS_DIGEST


def test_r7_crash_restart_differential_with_replication():
    nem = dict(drop_prob=0.05, dup_prob=0.05, reorder_prob=0.05,
               crashes=[[1, 60, 110]])
    ref, got = _pair(29, nem, 300)
    dur = got["backend"].cluster.durability
    assert dur.stats["recoveries"] == 1
    assert dur.stats == ref["backend"].cluster.durability.stats


# ------------------------------------------------------ N2: the matrix

def _scripted_workload():
    """``tests/test_nemesis.py::_scripted_move_workload`` on both packages
    in lockstep; returns the two clusters and the port's recorded wire
    frames."""
    from repro.core.types import DiLiConfig as RefCfg
    cfg_kw = small_cfg(3)._replace(
        move_batch=2, replication=True, replica_sessions=2, replica_slots=4,
        replica_batch=4, replica_refresh_rounds=2,
        replica_staleness_rounds=16)._asdict()
    ref = RSIM.Cluster(RefCfg(**cfg_kw), seed=1, nemesis=RN.NemesisConfig(),
                       initial_shards=2)
    port = TSIM.Cluster(DiLiConfig(**cfg_kw), seed=1,
                        nemesis=TN.NemesisConfig(), initial_shards=2,
                        device="cpu")
    rec = []
    orig = port.net.nemesis.perturb

    def spy(frames, round_no):
        rec.extend((s, d, row.copy()) for s, d, row in frames)
        return orig(frames, round_no)

    port.net.nemesis.perturb = spy

    def each(fn):
        return [fn(cl) for cl in (ref, port)]

    keys = list(range(10, 210, 5))
    each(lambda cl: cl.submit(0, [OP_INSERT] * len(keys), keys))
    each(lambda cl: cl.run_until_quiet(600))

    def split(cl):
        subs = [e for e in cl.sublists(0) if e["owner"] == 0]
        return cl.split(0, subs[0]["keymax"],
                        cl.middle_item(0, subs[0]["head_idx"]))

    assert all(each(split))
    each(lambda cl: cl.run_until_quiet(600))

    def move_with_races(cl, lo, hi):
        subs = sorted((e for e in cl.sublists(0) if e["owner"] == 0),
                      key=lambda e: e["keymin"])
        assert cl.move(0, subs[0]["keymax"], 1)
        rng = np.random.default_rng(9)
        for _ in range(12):
            ks = rng.integers(lo, hi, 2).tolist()
            cl.submit(0, [OP_INSERT, OP_REMOVE], ks)
            cl.step()
        cl.run_until_quiet(800)

    each(lambda cl: move_with_races(cl, 10, 100))
    each(lambda cl: move_with_races(cl, 100, 210))

    def merge(cl):
        subs1 = sorted((e for e in cl.sublists(1) if e["owner"] == 1),
                       key=lambda e: e["keymin"])
        assert len(subs1) >= 2
        return cl.merge(1, subs1[0]["keymax"], subs1[1]["keymax"])

    assert all(each(merge))
    each(lambda cl: cl.run_until_quiet(600))

    # read replication: shard 1's merged entry onto shard 0, mutations
    # racing the delta stream, then retired
    def replicate_and_race(cl):
        ent = sorted((e for e in cl.sublists(1) if e["owner"] == 1),
                     key=lambda e: e["keymin"])[0]
        assert cl.replicate(1, ent["keymax"], 0)
        lo, hi = max(ent["keymin"] + 1, 11), min(ent["keymax"], 209)
        rng = np.random.default_rng(11)
        for _ in range(10):
            ks = rng.integers(lo, hi, 2).tolist()
            cl.submit(1, [OP_INSERT, OP_REMOVE], ks)
            cl.step()
        cl.run_until_quiet(600)
        assert cl.drop_replica(1, ent["keymax"])
        cl.run_until_quiet(600)
        assert all(int(np.asarray(st.rslots.ttl).max(initial=0)) == 0
                   for st in cl.states)
        assert cl.replica_sets() == {}

    each(replicate_and_race)
    each(lambda cl: cl.submit(0, [OP_FIND] * 4, [20, 60, 120, 180]))
    each(lambda cl: cl.run_until_quiet(600))
    assert each(lambda cl: cl.join_shard()) == [2, 2]
    each(lambda cl: cl.run_until_quiet(600))

    def move_to_new(cl):
        subs1 = sorted((e for e in cl.sublists(1) if e["owner"] == 1),
                       key=lambda e: e["keymin"])
        return cl.move(1, subs1[0]["keymax"], 2)

    assert all(each(move_to_new))
    each(lambda cl: cl.run_until_quiet(800))
    assert port.membership.active == (0, 1, 2)
    _assert_same(ref, port)
    return ref, port, rec


def _assert_same(ref, port):
    assert port.round_trace == ref.round_trace
    assert port.results == ref.results
    for s in range(ref.n):
        assert_trees_equal(ref.states[s], port.states[s], f"state[{s}]")
        assert_trees_equal(ref.bgs[s], port.bgs[s], f"bg[{s}]")
        assert np.array_equal(ref.backlog[s], port.backlog[s])
    assert port.net.stats == ref.net.stats


def _digest(cl):
    """State hash modulo the BgTable's free-running per-round tick."""
    bgs = [b._replace(round=b.round * 0) for b in cl.bgs]
    return state_digest(cl.states, bgs)


def test_duplicate_delivery_idempotence_matrix():
    ref, port, rec = _scripted_workload()
    data = [f for f in rec if int(f[2][TM.F_KIND]) != TM.MSG_NET_ACK]
    kinds = {int(f[2][TM.F_KIND]) for f in data}
    required = {TM.MSG_OP, TM.MSG_RESULT, TM.MSG_MOVE_SH, TM.MSG_MOVE_SH_ACK,
                TM.MSG_MOVE_ITEMS, TM.MSG_MOVE_ITEM, TM.MSG_MOVE_ACK,
                TM.MSG_SWITCH_ST, TM.MSG_SWITCH_ST_ACK,
                TM.MSG_SWITCH_SERVER, TM.MSG_REG_SPLIT, TM.MSG_REG_MERGED,
                TM.MSG_EPOCH, TM.MSG_REPLICA_DELTA, TM.MSG_REPLICA_INSTALL,
                TM.MSG_REPLICA_DROP}
    assert required <= kinds, f"missing kinds: {sorted(required - kinds)}"
    assert (RM.MSG_REPLICA_DELTA, RM.MSG_REPLICA_DROP) == \
        (TM.MSG_REPLICA_DELTA, TM.MSG_REPLICA_DROP)

    d0 = _digest(port)
    for kind in sorted(kinds):
        frames = [f for f in data if int(f[2][TM.F_KIND]) == kind]
        before = port.net.stats["dup_dropped"]
        for cl in (ref, port):
            # every frame is a duplicate (its seq is at or below the lane
            # cursor) and must be absorbed by the dedup window
            cl.net._staged.extend(frames)
            cl.net._staged.extend(frames)
            cl.step()
            cl.run_until_quiet(200)
        assert port.net.stats["dup_dropped"] >= before + 2 * len(frames), \
            kind
        assert _digest(port) == d0, f"kind {kind} re-delivery changed state"
        _assert_same(ref, port)
