"""Nemesis replays through the port, held to the reference run for run.

B2     The reference's block-probe schedule (``tests/test_block_probe.py``:
       corpus entry mixed-p02 on 2 servers, key space 300) with the probe
       on and off: oracle-clean both ways, equal key sets, the probe
       non-vacuous, and the probe-on trace equal to the reference's and
       to the chip smoke's ``NEMESIS_B2_DIGEST``.
N2     A fresh (new-seq) MOVE_ACK for a now-idle background slot is inert
       (``tests/test_nemesis.py::test_stale_slot_ack_after_move_is_inert``)
       on a scripted 3-slot workload — split, two Moves with racing ops,
       a merge, cross-shard FINDs and a join — equal to the reference's
       state for state. Read replication is not ported, so the workload
       leaves out the reference's replicate/drop steps.
N3     One (seed, config) gives one trace, equal to the reference's; a
       run killed mid-flight is a prefix of the full run.
N4     A partition stalls cross-cut traffic and heals by retransmission.
Smoke  The chip smoke's copies of the corpus entries and wire faults.
"""
import importlib.util
import json
import pathlib

import numpy as np

import repro.core.messages as RM
import repro.core.sim as RSIM
import repro_torch.core.messages as TM
import repro_torch.core.sim as TSIM
from nemesis_harness import check, run_differential, small_cfg
from repro.core.net import NemesisConfig as RefConfig
from repro_torch.core.net import NemesisConfig, state_digest, trace_digest
from repro_torch.core.types import DiLiConfig, OP_FIND, OP_INSERT, OP_REMOVE
from torch_parity import assert_trees_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = {e["name"]: e for e in json.loads(
    (ROOT / "tests" / "nemesis_corpus.json").read_text())["entries"]}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


def _clusters(cfg_kw, **kw):
    """The same Cluster in both packages (the port's on the CPU)."""
    from repro.core.types import DiLiConfig as RefCfg
    nem = kw.pop("nemesis", None)
    ref = RSIM.Cluster(RefCfg(**cfg_kw), nemesis=None if nem is None else
                       RefConfig.from_dict(nem), **kw)
    port = TSIM.Cluster(DiLiConfig(**cfg_kw), nemesis=None if nem is None
                        else NemesisConfig.from_dict(nem), device="cpu", **kw)
    return ref, port


def _assert_same(ref, port):
    assert port.round_trace == ref.round_trace
    for s in range(ref.n):
        assert_trees_equal(ref.states[s], port.states[s], f"state[{s}]")
        assert_trees_equal(ref.bgs[s], port.bgs[s], f"bg[{s}]")
        assert np.array_equal(ref.backlog[s], port.backlog[s])
    assert port.net.stats == ref.net.stats


# ------------------------------------------------------------------ B2

def test_b2_block_probe_schedule_matches_reference_and_digest():
    e = CORPUS["mixed-p02"]
    kw = dict(n_ops=e["n_ops"], num_shards=2, key_space=300)
    ref = run_differential("local", e["seed"],
                           RefConfig.from_dict(e["config"]),
                           cfg_overrides={"block_probe": True}, **kw)
    check(ref, "B2 reference")
    runs = {}
    for on in (True, False):
        runs[on] = SMOKE.nemesis_differential(
            e["seed"], NemesisConfig.from_dict(e["config"]),
            cfg_overrides={"block_probe": on}, device="cpu", **kw)
        check(runs[on], f"B2 port block_probe={on}")
    assert runs[True]["final_keys"] == runs[False]["final_keys"]
    assert runs[False]["backend"].stats["blk_hits"] == 0
    assert runs[True]["backend"].stats["blk_hits"] > 0
    assert runs[True]["trace"] == ref["trace"]
    assert trace_digest(runs[True]["trace"]) == SMOKE.NEMESIS_B2_DIGEST


# ------------------------------------------------------ N2: stale slot ack

def _scripted_move_workload():
    """``tests/test_nemesis.py::_scripted_move_workload`` without its
    read-replication steps, on both packages in lockstep; returns the two
    clusters and the port's recorded wire frames."""
    cfg_kw = small_cfg(3)._asdict()
    cfg_kw["move_batch"] = 2
    ref, port = _clusters(cfg_kw, seed=1, nemesis={}, initial_shards=2)
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


def _digest(cl):
    """State hash modulo the BgTable's free-running per-round tick."""
    bgs = [b._replace(round=b.round * 0) for b in cl.bgs]
    return state_digest(cl.states, bgs)


def test_stale_slot_ack_after_move_is_inert():
    ref, port, rec = _scripted_move_workload()
    kinds = {int(f[2][TM.F_KIND]) for f in rec}
    assert {TM.MSG_MOVE_SH, TM.MSG_MOVE_ITEMS, TM.MSG_MOVE_ACK,
            TM.MSG_SWITCH_ST, TM.MSG_REG_SPLIT, TM.MSG_REG_MERGED,
            TM.MSG_EPOCH, TM.MSG_OP, TM.MSG_RESULT} <= kinds
    acks = [f for f in rec if int(f[2][TM.F_KIND]) == TM.MSG_MOVE_ACK][:4]
    assert acks
    d0 = _digest(port)
    for cl, M in ((ref, RM), (port, TM)):
        for _, dst, row in acks:
            fresh = row.copy()
            fresh[M.F_SEQ] = 0              # never crossed a transport
            cl.backlog[dst] = np.concatenate(
                [cl.backlog[dst], fresh[None]], axis=0)
        cl.run_until_quiet(200)
    assert _digest(port) == d0
    _assert_same(ref, port)


# ----------------------------------------------- N3: (seed, config) replay

def _scripted_run(make, seed, config, rounds):
    """``tests/test_nemesis.py::_scripted_run`` on the cluster ``make``
    builds."""
    cl = make(seed, config)
    rng = np.random.default_rng(42)
    keys = list(range(5, 150, 3))
    cl.submit(0, [OP_INSERT] * len(keys), keys)
    for r in range(rounds):
        if r == 10:
            subs = [e for e in cl.sublists(0) if e["owner"] == 0]
            if subs:
                mid = cl.middle_item(0, subs[0]["head_idx"])
                if mid is not None:
                    cl.split(0, subs[0]["keymax"], mid)
        if r == 25:
            subs = [e for e in cl.sublists(0) if e["owner"] == 0]
            if subs:
                cl.move(0, subs[-1]["keymax"], 1)
        kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 4).tolist()
        cl.submit(r % 2, kinds, rng.integers(1, 200, 4).tolist())
        cl.step()
    return cl


def _port(seed, config):
    return TSIM.Cluster(SMOKE.nemesis_cfg(2), seed=seed, device="cpu",
                        nemesis=NemesisConfig.from_dict(config))


def _ref(seed, config):
    return RSIM.Cluster(small_cfg(2), seed=seed,
                        nemesis=RefConfig.from_dict(config))


P02 = dict(drop_prob=0.2, dup_prob=0.2, reorder_prob=0.2, delay_prob=0.1,
           delay_rounds=3)


def test_same_seed_runs_produce_identical_round_traces():
    ref = _scripted_run(_ref, 3, P02, 80)
    a = _scripted_run(_port, 3, P02, 80)
    b = _scripted_run(_port, 3, P02, 80)
    assert a.round_trace == ref.round_trace
    assert a.round_trace == b.round_trace
    assert state_digest(a.states, a.bgs) == state_digest(b.states, b.bgs)
    for s in range(2):
        assert_trees_equal(ref.states[s], a.states[s], f"state[{s}]")
    c = _scripted_run(_port, 4, P02, 80)
    assert a.round_trace != c.round_trace


def test_killed_and_restarted_schedule_replays_byte_identically():
    dead = _scripted_run(_port, 7, P02, 30)
    assert not dead.net.idle() or any(b.shape[0] for b in dead.backlog)
    full = _scripted_run(_port, 7, P02, 80)
    assert full.round_trace[:len(dead.round_trace)] == dead.round_trace
    assert full.round_trace == _scripted_run(_ref, 7, P02, 80).round_trace


# --------------------------------------------------- N4: partition heal

def test_partition_stalls_then_heals():
    config = dict(drop_prob=0.05, partitions=[[5, 30, [0]]])
    kw = dict(n_ops=200, num_shards=2)
    ref = run_differential("local", 17, RefConfig.from_dict(config), **kw)
    got = SMOKE.nemesis_differential(17, NemesisConfig.from_dict(config),
                                     device="cpu", **kw)
    check(got, "partition heal")
    assert got["nemesis_stats"]["partitioned"] > 0
    assert got["net_stats"]["retransmits"] > 0
    assert got["trace"] == ref["trace"]
    assert got["nemesis_stats"] == ref["nemesis_stats"]


# ------------------------------------------------------ the smoke's copies

def test_smoke_corpus_copies():
    for name, e in SMOKE.CORPUS.items():
        assert (e["seed"], e["n_ops"]) == (CORPUS[name]["seed"],
                                          CORPUS[name]["n_ops"])
        assert NemesisConfig.from_dict(e["config"]) == \
            NemesisConfig.from_dict(CORPUS[name]["config"])
    # NEMESIS4 takes mixed-p015-range's wire faults
    faults = dict(CORPUS["mixed-p015-range"]["config"])
    assert SMOKE.NEMESIS4["faults"] == faults
    assert SMOKE.NEMESIS4["mix_ops"] >= 1000
