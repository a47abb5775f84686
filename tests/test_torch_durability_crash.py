"""Crash-restart schedules through the port, held to the reference's
traces (``tests/test_durability.py`` D6, D7, D9 and the corpus's crash
entries).

D6  Seeded kill -9 + recovery of two servers under a lossy wire: the
    port passes the differential, its trace equals the reference's line
    for line (``mb crash``/``mb restart`` lines included), two recoveries
    replay rounds, and a second run replays the trace.
D7  The receiver of a Move dies mid-copy; recovery + retransmission
    complete the migration without a lost key, as in the reference.
D9  A crash under group commit (fsync every 8 rounds) still recovers
    exactly.
N1  ``crash-during-move-copy`` (with the block probe, the chip smoke's
    ``CRASH_DIGEST``) and ``crash-then-partition`` replay with the
    reference's trace.
"""
import importlib.util
import json
import pathlib

import pytest

import repro.core.bg as RB
import repro.core.net as RN
import repro.core.sim as RSIM
import repro_torch.core.bg as TB
import repro_torch.core.durability as TD
import repro_torch.core.net as TN
import repro_torch.core.sim as TSIM
from nemesis_harness import check, run_differential, small_cfg
from repro.core.net.nemesis import CrashPlan as RefCrashPlan
from repro_torch.core.net import trace_digest
from repro_torch.core.types import OP_FIND, OP_INSERT

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = [e for e in json.loads(
    (ROOT / "tests" / "nemesis_corpus.json").read_text())["entries"]
    if e["config"].get("crashes")]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")

CRASH_NEM = dict(drop_prob=0.05, dup_prob=0.05, reorder_prob=0.05,
                 crashes=[[1, 40, 80], [2, 120, 150]])


def _pair(config, seed, **kw):
    ref = run_differential("local", seed, RN.NemesisConfig.from_dict(config),
                           keep_backend=True, **kw)
    got = SMOKE.nemesis_differential(
        seed, TN.NemesisConfig.from_dict(config), device="cpu", **kw)
    check(ref, f"reference seed={seed}")
    check(got, f"port seed={seed}")
    assert got["trace"] == ref["trace"]
    assert got["final_keys"] == ref["final_keys"]
    assert got["net_stats"] == ref["net_stats"]
    rd = ref["backend"].cluster.durability.stats
    assert got["backend"].cluster.durability.stats == rd
    return ref, got


def test_local_crash_restart_differential_and_replay():
    _, got = _pair(CRASH_NEM, 23, n_ops=300)
    trace = got["trace"]
    for line in ("mb crash s1", "mb restart s1", "mb crash s2"):
        assert any(line in ln for ln in trace), line
    dur = got["backend"].cluster.durability
    assert dur.stats["recoveries"] == 2 and dur.stats["replayed_rounds"] > 0
    again = SMOKE.nemesis_differential(
        23, TN.NemesisConfig.from_dict(CRASH_NEM), n_ops=300, device="cpu")
    assert again["trace"] == trace


@pytest.mark.parametrize("entry", CORPUS, ids=[e["name"] for e in CORPUS])
def test_crash_corpus_entry_replays_the_reference_trace(entry):
    """Both crash entries; crash-during-move-copy runs as the chip smoke's
    ``[crash]`` phase does, with the block probe, and its trace digest is
    recomputed from the reference as ``CRASH_DIGEST``."""
    probe = entry["name"] == "crash-during-move-copy"
    ref, got = _pair(entry["config"], entry["seed"], n_ops=entry["n_ops"],
                     cfg_overrides={"block_probe": probe})
    assert any("mb crash" in ln for ln in got["trace"])
    st = got["backend"].cluster.durability.stats
    assert st["recoveries"] == 1 and st["replayed_rounds"] > 0
    if probe:
        assert trace_digest(ref["trace"]) == SMOKE.CRASH_DIGEST
        assert trace_digest(got["trace"]) == SMOKE.CRASH_DIGEST
        assert SMOKE.CORPUS[entry["name"]] == {
            k: entry[k] for k in ("seed", "n_ops", "config")}


# ------------------------------------------- D7: crash during a move copy

def _move_script(make, B, crashes, probe=None):
    """``tests/test_durability.py::_move_script`` on the cluster ``make``
    builds: load shard 0, split, move one sublist to shard 1 stepping
    through the copy (``probe`` sees the cluster each round), then FINDs."""
    cl = make(crashes)
    keys = list(range(10, 250, 3))
    cl.submit(0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(600)
    subs = [e for e in cl.sublists(0) if e["owner"] == 0]
    assert cl.split(0, subs[0]["keymax"],
                    cl.middle_item(0, subs[0]["head_idx"]))
    cl.run_until_quiet(600)
    subs = sorted((e for e in cl.sublists(0) if e["owner"] == 0),
                  key=lambda e: e["keymin"])
    assert cl.move(0, subs[0]["keymax"], 1)
    for _ in range(400):
        if probe is not None:
            probe(cl)
        cl.step()
        if not B.any_active(cl.bgs[0]) and not cl.membership.crashed \
                and cl.net.idle() \
                and not any(b.shape[0] for b in cl.backlog):
            break
    cl.submit(0, [OP_FIND] * 3, [19, 100, 202])
    cl.run_until_quiet(600)
    return cl, keys


def _ref(crashes):
    return RSIM.Cluster(small_cfg(2)._replace(move_batch=2), seed=5,
                        nemesis=RN.NemesisConfig(crashes=tuple(
                            RefCrashPlan(*c) for c in crashes)))


def _port(crashes):
    return TSIM.Cluster(SMOKE.nemesis_cfg(2, move_batch=2), seed=5,
                        device="cpu", nemesis=TN.NemesisConfig(crashes=tuple(
                            TN.CrashPlan(*c) for c in crashes)))


def test_crash_during_move_copy_recovers_without_key_loss():
    active = []
    cl0, keys = _move_script(
        _port, TB, (), probe=lambda c: active.append(c.round_no)
        if TB.any_active(c.bgs[0]) else None)
    assert sorted(cl0.all_keys()) == sorted(keys)
    assert len(active) >= 3, "move finished too fast to crash into"
    crash_r = active[len(active) // 2]
    plan = [(1, crash_r, crash_r + 25)]
    saw_active = []
    cl, _ = _move_script(
        _port, TB, plan,
        probe=lambda c: saw_active.append(TB.any_active(c.bgs[0]))
        if c.round_no == crash_r else None)
    assert saw_active == [True], "crash round missed the copy window"
    assert any("mb crash s1" in ln for ln in cl.round_trace)
    assert cl.durability.stats["recoveries"] == 1
    assert sorted(cl.all_keys()) == sorted(keys)
    assert any(e["owner"] == 1 for e in cl.sublists(1))
    ref, _ = _move_script(_ref, RB, plan)
    assert cl.round_trace == ref.round_trace
    assert cl.durability.stats == ref.durability.stats


# -------------------------------------------------- D9: group commit

def test_group_commit_crash_recovery_still_exact(tmp_path):
    cfg = SMOKE.nemesis_cfg(2)
    dur = TD.Durability(str(tmp_path), cfg, TD.DurabilityConfig(
        snapshot_every=0, group_commit_rounds=8))
    cl = TSIM.Cluster(cfg, seed=3, device="cpu", durability=dur,
                      nemesis=TN.NemesisConfig(crashes=(
                          TN.CrashPlan(shard=1, crash_round=20,
                                       restart_round=40),)))
    keys = list(range(10, 310, 3))
    cl.submit(0, [OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(600)
    while cl.round_no < 64:
        cl.step()
    assert dur.stats["recoveries"] == 1
    cl.run_until_quiet(800)
    assert sorted(cl.all_keys()) == sorted(keys)
