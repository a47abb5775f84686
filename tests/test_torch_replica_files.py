"""Read replication's host commands, their journal and the files: the port
against the reference, bit for bit, on the CPU.

R5  The journaled replicate command: two runs digest alike, the port's
    equal to the reference's, and a primary crashed after the command
    recovers its session from the WAL, equal to the reference.
Q   ``queue_replicate``/``queue_drop_replica`` on each rejection and
    update path, state and verdict equal to the reference's.
X   WAL and snapshot files with ``CMD_REPLICATE``/``CMD_DROP_REPLICA``
    records cross the packages both ways (value-0 workload), and the
    snapshots keep ``rep``/``rslots`` under the reference's keys and
    dtypes.

(Split from ``test_torch_replica.py`` so that tier-1's workers run the
two in parallel.)
"""
import numpy as np
import pytest

import repro.core.durability as RD
import repro.core.replica as JR
import repro.core.sim as RSIM
import repro.core.types as JT
import repro_torch.core.durability as TD
import repro_torch.core.replica as TR
import repro_torch.core.types as TT
from repro_torch import convert
from test_torch_replica import KEYS, PKGS, REP, _to_port
from torch_parity import assert_trees_equal, digest


# -------------------------------------------------------------------- R5

def _scripted(P, tmpdir, crashes=()):
    """``tests/test_replica.py::_scripted_replicated_run``."""
    nem = P.nem(crashes=tuple(P.crash(*c) for c in crashes)) \
        if crashes else None
    cl = P.sim.Cluster(P.types.DiLiConfig(**REP), seed=7, nemesis=nem,
                       durability=str(tmpdir), **P.extra)
    cl.submit(0, [TT.OP_INSERT] * len(KEYS), list(KEYS))
    cl.run_until_quiet(800)
    ents = [e for e in cl.sublists(0) if e["owner"] == 0]
    assert cl.replicate(0, ents[0]["keymax"], 1)
    for _ in range(50):
        cl.step()
    cl.submit(1, [TT.OP_FIND] * 5, [10, 11, 13, 397, 399])
    cl.run_until_quiet(800)
    return cl


def _same(ref, port):
    assert port.round_no == ref.round_no
    assert port.results == ref.results
    assert port.round_trace == ref.round_trace
    for s in range(ref.n):
        assert_trees_equal(ref.states[s], port.states[s], f"state[{s}]")
        assert_trees_equal(ref.bgs[s], port.bgs[s], f"bg[{s}]")


def test_replicate_command_replays_byte_identically(tmp_path):
    from repro_torch.core.net import state_digest
    a = _scripted(PKGS["port"], tmp_path / "a")
    b = _scripted(PKGS["port"], tmp_path / "b")
    assert state_digest(a.states, a.bgs) == state_digest(b.states, b.bgs)
    assert a.durability.stats["commands"] == 1
    _same(_scripted(PKGS["ref"], tmp_path / "r"), a)


def test_replicate_survives_primary_crash_restart(tmp_path):
    runs = {n: _scripted(P, tmp_path / n, crashes=[(0, 15, 35)])
            for n, P in PKGS.items()}
    cl = runs["port"]
    assert cl.durability.stats["recoveries"] == 1
    assert cl.durability.stats["commands"] >= 1
    assert (np.asarray(cl.states[0].rep.keymax) != TT.SH_KEY).any(), \
        "the recovered primary lost its replication session"
    _same(runs["ref"], cl)
    for c in runs.values():
        c.submit(2, [TT.OP_FIND] * 3, [10, 11, 399])
        c.run_until_quiet(800)
    _same(runs["ref"], cl)


# --------------------------------------------------------------------- Q

def _states():
    """The same 3-shard state pair (reference, port) after a load, one
    session already open on shard 0's entry towards shard 1."""
    ref = RSIM.Cluster(JT.DiLiConfig(**REP))
    ref.submit(0, [JT.OP_INSERT] * 40, list(range(5, 205, 5)))
    ref.run_until_quiet(400)
    kmax = ref.sublists(0)[0]["keymax"]
    assert ref.replicate(0, kmax, 1)
    return ref.states[0], _to_port(ref.states[0]), kmax


@pytest.mark.parametrize("cmd,args", [
    ("rep", "kmax,2"),          # widen the open session
    ("rep", "kmax,1"),          # the same target again
    ("rep", "kmax,0"),          # the owner itself
    ("rep", "kmax,3"),          # outside the cluster
    ("rep", "kmax,-1"),
    ("rep", "12345,2"),         # no such entry
    ("drop", "kmax,1"),
    ("drop", "kmax,2"),         # not a target: no bit to clear
    ("drop", "kmax,-1"),        # every target
    ("drop", "kmax,40"),        # a shift past the lane, clipped
    ("drop", "999,1"),          # no such session
])
def test_queue_commands_match_reference(cmd, args):
    cfg_j, cfg_t = JT.DiLiConfig(**REP), TT.DiLiConfig(**REP)
    ref, port, kmax = _states()
    a = [kmax if x == "kmax" else int(x) for x in args.split(",")]
    jfn, tfn = {"rep": (JR.queue_replicate, TR.queue_replicate),
                "drop": (JR.queue_drop_replica,
                         TR.queue_drop_replica)}[cmd]
    before = digest(port)
    rs, rok = jfn(ref, cfg_j, *a)
    ps, pok = tfn(port, cfg_t, *a)
    assert bool(pok) == bool(rok)
    assert_trees_equal(rs, ps, "state")
    assert digest(port) == before                     # pure


def test_sessions_exhaust_and_reject():
    cfg_j = JT.DiLiConfig(**dict(REP, replica_sessions=1))
    cfg_t = TT.DiLiConfig(**dict(REP, replica_sessions=1))
    ref = RSIM.Cluster(cfg_j)
    ref.submit(0, [JT.OP_INSERT] * 40, list(range(5, 205, 5)))
    ref.run_until_quiet(400)
    ent = ref.sublists(0)[0]
    assert ref.split(0, ent["keymax"], ref.middle_item(0, ent["head_idx"]))
    ref.run_until_quiet(400)
    a, b = [e["keymax"] for e in ref.sublists(0) if e["owner"] == 0][:2]
    st_j = ref.states[0]
    st_t = _to_port(st_j)
    for k in (a, b):
        st_j, ok_j = JR.queue_replicate(st_j, cfg_j, k, 1)
        st_t, ok_t = TR.queue_replicate(st_t, cfg_t, k, 1)
        assert bool(ok_t) == bool(ok_j)
        assert_trees_equal(st_j, st_t, "state")
    assert not ok_t                 # the one session is taken by `a`


# --------------------------------------------------------------------- X

def _workload(P, tmpdir):
    """Two shards, a WAL, a replicate and a drop on shard 0's entry, reads
    and value-0 writes racing the stream."""
    cfg = P.types.DiLiConfig(**dict(REP, num_shards=2))
    cl = P.sim.Cluster(cfg, seed=3, durability=str(tmpdir), **P.extra)
    cl.submit(0, [TT.OP_INSERT] * len(KEYS), list(KEYS))
    cl.run_until_quiet(800)
    kmax = cl.sublists(0)[0]["keymax"]
    assert cl.replicate(0, kmax, 1)
    for r in range(24):
        cl.submit(1, [TT.OP_FIND, TT.OP_INSERT, TT.OP_REMOVE],
                  [10 + 3 * r, 11 + 3 * r, 13 + 3 * r])
        cl.step()
    assert cl.drop_replica(0, kmax, 1)
    assert not cl.drop_replica(0, kmax, 1)      # journaled as rejected
    for _ in range(6):
        cl.step()
    assert cl.stats["rep_hits"] > 0
    return cl


def test_replication_wal_crosses_the_packages(tmp_path):
    from repro.core.durability.recovery import recover_shard as ref_recover
    from repro_torch.core.durability import wal as TW
    from repro_torch.core.durability.recovery import recover_shard
    ref = _workload(PKGS["ref"], tmp_path / "ref")
    port = _workload(PKGS["port"], tmp_path / "port")
    _same(ref, port)
    assert port.durability.stats == ref.durability.stats
    cmds = [int(r["cmd"]) for r in port.durability.wal(0).records()
            if int(r["kind"]) == TW.KIND_COMMAND]
    assert cmds == [TW.CMD_REPLICATE, TW.CMD_DROP_REPLICA,
                    TW.CMD_DROP_REPLICA]
    cfg_t = TT.DiLiConfig(**dict(REP, num_shards=2))
    cfg_j = JT.DiLiConfig(**dict(REP, num_shards=2))
    for s in range(2):
        # the reference's WAL + snapshot, replayed by the port's round
        got = recover_shard(
            cfg_t, s, TD.WriteAheadLog(str(tmp_path / "ref" /
                                           f"shard_{s:02d}.wal")),
            TD.ShardSnapshots(str(tmp_path / "ref"), s),
            in_cap=port.in_cap, device="cpu")
        # the port's files, replayed by the reference's round
        back = ref_recover(
            cfg_j, s, RD.WriteAheadLog(str(tmp_path / "port" /
                                           f"shard_{s:02d}.wal")),
            RD.ShardSnapshots(str(tmp_path / "port"), s),
            in_cap=ref.in_cap)
        assert got.replayed_rounds == back.replayed_rounds > 0
        for rec in (got, back):
            assert_trees_equal(ref.states[s], rec.state, f"state[{s}]")
            assert_trees_equal(ref.bgs[s], rec.bg, f"bg[{s}]")
            assert np.array_equal(rec.backlog, ref.backlog[s])


def test_snapshots_keep_rep_and_rslots_as_the_reference(tmp_path):
    cl = RSIM.Cluster(JT.DiLiConfig(**REP))
    cl.submit(0, [JT.OP_INSERT] * 40, list(range(5, 205, 5)))
    cl.run_until_quiet(400)
    assert cl.replicate(0, cl.sublists(0)[0]["keymax"], 1)
    for _ in range(100):
        if int(np.asarray(cl.states[1].rslots.ttl).max()) > 0:
            break
        cl.step()
    assert int(np.asarray(cl.states[1].rslots.ttl).max()) > 0
    for s in (0, 1):            # the primary's session, the replica's slot
        files = {}
        for name, D, st, bg in (
                ("ref", RD, cl.states[s], cl.bgs[s]),
                ("port", TD, _to_port(cl.states[s]),
                 convert.bg_table_from_numpy(convert.bg_table_to_numpy(
                     cl.bgs[s]), device="cpu"))):
            snaps = D.ShardSnapshots(str(tmp_path / name), s)
            snaps.save(3, st, bg, np.zeros((0, 15), np.int32), {})
            files[name] = np.load(snaps.mgr._path(4))
        keys = [k for k in files["ref"].files
                if "/rep/" in k or "/rslots/" in k]
        assert len(keys) == 14
        assert sorted(files["port"].files) == sorted(files["ref"].files)
        for k in keys:
            a, b = files["ref"][k], files["port"][k]
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert files["port"]["state/rep/diff"].dtype == np.bool_
        # and each package restores the other's file to the live state
        port_back = TD.ShardSnapshots(str(tmp_path / "ref"), s).load_latest(
            TT.DiLiConfig(**REP), device="cpu")
        ref_back = RD.ShardSnapshots(str(tmp_path / "port"), s).load_latest(
            JT.DiLiConfig(**REP))
        for back in (port_back, ref_back):
            assert_trees_equal(cl.states[s], back["state"], f"state[{s}]")
