"""The port's WAL, snapshots and recovery against the reference's files.

D1  WAL framing: round trip, torn tail, truncation; a log written by
    either package reads back record for record in the other.
D2  Snapshots: genesis/latest/retention and a full round trip; a snapshot
    written by either package loads in the other to the same state.
D3  Transport under crash: the down-NIC drop, the lane image, the
    retransmission after a restart — both packages, frame for frame.
D4  Membership crash/restart lifecycle, event for event with the
    reference.
X   Cross-package recovery: a WAL + snapshot written by the reference
    recovers in the port to the reference's live state, and the reverse
    (value-0 workload: the reference drops a delegated op's value,
    ROADMAP Queue 3 item 3).
C   Background commands: split/move/merge are journaled as KIND_COMMAND
    records and recovery re-queues them to the live state.
V   A delegated INSERT's nonzero value survives the port's own recovery.
G   Group commit: fewer fsyncs for the same records.
"""
import numpy as np
import pytest

import repro.core.durability as RD
import repro.core.membership as RMB
import repro.core.messages as RM
import repro.core.net as RN
import repro.core.sim as RSIM
import repro.core.types as RT
import repro_torch.core.bg as TB
import repro_torch.core.durability as TD
import repro_torch.core.membership as TMB
import repro_torch.core.messages as TM
import repro_torch.core.net as TN
import repro_torch.core.sim as TSIM
import repro_torch.core.types as TT
from repro.core.durability import wal as RW
from repro_torch.core.durability import wal as TW
from repro_torch.core.durability.recovery import recover_shard
from torch_parity import assert_trees_equal

PKGS = {"ref": (RD, RW, RM), "port": (TD, TW, TM)}


def _round_rec(W, M, rnd, **extra):
    rec = {"round": np.int64(rnd), "kind": np.int64(W.KIND_ROUND),
           "appends": np.zeros((0, M.FIELDS), np.int32)}
    rec.update(extra)
    return rec


def _same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


# ----------------------------------------------------------------- D1: WAL

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_wal_roundtrip_and_kinds_across_packages(tmp_path, writer):
    D, W, M = PKGS[writer]
    w = D.WriteAheadLog(str(tmp_path / "s.wal"))
    rows = np.arange(2 * M.FIELDS, dtype=np.int32).reshape(2, M.FIELDS)
    w.append({"round": np.int64(3), "kind": np.int64(W.KIND_SUBMIT),
              "appends": rows})
    w.append(_round_rec(W, M, 3, **{"lane/send/1/next_seq": np.int64(7)}))
    w.append({"round": np.int64(4), "kind": np.int64(W.KIND_COMMAND),
              "cmd": np.int64(W.CMD_MOVE), "args": np.asarray([9, 1]),
              "ok": np.int64(1)})
    w.close()
    path = str(tmp_path / "s.wal")
    mine = list(TD.WriteAheadLog(path).records())
    _same_records(mine, list(RD.WriteAheadLog(path).records()))
    assert [int(r["kind"]) for r in mine] == \
        [TW.KIND_SUBMIT, TW.KIND_ROUND, TW.KIND_COMMAND]
    assert np.array_equal(mine[0]["appends"], rows)
    assert int(mine[1]["lane/send/1/next_seq"]) == 7
    assert (TW.MAGIC, TW._HEADER.format) == (RW.MAGIC, RW._HEADER.format)
    assert (TW.CMD_SPLIT, TW.CMD_MOVE, TW.CMD_MERGE, TW.CMD_REPLICATE,
            TW.CMD_DROP_REPLICA) == (RW.CMD_SPLIT, RW.CMD_MOVE,
                                     RW.CMD_MERGE, RW.CMD_REPLICATE,
                                     RW.CMD_DROP_REPLICA)


def test_wal_torn_tail_is_dropped(tmp_path):
    path = str(tmp_path / "s.wal")
    w = TD.WriteAheadLog(path)
    for r in range(3):
        w.append(_round_rec(TW, TM, r))
    w.close()
    with open(path, "ab") as fh:
        fh.write(b"DWAL\x99\x00\x00\x00\x07")
    assert [int(r["round"]) for r in TD.WriteAheadLog(path).records()] == \
        [0, 1, 2]
    path2 = str(tmp_path / "s2.wal")
    w2 = TD.WriteAheadLog(path2)
    for r in range(3):
        w2.append(_round_rec(TW, TM, r))
    w2.close()
    blob = open(path2, "rb").read()
    with open(path2, "wb") as fh:          # flip a payload byte of rec 2
        fh.write(blob[:-5] + bytes([blob[-5] ^ 0xFF]) + blob[-4:])
    assert [int(r["round"]) for r in TD.WriteAheadLog(path2).records()] == \
        [0, 1]
    assert [int(r["round"]) for r in RD.WriteAheadLog(path2).records()] == \
        [0, 1]


def test_wal_truncate_keeps_suffix_and_stays_appendable(tmp_path):
    w = TD.WriteAheadLog(str(tmp_path / "s.wal"))
    for r in range(10):
        w.append(_round_rec(TW, TM, r))
    assert w.truncate_upto(4) == 5
    assert [int(r["round"]) for r in w.records()] == list(range(5, 10))
    w.append(_round_rec(TW, TM, 10))
    assert [int(r["round"]) for r in w.records()] == list(range(5, 11))
    assert w.fsyncs == 11 and w.bytes_written > 0     # one per append


# ----------------------------------------------------------- D2: snapshots

MINI = dict(num_shards=2, pool_capacity=256, max_sublists=8, max_ctrs=8,
            max_scan=256, batch_size=4, mailbox_cap=16, move_batch=2)


def _lanes():
    return {"send/1/next_seq": np.int64(5), "send/1/acked": np.int64(2),
            "recv/1/rows": np.ones((4, TM.FIELDS), np.int32)}


def test_snapshot_roundtrip_and_retention(tmp_path):
    cfg = TT.DiLiConfig(**MINI)
    snaps = TD.ShardSnapshots(str(tmp_path), 0, keep=2)
    assert snaps.latest_round() is None
    state = TT.init_shard(cfg, 0, bootstrap=True, device="cpu")
    bg = TB.init_bg_table(cfg, "cpu")
    backlog = np.zeros((3, TM.FIELDS), np.int32)
    backlog[:, TM.F_KEY] = [1, 2, 3]
    snaps.save(7, state, bg, backlog, _lanes())
    assert snaps.latest_round() == 7
    base = snaps.load_latest(cfg, "cpu")
    assert base["round"] == 7
    assert np.array_equal(base["backlog"], backlog)
    assert int(base["lanes"]["send/1/next_seq"]) == 5
    assert np.array_equal(base["lanes"]["recv/1/rows"],
                          _lanes()["recv/1/rows"])
    assert_trees_equal(state, base["state"])
    assert_trees_equal(bg, base["bg"], "bg")
    for r in (15, 23):
        snaps.save(r, state, bg, backlog, _lanes())
    assert snaps.latest_round() == 23
    assert len(snaps.mgr._steps()) == 2


def test_snapshot_files_cross_packages(tmp_path):
    rcfg, tcfg = RT.DiLiConfig(**MINI), TT.DiLiConfig(**MINI)
    backlog = np.arange(2 * TM.FIELDS, dtype=np.int32).reshape(2, -1)
    # a bootstrapped shard with a sign-bit ref: uint32 in the reference
    rstate = RT.init_shard(rcfg, 1, bootstrap=True)
    tstate = TT.init_shard(tcfg, 1, bootstrap=True, device="cpu")
    from repro.core import bg as RB
    rbg, tbg = RB.init_bg_table(rcfg), TB.init_bg_table(tcfg, "cpu")
    RD.ShardSnapshots(str(tmp_path / "r"), 1).save(4, rstate, rbg, backlog,
                                                   _lanes())
    TD.ShardSnapshots(str(tmp_path / "t"), 1).save(4, tstate, tbg, backlog,
                                                   _lanes())
    rfile = np.load(tmp_path / "r" / "shard_01" / "step_000000005.npz")
    tfile = np.load(tmp_path / "t" / "shard_01" / "step_000000005.npz")
    assert sorted(rfile.files) == sorted(tfile.files)
    for k in rfile.files:               # the same file, dtype for dtype
        assert rfile[k].dtype == tfile[k].dtype, k
        assert np.array_equal(rfile[k], tfile[k]), k
    # each package loads the other's file
    got = TD.ShardSnapshots(str(tmp_path / "r"), 1).load_latest(tcfg, "cpu")
    assert_trees_equal(rstate, got["state"])
    assert_trees_equal(rbg, got["bg"], "bg")
    back = RD.ShardSnapshots(str(tmp_path / "t"), 1).load_latest(rcfg)
    assert_trees_equal(back["state"], tstate)
    assert np.array_equal(back["backlog"], backlog)


# ----------------------------------------------------------- D3: transport

def _mkrow(M, src, dst, payload):
    row = np.zeros((M.FIELDS,), np.int32)
    row[M.F_KIND] = M.MSG_OP
    row[M.F_SRC] = src
    row[M.F_DST] = dst
    row[M.F_KEY] = payload
    return row


def _pump(tp, start, rounds):
    got = [[] for _ in range(tp.n)]
    for r in range(start, start + rounds):
        for d, rows in enumerate(tp.ship_round(r)):
            got[d].extend(rows)
    return [[x.tolist() for x in g] for g in got]


def _both(scenario):
    ref = scenario(RN, RM)
    port = scenario(TN, TM)
    assert port[0] == ref[0] and port[1].stats == ref[1].stats
    return port


def test_down_shard_receives_nothing_then_retransmission_heals():
    def scenario(N, M):
        tp = N.Transport(2, retransmit_after=2)
        tp.send(0, np.stack([_mkrow(M, 0, 1, p) for p in (10, 11, 12)]))
        image = tp.export_shard_lanes(1)
        tp.crash_shard(1)
        during = _pump(tp, 0, 6)
        tp.restart_shard(1, image)
        return (during, _pump(tp, 6, 8), tp.idle()), tp

    (during, after, idle), tp = _both(scenario)
    assert during[1] == [] and tp.stats["down_dropped"] > 0
    assert [r[TM.F_KEY] for r in after[1]] == [10, 11, 12]
    assert idle


def test_lane_image_preserves_dedup_window_across_restart():
    def scenario(N, M):
        tp = N.Transport(2, retransmit_after=2)
        tp.send(0, np.stack([_mkrow(M, 0, 1, p) for p in (1, 2)]))
        _pump(tp, 0, 4)
        image = tp.export_shard_lanes(1)
        img = {k: np.asarray(v).tolist() for k, v in image.items()}
        tp.crash_shard(1)
        tp.send(0, np.stack([_mkrow(M, 0, 1, 3)]))
        _pump(tp, 4, 3)
        tp.restart_shard(1, image)
        return (img, _pump(tp, 7, 8), tp.idle()), tp

    (_, got, idle), tp = _both(scenario)
    assert [r[TM.F_KEY] for r in got[1]] == [3]
    assert tp.stats["delivered"] == 3 and idle


# ---------------------------------------------------------- D4: membership

def test_membership_crash_restart_lifecycle():
    logs = []
    for MB in (RMB, TMB):
        mb = MB.Membership(4, 3)
        with pytest.raises(ValueError, match="cannot crash"):
            mb.crash(3)
        e0 = mb.epoch
        mb.crash(1)
        assert mb.crashed == (1,) and mb.routable == (0, 2)
        assert 1 not in mb.targets and mb.epoch == e0 + 1
        with pytest.raises(ValueError, match="cannot crash"):
            mb.crash(1)
        mb.restart(1)
        assert mb.state_of(1) == "joining"
        mb.promote(1)
        assert mb.is_active(1)
        mb.begin_drain(2)
        mb.crash(2)
        assert mb.draining == ()
        mb.restart(2)
        assert mb.state_of(2) == "joining"
        with pytest.raises(ValueError, match="cannot restart"):
            mb.restart(0)
        logs.append((list(mb.log), mb.view(), mb.mask()))
    assert logs[1] == logs[0]


# --------------------------------------- X: recovery across the packages

SMALL = dict(num_shards=2, pool_capacity=4096, max_sublists=32, max_ctrs=32,
             max_scan=4096, batch_size=16, mailbox_cap=256, move_batch=2)


def _workload(cl, I):
    """Value-0 inserts, a split, a merge, a split, a move and racing ops,
    stopped mid-flight so backlogs, bg slots and lanes are live."""
    keys = list(range(10, 250, 3))
    cl.submit(0, [I.OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(600)

    def owned(s):
        return sorted((e for e in cl.sublists(s) if e["owner"] == s),
                      key=lambda e: e["keymin"])

    def split(i):
        e = owned(0)[i]
        assert cl.split(0, e["keymax"], cl.middle_item(0, e["head_idx"]))
        cl.run_until_quiet(600)

    split(0)
    a, b = owned(0)[:2]
    assert cl.merge(0, a["keymax"], b["keymax"])
    cl.run_until_quiet(600)
    split(0)
    assert cl.move(0, owned(0)[0]["keymax"], 1)
    rng = np.random.default_rng(5)
    for _ in range(9):
        ks = rng.integers(1, 260, 3).tolist()
        cl.submit(1, [I.OP_INSERT, I.OP_REMOVE, I.OP_FIND], ks)
        cl.step()
    # a command after the last snapshot: replay must re-queue it
    e = owned(0)[-1]
    assert cl.split(0, e["keymax"], cl.middle_item(0, e["head_idx"]))


def _run_both(tmp_path):
    dcfg = dict(snapshot_every=16)
    nem = dict(drop_prob=0.05, dup_prob=0.05, reorder_prob=0.05)
    ref = RSIM.Cluster(
        RT.DiLiConfig(**SMALL), seed=4, nemesis=RN.NemesisConfig(**nem),
        durability=RD.Durability(str(tmp_path / "ref"),
                                 RT.DiLiConfig(**SMALL),
                                 RD.DurabilityConfig(**dcfg)))
    port = TSIM.Cluster(
        TT.DiLiConfig(**SMALL), seed=4, nemesis=TN.NemesisConfig(**nem),
        device="cpu",
        durability=TD.Durability(str(tmp_path / "port"),
                                 TT.DiLiConfig(**SMALL),
                                 TD.DurabilityConfig(**dcfg)))
    _workload(ref, RT)
    _workload(port, TT)
    assert port.round_trace == ref.round_trace
    assert port.durability.stats == ref.durability.stats
    return ref, port


def _assert_recovered(rec, cl, s, *, rec_is_ref):
    live = (cl.states[s], cl.bgs[s])
    got = (rec.state, rec.bg)
    if rec_is_ref:
        live, got = got, live
    assert_trees_equal(live[0], got[0], f"state[{s}]")
    assert_trees_equal(live[1], got[1], f"bg[{s}]")
    assert np.array_equal(rec.backlog, cl.backlog[s])
    image = cl.net.export_shard_lanes(s)
    assert sorted(rec.lanes) == sorted(image)
    for k, v in image.items():
        assert np.array_equal(np.asarray(rec.lanes[k]), v), k
    assert rec.last_round == cl.round_no - 1


def test_reference_files_recover_in_the_port_and_the_reverse(tmp_path):
    ref, port = _run_both(tmp_path)
    from repro.core.durability.recovery import recover_shard as ref_recover
    kinds = set()
    for s in range(2):
        # the reference's WAL + snapshot, replayed by the port's round
        rec = recover_shard(
            TT.DiLiConfig(**SMALL), s,
            TD.WriteAheadLog(str(tmp_path / "ref" / f"shard_{s:02d}.wal")),
            TD.ShardSnapshots(str(tmp_path / "ref"), s),
            in_cap=port.in_cap, device="cpu")
        assert rec.replayed_rounds > 0
        _assert_recovered(rec, ref, s, rec_is_ref=False)
        # the port's files, replayed by the reference's round
        back = ref_recover(
            RT.DiLiConfig(**SMALL), s,
            RD.WriteAheadLog(str(tmp_path / "port" / f"shard_{s:02d}.wal")),
            RD.ShardSnapshots(str(tmp_path / "port"), s),
            in_cap=ref.in_cap)
        assert back.replayed_rounds == rec.replayed_rounds
        _assert_recovered(back, port, s, rec_is_ref=True)
        kinds |= {int(r["kind"]) for r in port.durability.wal(s).records()}
    assert kinds == {TW.KIND_ROUND, TW.KIND_SUBMIT, TW.KIND_COMMAND}


# ------------------------------------------ C: background command replay

def test_split_move_merge_commands_replay_to_the_live_state(tmp_path):
    cfg = TT.DiLiConfig(**SMALL)
    dur = TD.Durability(str(tmp_path), cfg,
                        TD.DurabilityConfig(snapshot_every=0))
    cl = TSIM.Cluster(cfg, seed=2, device="cpu",
                      nemesis=TN.NemesisConfig(), durability=dur)
    _workload(cl, TT)
    cmds = [(int(r["cmd"]), bool(int(r["ok"])))
            for s in range(2) for r in dur.wal(s).records()
            if int(r["kind"]) == TW.KIND_COMMAND]
    assert sorted(cmds) == sorted([(TW.CMD_SPLIT, True)] * 3
                                  + [(TW.CMD_MERGE, True),
                                     (TW.CMD_MOVE, True)])
    for s in range(2):
        rec = dur.recover(s, in_cap=cl.in_cap, device="cpu")
        _assert_recovered(rec, cl, s, rec_is_ref=False)
    assert dur.stats["recoveries"] == 2
    # a replayed command whose verdict differs from the journaled one is a
    # divergence, not a silent skip
    bad = TD.Durability(str(tmp_path / "bad"), cfg,
                        TD.DurabilityConfig(snapshot_every=0))
    bad.ensure_genesis(0, TT.init_shard(cfg, 0, bootstrap=True,
                                        device="cpu"),
                       TB.init_bg_table(cfg, "cpu"),
                       np.zeros((0, TM.FIELDS), np.int32), {})
    bad.log_command(0, 0, TW.CMD_MOVE, (TT.KEY_MAX, 1), False)
    with pytest.raises(TD.RecoveryError, match="accepted"):
        bad.recover(0, in_cap=cl.in_cap, device="cpu")


# ------------------------------------------------ V: a delegated value

def test_delegated_value_survives_the_ports_recovery():
    """The port keeps a delegated INSERT's value (the reference drops it,
    ROADMAP Queue 3 item 3); a crash and WAL replay of the owner keeps it
    too."""
    cfg = TT.DiLiConfig(**SMALL)
    cl = TSIM.Cluster(cfg, seed=1, device="cpu",
                      nemesis=TN.NemesisConfig(crashes=(
                          TN.CrashPlan(0, 12, 20),)))
    cl.submit(1, [TT.OP_INSERT] * 3, [7, 8, 9], [70, 80, 90])
    cl.run(12)
    head = [e for e in cl.sublists(0) if e["owner"] == 0][0]["head_idx"]
    before = cl.shard_chain(0, head, include_meta=True)
    assert [(k, v) for k, _, v in before] == [(7, 70), (8, 80), (9, 90)]
    cl.run_until_quiet(200)
    assert cl.durability.stats["recoveries"] == 1
    assert cl.durability.stats["replayed_rounds"] == 12
    assert cl.shard_chain(0, head, include_meta=True) == before


# ---------------------------------------------------- G: group commit

def _group_commit_run(tmpdir, every, crashes=()):
    cfg = TT.DiLiConfig(**SMALL)
    dur = TD.Durability(str(tmpdir), cfg,
                        TD.DurabilityConfig(snapshot_every=0,
                                            group_commit_rounds=every))
    nem = TN.NemesisConfig(crashes=tuple(crashes)) if crashes else None
    cl = TSIM.Cluster(cfg, seed=3, nemesis=nem, durability=dur, device="cpu")
    keys = list(range(10, 310, 3))
    cl.submit(0, [TT.OP_INSERT] * len(keys), keys)
    cl.run_until_quiet(600)
    while cl.round_no < 64:
        cl.step()
    return cl, dur, keys


def test_group_commit_write_amplification(tmp_path):
    _, d1, _ = _group_commit_run(tmp_path / "g1", 1)
    _, d8, _ = _group_commit_run(tmp_path / "g8", 8)
    f1, f8 = d1.fsync_count(), d8.fsync_count()
    assert d1.stats["records"] == d8.stats["records"]
    assert f8 > 0 and f1 >= 4 * f8, (f1, f8)
    assert d1.fsync_seconds() > 0 and d1.wal_bytes() == d8.wal_bytes()
