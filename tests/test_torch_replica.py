"""Read replication (DESIGN.md §15): the port against the reference, bit for
bit, on the CPU.

R1-R4  The workloads of ``tests/test_replica.py`` (the lifecycle, the
       lease lapse, a mutation reaching the replica, a Move of the
       replicated entry) through both packages: every round's digest of
       every shard's state (``rep`` and ``rslots`` included) and
       background table, op results, stats and the replica view agree,
       and the port passes the reference test's own checks.
S      ``searchsorted_scan`` against ``jnp.searchsorted`` on random
       unsorted int32 rows (a slot whose deltas are still landing), and
       ``replica_serve`` on such a slot.

The commands, their replay and the files: ``test_torch_replica_files.py``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as JA
import repro.core.replica as JR
import repro.core.sim as RSIM
import repro.core.types as JT
import repro_torch.api as TA
import repro_torch.core.replica as TR
import repro_torch.core.sim as TSIM
import repro_torch.core.types as TT
from repro.core.net import NemesisConfig as RNem
from repro.core.net.nemesis import CrashPlan as RCrash
from repro_torch import convert
from repro_torch.core.net import CrashPlan as TCrash
from repro_torch.core.net import NemesisConfig as TNem
from torch_parity import assert_trees_equal, digest

PKGS = {
    "ref": SimpleNamespace(api=JA, sim=RSIM, types=JT, extra={},
                           nem=RNem, crash=RCrash),
    "port": SimpleNamespace(api=TA, sim=TSIM, types=TT,
                            extra=dict(device="cpu"), nem=TNem,
                            crash=TCrash),
}

REP = dict(num_shards=3, pool_capacity=4096, max_sublists=32, max_ctrs=32,
           max_scan=4096, batch_size=16, mailbox_cap=256, move_batch=8,
           replication=True, replica_sessions=2, replica_slots=4,
           replica_batch=8, replica_refresh_rounds=4,
           replica_staleness_rounds=32)
KEYS = list(range(10, 400, 3))


def _to_port(state):
    return convert.shard_state_from_numpy(
        convert.shard_state_to_numpy(state), device="cpu")


def _recorded(cl):
    """Append a digest of every shard's state and table after each round."""
    cl.digests = []
    step = cl.step

    def recorded():
        out = step()
        cl.digests.append(digest(cl.states, cl.bgs))
        return out

    cl.step = recorded
    return cl


def _loaded(P, **over):
    be = P.api.LocalBackend(P.types.DiLiConfig(**dict(REP, **over)),
                            **P.extra)
    _recorded(be.cluster)
    client = P.api.DiLiClient(be)
    client.insert_batch(KEYS)
    client.drain(2000)
    return be, client


def _entry(be, shard=0):
    ents = [e for e in be.sublists(shard) if e["owner"] == shard]
    assert len(ents) == 1
    return ents[0]["keymax"]


def _ttl(be, s):
    return int(np.asarray(be.cluster.states[s].rslots.ttl).max())


def _pump_until(client, pred, rounds=200):
    for _ in range(rounds):
        if pred():
            return True
        client.pump()
    return pred()


def _finds(client, probe):
    futs = client.find_batch(probe)
    client.drain(2000)
    return [bool(r) for r in futs.results()]


# ---------------------------------------------------------------- R1-R4

def lifecycle(P):
    be, client = _loaded(P)
    kmax = _entry(be)
    assert be.replicate(0, kmax, 1) and be.replicate(0, kmax, 2)
    sets = be.replica_sets()
    assert sets[kmax][1] == 0 and sets[kmax][2] == [1, 2]
    assert _pump_until(client, lambda: all(_ttl(be, t) > 0 for t in (1, 2)))
    probe = KEYS[::7] + [11, 12, 200, 399]
    got = [_finds(client, probe)]
    assert got[0] == [k in set(KEYS) for k in probe]
    assert be.stats["rep_hits"] > 0
    assert be.drop_replica(0, kmax)
    assert _pump_until(client, lambda: all(_ttl(be, t) == 0
                                           for t in (1, 2)))
    assert be.replica_sets() == {}
    h0 = be.stats["rep_hits"]
    got.append(_finds(client, probe))
    assert got[1] == got[0] and be.stats["rep_hits"] == h0
    return be, got


def lease_lapse(P):
    be, client = _loaded(P, replica_refresh_rounds=10_000,
                         replica_staleness_rounds=6)
    assert be.replicate(0, _entry(be), 1)
    assert _pump_until(client, lambda: _ttl(be, 1) > 0)
    for _ in range(6 + 2):
        client.pump()
    assert _ttl(be, 1) == 0
    h0 = be.stats["rep_hits"]
    probe = KEYS[:8] + [11, 14]
    got = _finds(client, probe)
    assert got == [k in set(KEYS) for k in probe]
    assert be.stats["rep_hits"] == h0
    return be, got


def mutation_reaches_replica(P):
    be, client = _loaded(P, replica_refresh_rounds=3)
    assert be.replicate(0, _entry(be), 1)
    assert _pump_until(client, lambda: _ttl(be, 1) > 0)
    client.insert(101)
    client.drain(2000)

    def image_has_key():
        client.find(KEYS[0])     # cadence renewals need traffic
        return 101 in np.asarray(be.cluster.states[1].rslots.keys)
    assert _pump_until(client, image_has_key, rounds=3 + 8 + 16)
    client.drain(2000)
    return be, []


def move_retires_replicas(P):
    be, client = _loaded(P)
    kmax = _entry(be)
    assert be.replicate(0, kmax, 1)
    assert _pump_until(client, lambda: _ttl(be, 1) > 0)
    assert be.move(0, kmax, 2)
    client.drain(2000)
    assert be.replica_sets() == {}
    assert _pump_until(client, lambda: _ttl(be, 1) == 0)
    assert all(int(k) == TT.SH_KEY
               for k in np.asarray(be.cluster.states[0].rep.keymax))
    probe = KEYS[::11] + [11, 398]
    got = _finds(client, probe)
    assert got == [k in set(KEYS) for k in probe]
    return be, got


@pytest.mark.parametrize("workload", [
    lifecycle, lease_lapse, mutation_reaches_replica, move_retires_replicas],
    ids=["R1_lifecycle", "R2_lease_lapse", "R3_mutation", "R4_move"])
def test_replication_workload_matches_reference(workload):
    runs = {name: workload(P) for name, P in PKGS.items()}
    (ref, rgot), (port, pgot) = runs["ref"], runs["port"]
    rcl, pcl = ref.cluster, port.cluster
    assert pcl.round_no == rcl.round_no == len(pcl.digests)
    for r, (a, b) in enumerate(zip(rcl.digests, pcl.digests)):
        assert a == b, f"state digest differs after round {r + 1}"
    assert pgot == rgot
    assert port.stats == ref.stats
    assert pcl.results == rcl.results
    assert pcl.replica_epoch == rcl.replica_epoch
    assert port.replica_sets() == ref.replica_sets()
    assert pcl.rep_rate_ewma == rcl.rep_rate_ewma
    for s in range(rcl.n):
        assert_trees_equal(rcl.states[s], pcl.states[s], f"state[{s}]")


# --------------------------------------------------------------------- S

@pytest.mark.parametrize("c", [1, 31, 160, 161])
def test_searchsorted_scan_matches_jax_on_unsorted_rows(c):
    rng = np.random.default_rng(c)
    b = 512
    rows = rng.integers(-50, 50, (b, c)).astype(np.int32)
    rows[: b // 4] = np.sort(rows[: b // 4], axis=1)      # some sorted
    rows[b // 8: b // 4, -1] = TT.ST_KEY                   # padded
    q = rng.integers(-60, 60, b).astype(np.int32)
    q[:8] = TT.ST_KEY
    want = np.array([int(jnp.searchsorted(jnp.asarray(r), jnp.int32(x),
                                          side="left"))
                     for r, x in zip(rows, q)])
    got = TR.searchsorted_scan(torch.from_numpy(rows),
                               torch.from_numpy(q)).numpy()
    assert np.array_equal(got, want)
    srt = np.sort(rows[b // 4:], axis=1)                  # sorted: numpy's
    assert np.array_equal(
        TR.searchsorted_scan(torch.from_numpy(srt),
                             torch.from_numpy(q[b // 4:])).numpy(),
        [np.searchsorted(r, x, side="left") for r, x in zip(srt, q[b // 4:])])


def test_replica_serve_on_an_unsorted_slot_matches_reference():
    """A slot mid-stream: committed and leased, its row half rewritten by
    deltas, so unsorted. Every FIND row gets the reference's verdict."""
    from repro_torch.core import messages as TM
    cfg_j, cfg_t = JT.DiLiConfig(**REP), TT.DiLiConfig(**REP)
    ref_state = RSIM.Cluster(cfg_j).states[1]
    rng = np.random.default_rng(5)
    keys = np.full((160,), TT.ST_KEY, np.int32)
    keys[:60] = np.sort(rng.choice(np.arange(1, 400), 60, replace=False))
    keys[:30] = rng.permutation(keys[:30]) + 3           # deltas landing
    rs = {f: np.array(v) for f, v in ref_state.rslots._asdict().items()}
    rs["keymax"][0], rs["keymin"][0], rs["src"][0] = 399, 0, 0
    rs["version"][0], rs["ttl"][0], rs["keys"][0] = 2, 5, keys
    ref_state = ref_state._replace(rslots=ref_state.rslots._replace(
        **{f: jnp.asarray(v) for f, v in rs.items()}))
    port_state = _to_port(ref_state)
    rows = np.zeros((300, TM.FIELDS), np.int32)
    rows[:, TM.F_KIND] = TM.MSG_OP
    rows[:, TM.F_A] = TT.OP_FIND
    rows[:, TM.F_SID] = 1
    rows[:, TM.F_KEY] = np.arange(300) + 100
    rows[::7, TM.F_SID] = 2                               # delegated
    rows[::11, TM.F_A] = TT.OP_INSERT
    je, jr = JR.replica_serve(ref_state, jnp.asarray(rows), 1, cfg_j)
    te, tr = TR.replica_serve(port_state, torch.from_numpy(rows), 1, cfg_t)
    assert np.array_equal(np.asarray(je), te.numpy())
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert te.any() and (~te).any()
