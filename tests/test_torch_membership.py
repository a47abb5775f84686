"""Elastic membership in the port, held to the reference (the local parts
of ``tests/test_membership.py``).

M1  The ``Membership`` state machine: transitions, epochs, the log, the
    peer mask and its capacity limit, event for event with the reference.
M2  ``Transport.reset_shard`` refuses while frames touching the shard are
    in flight and drops exactly its lanes once idle, in both packages.
M3  ``SCALE_3_5_2`` (3 → 5 → 2 servers under client traffic): oracle-clean,
    the trace equal to the reference's with its ``mb`` lines, and the
    chip smoke's ``MEMBERSHIP_DIGEST``.
M4  A membership schedule under nemesis faults replays its trace, equal
    to the reference's.
M5  A partition isolating the epoch coordinator across a join and a
    retire heals, equal to the reference.
M6  The client's pacing budget follows membership both ways; a pinned
    budget survives epoch bumps.
M7  ``AutoscalePolicy`` makes the reference's joins and retires.
M9  The soak's partitioned variant on one seed.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import membership_harness as MH
import repro.api as RA
import repro.core.membership as RMB
import repro.core.messages as RM
import repro.core.net as RN
import repro_torch.core.membership as TMB
import repro_torch.core.messages as TM
import repro_torch.core.net as TN
from nemesis_harness import small_cfg
from repro_torch.core.net import trace_digest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


# ----------------------------------------------------- M1: state machine

def _lifecycle(MB):
    mb = MB.Membership(4, 2)
    out = [(mb.active, mb.retired, mb.epoch, mb.mask())]
    s = mb.begin_join()
    out.append((s, mb.joining, mb.epoch, mb.routable, mb.targets, mb.mask()))
    mb.promote(2)
    mb.begin_drain(0)
    out.append((mb.draining, mb.routable, mb.targets))
    mb.finish_drain(0)
    out.append((mb.retired, mb.mask(), list(mb.log), mb.view()))
    return out


def test_membership_lifecycle_and_log():
    got = _lifecycle(TMB)
    assert got == _lifecycle(RMB)
    assert got[1][:3] == (2, (2,), 1)
    assert got[3][2] == [(1, "join", 2), (2, "promote", 2),
                         (3, "drain", 0), (4, "retire", 0)]


def test_membership_invalid_transitions_raise():
    for MB in (RMB, TMB):
        mb = MB.Membership(3, 3)
        with pytest.raises(ValueError, match="cannot join"):
            mb.begin_join(0)
        with pytest.raises(ValueError, match="no retired"):
            mb.begin_join()
        with pytest.raises(ValueError, match="cannot promote"):
            mb.promote(1)
        with pytest.raises(ValueError, match="cannot retire"):
            mb.finish_drain(1)
        mb.begin_drain(0)
        mb.begin_drain(1)
        with pytest.raises(ValueError, match="no other"):
            mb.begin_drain(2)
        with pytest.raises(ValueError, match="out of range"):
            MB.Membership(4, 0)


def test_membership_mask_capacity_limit():
    assert TMB.live_mask(range(64), 64) == RMB.live_mask(range(64), 64) == -1
    assert TMB.MASK_BITS == RMB.MASK_BITS
    with pytest.raises(ValueError, match="capacity"):
        TMB.live_mask(range(10), TMB.MASK_BITS)
    for bad in ((40, 3), (40,)):
        with pytest.raises(ValueError, match="bitmask"):
            TMB.Membership(*bad)
    mb31 = TMB.Membership(TMB.MASK_BITS)
    assert mb31.mask() == -1
    with pytest.raises(ValueError):
        mb31.begin_join()


# -------------------------------------------------- M2: transport reset

def _route_rounds(net, n, M, per_src_rows, rounds, start=0):
    empty = np.zeros((0, M.FIELDS), np.int32)
    backlogs = [empty for _ in range(n)]
    for r in range(start, start + rounds):
        backlogs = [empty for _ in range(n)]
        net.route_round(backlogs, per_src_rows, r)
        per_src_rows = []
    return backlogs


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_transport_reset_shard_requires_idle(pkg):
    N, M, MB = (RN, RM, RMB) if pkg == "ref" else (TN, TM, TMB)
    net = N.Transport(4, retransmit_after=2)
    row = MB.epoch_row(dst=1, src=0, epoch=1, mask=0b0011)[None]
    backlogs = _route_rounds(net, 4, M, [(0, row.astype(np.int32))], 1)
    assert backlogs[1].shape[0] == 1
    assert not net.shard_idle(0) and not net.shard_idle(1)
    assert net.shard_idle(2)
    with pytest.raises(RuntimeError, match="in flight"):
        net.reset_shard(1)
    _route_rounds(net, 4, M, [], 4, start=1)
    assert net.idle() and net.shard_idle(1)
    net.reset_shard(1)
    assert not any(1 in k for k in net._lanes)
    net.reset_shard(2)


# ------------------------------------------- M3: the 3 -> 5 -> 2 acid run

class _TracedLocalBackend(RA.LocalBackend):
    """The reference's backend with the round trace on (the harness runs
    SCALE_3_5_2 without a nemesis, where the trace is off by default)."""

    def __init__(self, *a, **kw):
        kw.setdefault("trace", True)
        super().__init__(*a, **kw)


def _same_run(ref, got):
    MH.check(got, "port")
    assert got["fired"] == ref["fired"]
    assert got["mb_log"] == ref["mb_log"]
    assert got["view"] == ref["view"]
    assert got["final_keys"] == ref["final_keys"]
    for i, (a, b) in enumerate(zip(ref["trace"], got["trace"])):
        assert a == b, f"trace line {i}:\n ref  {a}\n port {b}"
    assert len(got["trace"]) == len(ref["trace"])


def test_scale_up_down_trace_and_digest(monkeypatch):
    monkeypatch.setattr(RA, "LocalBackend", _TracedLocalBackend)
    ref = MH.run_membership_differential("local", 11, None, n_ops=200)
    MH.check(ref, "reference seed=11")
    got = SMOKE.membership_differential(11, None, n_ops=200, device="cpu")
    _same_run(ref, got)
    assert [op for _, op, _ in got["fired"]] == \
        ["join", "join", "retire", "retire", "retire"]
    assert got["view"]["active"] == SMOKE.MEMBERSHIP_ACTIVE
    assert sum(" mb " in ln for ln in got["trace"]) == len(got["mb_log"])
    assert trace_digest(got["trace"]) == SMOKE.MEMBERSHIP_DIGEST
    assert SMOKE.SCALE_3_5_2 == MH.SCALE_3_5_2


# --------------------------------------------------------- M4: replay

def test_membership_schedule_replays_byte_identically():
    p15 = dict(drop_prob=0.15, dup_prob=0.15, reorder_prob=0.15,
               delay_prob=0.075, delay_rounds=3)
    ref = MH.run_membership_differential(
        "local", 13, RN.NemesisConfig(**p15), n_ops=150)
    a = SMOKE.membership_differential(13, TN.NemesisConfig(**p15),
                                      n_ops=150, device="cpu")
    _same_run(ref, a)
    b = SMOKE.membership_differential(13, TN.NemesisConfig(**p15),
                                      n_ops=150, device="cpu")
    assert a["trace"] == b["trace"] and a["mb_log"] == b["mb_log"]


# ---------------------------------------- M5: partition during a change

def test_partition_during_join_and_retire_heals():
    cfg = dict(drop_prob=0.05, partitions=[[8, 40, [0]]])
    kw = dict(schedule=((10, "join", None), (12, "retire", None)),
              n_ops=200, capacity=4, initial_shards=3)
    ref = MH.run_membership_differential(
        "local", 17, RN.NemesisConfig.from_dict(cfg), **kw)
    got = SMOKE.membership_differential(
        17, TN.NemesisConfig.from_dict(cfg), device="cpu", **kw)
    _same_run(ref, got)
    assert got["backend"].net.nemesis.stats["partitioned"] > 0
    assert got["mb_log"][-1][1] == "retire"


# ----------------------------------------------------- M6: client pacing

def _pacing_cfg():
    return SMOKE.nemesis_cfg(5, mailbox_cap=128)


def test_pacing_budget_tracks_membership_both_ways():
    from repro_torch.api.client import local_client
    from repro_torch.core.balancer import Balancer

    cfg = _pacing_cfg()
    cl = local_client(cfg, seed=0, initial_shards=3, device="cpu")
    cl.balance = Balancer(cl.backend, split_threshold=16, merge_threshold=4,
                          rng=cl.backend.balancer_rng)
    bg_budget = cfg.bg_slots * (2 * cfg.move_batch + 2)

    def want(n_live):
        return max(1, cfg.mailbox_cap - bg_budget - n_live - 4)

    assert cl.max_inflight == want(3)
    cl.insert_batch(list(range(10, 400, 4)))
    cl.settle()
    cl.backend.join_shard()
    cl.pump()
    assert cl.max_inflight == want(4)
    cl.settle()
    cl.backend.retire_shard(3)
    cl.settle()
    cl.pump()
    assert cl.max_inflight == want(3)
    assert sorted(cl.all_keys()) == list(range(10, 400, 4))


def test_pinned_inflight_survives_epoch_bumps():
    from repro_torch.api.client import local_client
    cl = local_client(_pacing_cfg(), seed=0, initial_shards=3,
                      max_inflight=7, device="cpu")
    assert cl.max_inflight == 7
    cl.backend.join_shard()
    cl.pump()
    assert cl.max_inflight == 7


# ------------------------------------------------------- M7: autoscale

def _autoscale(api, balancer_mod, cfg, **kw):
    backend = api.LocalBackend(cfg, seed=2, initial_shards=2, **kw)
    pol = balancer_mod.AutoscalePolicy(
        backend, target_load=20, cooldown=0,
        balancer=balancer_mod.Balancer(backend, split_threshold=16,
                                       merge_threshold=4,
                                       rng=backend.balancer_rng))
    client = api.DiLiClient(backend, balance=pol, balance_every=2)
    mb = backend.membership
    keys = list(range(10, 600, 4))
    client.insert_batch(keys)
    client.settle()
    grown = mb.active
    client.remove_batch(keys[10:])
    client.settle()
    shrunk = mb.active
    client.insert_batch(list(range(1000, 1010)))
    client.settle()
    before = mb.epoch
    held = (pol.step()["join"], pol.step()["retire"], mb.epoch - before)
    return (grown, shrunk, held, list(mb.log), backend.all_keys(),
            backend.cluster.round_no)


def test_autoscale_policy_joins_retires_and_holds():
    import repro.core.balancer as RBAL
    import repro_torch.api as TA
    import repro_torch.core.balancer as TBAL
    got = _autoscale(TA, TBAL, SMOKE.nemesis_cfg(4), device="cpu")
    grown, shrunk, held, _, keys, _ = got
    assert grown == (0, 1, 2, 3) and len(shrunk) == 1
    assert held == (0, 0, 0)
    assert keys == sorted(list(range(10, 50, 4)) + list(range(1000, 1010)))
    assert got == _autoscale(RA, RBAL, small_cfg(4))


# ----------------------------------------------------------- M9: soak

def test_membership_partitioned_soak_seed():
    cfg = dict(drop_prob=0.1, dup_prob=0.1, reorder_prob=0.1,
               delay_prob=0.05, delay_rounds=3, partitions=[[15, 45, [1]]])
    ref = MH.run_membership_differential(
        "local", 3000, RN.NemesisConfig.from_dict(cfg), n_ops=150)
    got = SMOKE.membership_differential(
        3000, TN.NemesisConfig.from_dict(cfg), n_ops=150, device="cpu")
    _same_run(ref, got)
