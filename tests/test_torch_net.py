"""The port's reliable transport and nemesis against the reference's.

Each test of ``tests/test_net.py`` runs its scenario through both packages'
``Transport``/``Nemesis`` with the same seeds: the frames delivered (row
for row, ``F_SEQ`` stamps included), the transport's and the nemesis'
counters and the idle state must be equal, and the port must meet the
reference test's own assertions. Integer code: equality, no tolerance.
"""
import numpy as np
import pytest

import repro.core.messages as RM
import repro.core.net as RN
import repro_torch.core.messages as TM
import repro_torch.core.net as TN

PKGS = {"ref": (RN, RM), "port": (TN, TM)}


def mkrow(M, src, dst, payload, kind=None):
    row = np.zeros((M.FIELDS,), np.int32)
    row[M.F_KIND] = M.MSG_OP if kind is None else kind
    row[M.F_SRC] = src
    row[M.F_DST] = dst
    row[M.F_KEY] = payload
    return row


def rows(M, specs):
    return np.stack([mkrow(M, *s) for s in specs])


def pump(tp, start, rounds):
    """Drive empty rounds; collect deliveries per destination."""
    got = [[] for _ in range(tp.n)]
    for r in range(start, start + rounds):
        for d, rs in enumerate(tp.ship_round(r)):
            got[d].extend(rs)
    return got


def payloads(M, rs):
    return [int(r[M.F_KEY]) for r in rs]


def frames(got):
    return [[r.tolist() for r in rs] for rs in got]


def both(scenario):
    """Run ``scenario(net, M)`` on each package; it returns (observable,
    transport). The observables and the counters must agree; returns the
    port's observable and transport."""
    out = {k: scenario(N, M) for k, (N, M) in PKGS.items()}
    (ref, rtp), (port, ptp) = out["ref"], out["port"]
    assert port == ref
    assert ptp.stats == rtp.stats
    if rtp.nemesis is not None:
        assert ptp.nemesis.stats == rtp.nemesis.stats
    assert ptp.in_flight() == rtp.in_flight()
    return port, ptp


def nemesis(N, config, seed=0):
    return N.Nemesis(config, np.random.default_rng(seed))


# ------------------------------------------------------------- clean wire

def test_clean_wire_delivers_in_order_and_goes_idle():
    def scenario(N, M):
        tp = N.Transport(2)
        tp.send(0, rows(M, [(0, 1, p) for p in (10, 11, 12)]))
        return frames(pump(tp, 0, 6)), tp

    got, tp = both(scenario)
    assert [r[TM.F_KEY] for r in got[1]] == [10, 11, 12]
    assert got[0] == []
    assert tp.idle(), tp.in_flight()
    assert tp.stats["delivered"] == 3 and tp.stats["retransmits"] == 0


def test_loopback_bypasses_the_wire():
    def scenario(N, M):
        tp = N.Transport(2)
        loop = tp.send(0, rows(M, [(0, 0, 5), (0, 1, 6)]))
        return ([r.tolist() for r in loop], frames(pump(tp, 0, 4))), tp

    (loop, got), tp = both(scenario)
    assert [r[TM.F_KEY] for r in loop] == [5]
    assert tp.stats["sent"] == 1
    assert [r[TM.F_KEY] for r in got[1]] == [6]


def test_seq_stamped_per_lane():
    def scenario(N, M):
        tp = N.Transport(3)
        tp.send(0, rows(M, [(0, 1, 1), (0, 2, 2), (0, 1, 3)]))
        tp.send(2, rows(M, [(2, 1, 4)]))
        return frames(pump(tp, 0, 4)), tp

    got, _ = both(scenario)
    seqs = {(r[TM.F_SRC], r[TM.F_KEY]): r[TM.F_SEQ] for r in got[1] + got[2]}
    assert seqs == {(0, 1): 1, (0, 3): 2, (0, 2): 1, (2, 4): 1}


# ------------------------------------------------------------ lossy wire

def test_drops_heal_by_retransmission():
    def scenario(N, M):
        tp = N.Transport(2, nemesis(N, N.NemesisConfig(drop_prob=0.5), 3),
                         retransmit_after=2)
        tp.send(0, rows(M, [(0, 1, p) for p in range(40)]))
        return frames(pump(tp, 0, 120)), tp

    got, tp = both(scenario)
    assert [r[TM.F_KEY] for r in got[1]] == list(range(40))
    assert tp.idle()
    assert tp.stats["retransmits"] > 0 and tp.nemesis.stats["dropped"] > 0


def test_duplicates_are_suppressed_exactly_once_delivery():
    def scenario(N, M):
        tp = N.Transport(2, nemesis(N, N.NemesisConfig(dup_prob=1.0)),
                         retransmit_after=2)
        tp.send(0, rows(M, [(0, 1, p) for p in range(10)]))
        return frames(pump(tp, 0, 20)), tp

    got, tp = both(scenario)
    assert [r[TM.F_KEY] for r in got[1]] == list(range(10))
    assert tp.stats["dup_dropped"] >= 10
    assert tp.idle()


def test_reordering_is_straightened_per_lane():
    def scenario(N, M):
        tp = N.Transport(3, nemesis(N, N.NemesisConfig(reorder_prob=0.8), 1),
                         retransmit_after=3)
        early = []
        for r in range(6):
            tp.send(0, rows(M, [(0, 1, 100 + 6 * r + i) for i in range(6)]))
            tp.send(2, rows(M, [(2, 1, 900 + r)]))
            early.append(frames(tp.ship_round(r)))
        return (early, frames(pump(tp, 6, 60))), tp

    (_, got), tp = both(scenario)
    lane0 = [r[TM.F_KEY] for r in got[1] if r[TM.F_KEY] < 900]
    lane2 = [r[TM.F_KEY] for r in got[1] if r[TM.F_KEY] >= 900]
    assert lane0 == sorted(lane0) and lane2 == sorted(lane2)
    assert tp.idle()


def test_delay_holds_frames_then_releases_in_order():
    def scenario(N, M):
        cfg = N.NemesisConfig(delay_prob=1.0, delay_rounds=4)
        tp = N.Transport(2, nemesis(N, cfg, 2), retransmit_after=50)
        tp.send(0, rows(M, [(0, 1, p) for p in (1, 2, 3)]))
        first = frames(tp.ship_round(0))
        idle_after_first = tp.idle()
        return (first, idle_after_first, frames(pump(tp, 1, 12))), tp

    (first, idle_after_first, got), tp = both(scenario)
    assert first[1] == [] and not idle_after_first
    assert [r[TM.F_KEY] for r in got[1]] == [1, 2, 3]
    assert tp.nemesis.stats["delayed"] >= 3


def test_partition_cuts_then_heals():
    def scenario(N, M):
        cfg = N.NemesisConfig(partitions=(N.Partition(0, 10, (0,)),))
        tp = N.Transport(2, nemesis(N, cfg), retransmit_after=2)
        tp.send(0, rows(M, [(0, 1, p) for p in (7, 8)]))
        return (frames(pump(tp, 0, 10)), frames(pump(tp, 10, 10))), tp

    (during, after), tp = both(scenario)
    assert during[1] == []
    assert tp.nemesis.stats["partitioned"] > 0
    assert [r[TM.F_KEY] for r in after[1]] == [7, 8]
    assert tp.idle()


def test_delayed_frames_respect_partitions_at_release():
    def scenario(N, M):
        cfg = N.NemesisConfig(delay_prob=1.0, delay_rounds=1,
                              partitions=(N.Partition(1, 20, (0,)),))
        tp = N.Transport(2, nemesis(N, cfg, 0), retransmit_after=3)
        tp.send(0, rows(M, [(0, 1, 9)]))
        for r in range(40):
            if len(tp.ship_round(r)[1]):
                return r, tp
        return None, tp

    arrived_at, tp = both(scenario)
    assert arrived_at is not None and arrived_at >= 20, arrived_at
    assert tp.nemesis.stats["partitioned"] > 0


def test_link_overrides_scope_faults_to_one_link():
    def scenario(N, M):
        cfg = N.NemesisConfig(link_overrides=(
            ((0, 1), N.LinkFaults(drop_prob=1.0)),))
        tp = N.Transport(3, nemesis(N, cfg), retransmit_after=100)
        tp.send(0, rows(M, [(0, 1, 1), (0, 2, 2)]))
        return frames(pump(tp, 0, 4)), tp

    got, _ = both(scenario)
    assert got[1] == [] and [r[TM.F_KEY] for r in got[2]] == [2]


def test_ack_loss_heals_sender_ring_eventually_drains():
    def scenario(N, M):
        cfg = N.NemesisConfig(link_overrides=(
            ((1, 0), N.LinkFaults(drop_prob=0.8)),))
        tp = N.Transport(2, nemesis(N, cfg, 11), retransmit_after=2)
        tp.send(0, rows(M, [(0, 1, p) for p in range(5)]))
        return frames(pump(tp, 0, 200)), tp

    got, tp = both(scenario)
    assert [r[TM.F_KEY] for r in got[1]] == list(range(5))
    assert tp.idle(), tp.in_flight()
    assert tp.stats["dup_dropped"] > 0


# ---------------------------------------------------------- misc contract

def test_window_overflow_raises_loudly():
    def scenario(N, M):
        tp = N.Transport(2, nemesis(N, N.NemesisConfig(drop_prob=1.0)),
                         window=8)
        raised_at = None
        try:
            for r in range(4):
                tp.send(0, rows(M, [(0, 1, p) for p in range(4)]))
                tp.ship_round(r)
        except N.TransportOverflow:
            raised_at = r
        return raised_at, tp

    raised_at, _ = both(scenario)
    assert raised_at is not None
    tp = TN.Transport(2, nemesis(TN, TN.NemesisConfig(drop_prob=1.0)),
                      window=8)
    with pytest.raises(TN.TransportOverflow):
        for r in range(4):
            tp.send(0, rows(TM, [(0, 1, p) for p in range(4)]))
            tp.ship_round(r)


def test_net_ack_frames_never_reach_inboxes():
    def scenario(N, M):
        tp = N.Transport(2)
        tp.send(0, rows(M, [(0, 1, 1)]))
        kinds = [int(x[M.F_KIND]) for r in range(8)
                 for rs in tp.ship_round(r) for x in rs]
        return kinds, tp

    kinds, tp = both(scenario)
    assert TM.MSG_NET_ACK not in kinds
    assert tp.stats["acks"] > 0


def test_same_seed_same_schedule():
    def run(N, M, seed):
        cfg = N.NemesisConfig(drop_prob=0.3, dup_prob=0.3, reorder_prob=0.3,
                              delay_prob=0.2, delay_rounds=3)
        tp = N.Transport(2, nemesis(N, cfg, seed), retransmit_after=2)
        log = []
        for r in range(40):
            if r < 10:
                tp.send(0, rows(M, [(0, 1, 10 * r + i) for i in range(3)]))
            for d, rs in enumerate(tp.ship_round(r)):
                log.append((r, d, payloads(M, rs)))
        return log, tp

    a, _ = both(lambda N, M: run(N, M, 7))
    b, _ = run(TN, TM, 7)
    c, _ = both(lambda N, M: run(N, M, 8))
    assert a == b
    assert a != c


def test_config_round_trips_through_json_dict():
    def make(N):
        return N.NemesisConfig(
            drop_prob=0.1, dup_prob=0.2, reorder_prob=0.3, delay_prob=0.05,
            delay_rounds=4, partitions=(N.Partition(5, 9, (0, 2)),),
            link_overrides=(((1, 0), N.LinkFaults(drop_prob=0.9)),),
            crashes=(N.nemesis.CrashPlan(1, 10, 20),))

    ref, port = make(RN), make(TN)
    assert port.to_dict() == ref.to_dict()
    assert port.repro(3) == ref.repro(3)
    assert TN.NemesisConfig.from_dict(ref.to_dict()) == port
    assert "seed=3" in port.repro(3)
    with pytest.raises(ValueError, match="must follow"):
        TN.CrashPlan(0, 5, 5)
