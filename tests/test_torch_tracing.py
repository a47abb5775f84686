"""The port's tracer (``repro_torch.timing``): counters that land on the
innermost open ``PhaseTimer`` span, the no-op tracer, the ``balance`` and
``shard_round`` spans, and the benchmark's readers of the counters
(``dili_bench/metrics/``), port only, on the CPU.

The walk counts are held against an independent count: before each
round, the longest chain walk among the dirty owned rows, read from
``sim.host_view``. No tensor crosses to the host on the CPU, so the
crossing counter is checked on a ``meta`` tensor, which ``crossed``
takes for a card's.
"""
import dis
import pathlib
import sys
import tracemalloc

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per process)
from repro_torch import timing
from repro_torch.api import LocalBackend, ShardMapBackend
from repro_torch.core import refs
from repro_torch.core.balancer import Balancer
from repro_torch.core.host import to_numpy
from repro_torch.core.sim import Cluster, host_view
from repro_torch.core.traverse import probe_batch
from repro_torch.core.types import (DiLiConfig, OP_FIND, OP_INSERT,
                                    OP_REMOVE, SH_KEY, ST_KEY)
from repro_torch.timing import PhaseTimer

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from dili_bench import spec  # noqa: E402

# one server, small blocks and a split threshold above them: some rows
# hold more keys than a block, and removes leave tombstones in the chains
CFG = DiLiConfig(num_shards=1, pool_capacity=4096, max_sublists=64,
                 max_ctrs=64, max_scan=4096, batch_size=64, mailbox_cap=256,
                 move_batch=8, block_probe=True, block_cap=16,
                 split_threshold=20)
COUNTERS = {"refresh_steps": "refresh_steps",
            "prepass_steps": "prepass_steps",
            "host_reads": "host_reads", "to_host_mb": "to_host_bytes"}


# ----------------------------------------------------------- the counters

def test_a_count_lands_on_the_innermost_open_span():
    t, inner = PhaseTimer("cpu"), PhaseTimer("cpu")
    with t("outer"):
        timing.count("x")
        with t("mid"):
            timing.count("x", 2)
            with inner("in"):
                timing.count("x", 5)
            timing.count("y")
        timing.count("x", 3)
    timing.count("x", 100)                  # no span open: dropped
    assert dict(t.counts) == {("outer", "x"): 4, ("mid", "x"): 2,
                              ("mid", "y"): 1}
    assert dict(inner.counts) == {("in", "x"): 5}
    assert t.total("x") == 6 and t.total("z") is None
    assert timing._OPEN == []


def test_a_span_left_by_an_exception_is_closed():
    t = PhaseTimer("cpu")
    with pytest.raises(RuntimeError):
        with t("a"):
            raise RuntimeError
    timing.count("x")
    assert not t.counts and timing._OPEN == []


def test_nothing_is_recorded_without_a_phase_timer_span():
    t = PhaseTimer("cpu")
    timing.count("x")
    with torch.profiler.record_function("profiled"):
        timing.count("x")
        timing.crossed(torch.empty(4, device="meta"))
    with timing.tracer(None)("untimed"):
        timing.count("x")
    assert not t.counts and not t.seconds


def test_reset_clears_the_counts():
    t = PhaseTimer("cpu")
    with t("a"):
        timing.count("x", 7)
    t.reset()
    assert not t.counts and not t.seconds and not t.calls
    with t("b"):
        timing.count("x")
    assert dict(t.counts) == {("b", "x"): 1}


def test_latest_is_the_newest_timer():
    a = PhaseTimer("cpu")
    assert timing.latest() is a
    b = PhaseTimer("cpu")
    assert timing.latest() is b


def test_the_no_op_tracer_does_nothing():
    span = timing.tracer(None)
    with span("a"), span("b"):
        pass
    t = PhaseTimer("cpu")
    assert timing.tracer(t) is t


def test_a_crossing_of_a_remote_tensor_adds_a_read_and_its_bytes():
    t = PhaseTimer("cpu")
    remote = torch.empty(10, dtype=torch.int32, device="meta")
    with t("s"):
        timing.crossed(remote)
        timing.crossed(remote, 3, nbytes=3)
        timing.crossed(torch.zeros(10, dtype=torch.int32))   # on the host
        to_numpy(torch.zeros(4))
        to_numpy([1, 2])
    assert dict(t.counts) == {("s", "host_reads"): 4,
                              ("s", "to_host_bytes"): 43}


def test_count_returns_at_once_with_no_span_open():
    # the code before the first return reads one global and nothing else
    ins = list(dis.get_instructions(timing.count))
    ret = next(i for i, x in enumerate(ins) if x.opname.startswith("RETURN"))
    looked_up = {x.argval for x in ins[:ret] if x.opname.startswith("LOAD_")
                 and x.opname not in ("LOAD_CONST", "LOAD_FAST")}
    assert looked_up == {"_OPEN"}
    # arguments it would have to hash or read are never touched
    timing.count(["unhashable"], None)
    timing.crossed(object())
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            timing.count("x")
            timing.crossed(None)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = tracemalloc.Filter(True, timing.__file__)
    grew = after.filter_traces([here]).compare_to(
        before.filter_traces([here]), "filename")
    assert sum(s.size_diff for s in grew) <= 0


class _Watched(list):
    """``timing._OPEN`` stand-in that counts how often ``count`` asks it
    whether a span is open."""

    def __init__(self):
        super().__init__()
        self.asked = 0

    def __bool__(self):
        self.asked += 1
        return len(self) > 0


def test_an_untimed_round_records_nothing(monkeypatch):
    t = PhaseTimer("cpu")
    watched = _Watched()
    monkeypatch.setattr(timing, "_OPEN", watched)
    cl = Cluster(CFG, device="cpu")
    cl.submit(0, [OP_INSERT] * 16, list(range(1, 17)))
    cl.step()
    cl.submit(0, [OP_FIND] * 8, list(range(1, 9)))
    cl.step()
    Balancer(cl).step()
    assert watched.asked > 0 and watched == []
    assert not t.counts and not t.seconds


def test_profiler_spans_record_nothing():
    t = PhaseTimer("cpu")
    cl = Cluster(CFG, device="cpu",
                 timer=lambda name: torch.profiler.record_function(name))
    cl.submit(0, [OP_INSERT] * 16, list(range(1, 17)))
    cl.step()
    Balancer(cl).step()
    assert not t.counts and not t.seconds


# ------------------------------------------------- the round's walk counts

def _longest_dirty_walk(state, cfg: DiLiConfig, me: int = 0) -> int:
    """Steps ``refresh_blocks`` takes this round: the longest walk among
    the dirty owned rows, each from its SubHead's successor to its
    registered SubTail or to the live key past the block's capacity,
    tombstones and in-chain SubHeads included (one local server, no
    Moves)."""
    v = host_view(state)
    reg = state.registry
    valid = state.blk.valid.numpy()
    subtail = reg.subtail.numpy()
    rctr = reg.ctr.numpy()
    newloc = state.pool.newloc.numpy()
    longest = 0
    for e in range(v["size"]):
        sh = int(v["subhead"][e])
        head = refs.ref_idx(sh)
        if refs.is_null(sh) or refs.ref_sid(sh) != me or valid[e] \
                or v["stct"][rctr[e]] < 0 or not refs.is_null(newloc[head]):
            continue
        ref, steps, live = int(v["nxt"][head]), 0, 0
        while steps < cfg.max_scan:
            steps += 1
            i = refs.ref_idx(ref)
            k = int(v["key"][i])
            marked = refs.ref_mark(int(v["nxt"][i]))
            if k == ST_KEY:
                assert refs.unmarked(ref) == refs.unmarked(int(subtail[e]))
                break
            if k != SH_KEY and not marked:
                if live == cfg.block_cap:
                    break
                live += 1
            ref = int(v["nxt"][i])
        longest = max(longest, steps)
    return longest


@pytest.fixture(scope="module")
def counted_rounds():
    """A loaded, split server, then rounds of mixed ops under a timer:
    per round, the counted and the independent steps of both walks."""
    rng = np.random.default_rng(3)
    be = LocalBackend(CFG, device="cpu")
    bal = Balancer(be)
    for r in range(24):
        be.submit(0, [OP_INSERT] * 32, rng.integers(1, 3000, 32).tolist())
        be.step()
        if r % 4 == 3:
            bal.step()
    for _ in range(200):
        if be.quiescent():
            break
        be.step()
    t = PhaseTimer("cpu")
    be.cluster.timer = t
    rows = []
    for _ in range(6):
        want = _longest_dirty_walk(be.states[0], CFG)
        r0 = t.total("refresh_steps") or 0
        p0, w0 = t.total("prepass_steps") or 0, probe_batch.steps
        kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 48).tolist()
        be.submit(0, kinds, rng.integers(1, 3000, 48).tolist())
        be.step()
        rows.append(dict(refresh=(t.total("refresh_steps") - r0, want),
                         prepass=(t.total("prepass_steps") - p0,
                                  probe_batch.steps - w0)))
    return t, rows


def test_refresh_steps_equal_the_longest_dirty_walk(counted_rounds):
    t, rows = counted_rounds
    assert [r["refresh"][0] for r in rows] == [r["refresh"][1] for r in rows]
    assert sum(r["refresh"][0] for r in rows) > 0
    assert set(t.counts) >= {("refresh_blocks", "refresh_steps"),
                             ("probe_batch", "prepass_steps")}


def test_prepass_steps_equal_the_walks_own_count(counted_rounds):
    _, rows = counted_rounds
    assert [r["prepass"][0] for r in rows] == [r["prepass"][1] for r in rows]
    assert sum(r["prepass"][0] for r in rows) > 0


@pytest.mark.parametrize("kind", ["local", "shardmap"])
def test_balance_and_shard_round_are_spans(kind):
    cfg = CFG._replace(num_shards=2)
    t = PhaseTimer("cpu")
    be = (LocalBackend(cfg, device="cpu", timer=t) if kind == "local"
          else ShardMapBackend(cfg, device="cpu", timer=t))
    be.submit(0, [OP_INSERT] * 8, list(range(1, 9)))
    be.step()
    Balancer(be).step()
    assert {"balance", "shard_round", "host_routing"} <= set(t.seconds)
    assert t.calls["shard_round"] == 2 and t.calls["balance"] == 1


# ------------------------------------------------------ the benchmark's readers

def _record(timer, rounds=4):
    return {"spans": dict(timer.seconds), "timer_rounds": rounds}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_a_counter_reader_reads_its_counter_per_round(name, monkeypatch):
    read = spec.reader(name)
    t = PhaseTimer("cpu")
    t.seconds["serial_loop"] = 0.5
    assert read(_record(t)) is None             # nothing counted
    counter = COUNTERS[name]
    t.counts["serial_loop", counter] = 300
    t.counts["balance", counter] = 100
    t.counts["serial_loop", "other"] = 7
    scale = 1e6 if name == "to_host_mb" else 1
    assert read(_record(t)) == pytest.approx(400 / 4 / scale)
    assert read({"spans": {"x": 1.0}, "timer_rounds": 4}) is None
    assert read(_record(t, rounds=0)) is None
    monkeypatch.setattr(timing, "_LATEST", None)
    assert read(_record(t)) is None             # no timer


def test_balance_ms_reads_the_balance_span():
    read = spec.reader("balance_ms")
    assert read({"spans": {"serial_loop": 1.0}, "timer_rounds": 4}) is None
    assert read({"spans": {"balance": 0.02}, "timer_rounds": 4}) == \
        pytest.approx(5.0)
