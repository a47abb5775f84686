"""The closed loop that drives the servers' batch surface, and one run.

The window drives ``Backend.submit(shard, kinds, keys)`` then
``Backend.step()``, as the paper's Fig. 3a / 3b drivers do: each server
has ``clients / servers`` clients holding one op each; before every round
the loop tops each server up to its clients with the next ops of the
seeded stream, and an answer frees its client. With several servers the
ops go round-robin, so any server takes any op and delegates it. The
balancer runs every ``balance_every``-th round, in set-up and in the
window. Every op the run submits, from the load on, is kept with its
rounds and its answer for the reference.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import traffic

DRAIN_ROUNDS = 4000
DRAIN_SECONDS = 60.0
SETTLE_PASSES = 200


class Spans:
    """The span callable handed to the program as its ``timer``: silent,
    a ``PhaseTimer`` (which waits for the cards around each span), or
    profiler annotations, as the traced window's stretch asks."""

    def __init__(self):
        self.target = None

    def __call__(self, name: str):
        if self.target is None:
            return contextlib.nullcontext()
        if self.target == "profile":
            import torch
            return torch.profiler.record_function(name)
        return self.target(name)

    def harness(self, name: str):
        """The loop's own spans, shown to the profiler only."""
        return self(name) if self.target == "profile" \
            else contextlib.nullcontext()


class Loop:
    """Feeds and steps a backend, and keeps every op's history.

    The history is kept in numpy chunks, a feed's or a round's at a time,
    so that the loop's own work per op stays small beside the round's."""

    SHIFT = 4                           # op index << SHIFT | server
    # host seconds by part: the program's ``submit``, ``step`` and
    # balancer pass, and the loop's own work around them
    HOST_PARTS = ("submit", "step", "balance", "feed", "record")

    def __init__(self, backend, balancer, balance_every: int,
                 spans: Optional[Spans] = None):
        if backend.n > 1 << self.SHIFT:
            raise ValueError(f"{backend.n} servers: at most "
                             f"{1 << self.SHIFT}")
        self.be = backend
        self.bal = balancer
        self.every = balance_every
        self.spans = spans or Spans()
        self.round = 0
        self.inflight: Dict[int, int] = {}    # op id -> index, server
        self.busy = np.zeros(backend.n, np.int64)
        self.n_ops = 0
        self.fed: List[tuple] = []       # (kinds, keys, round, time)
        self.answers: List[tuple] = []   # (indices, round, time, results)
        self.host_s = dict.fromkeys(self.HOST_PARTS, 0.0)

    def feed(self, s: int, kinds, keys) -> None:
        n = len(kinds)
        if n == 0:
            return
        t = time.perf_counter()
        kinds_l, keys_l = kinds.tolist(), keys.tolist()
        t1 = time.perf_counter()
        ids = self.be.submit(s, kinds_l, keys_l)
        t2 = time.perf_counter()
        base = self.n_ops << self.SHIFT | s
        self.inflight.update(zip(ids, range(base, base + (n << self.SHIFT),
                                            1 << self.SHIFT)))
        self.fed.append((kinds, keys, self.round, t))
        self.n_ops += n
        self.busy[s] += n
        self.host_s["submit"] += t2 - t1
        self.host_s["feed"] += time.perf_counter() - t2 + t1 - t

    def step(self) -> int:
        t0 = time.perf_counter()
        comps = self.be.step()
        t = time.perf_counter()
        self.host_s["step"] += t - t0
        if comps:
            with self.spans.harness("bench.record"):
                ids, vals, _ = zip(*comps)
                packed = np.fromiter(map(self.inflight.pop, ids), np.int64,
                                     len(ids))
                self.answers.append((packed >> self.SHIFT, self.round, t,
                                     np.asarray(vals, np.int64)))
                self.busy -= np.bincount(packed & ((1 << self.SHIFT) - 1),
                                         minlength=self.be.n)
        self.round += 1
        t1 = time.perf_counter()
        self.host_s["record"] += t1 - t
        if self.bal is not None and self.round % self.every == 0:
            with self.spans.harness("bench.balance"):
                self.bal.step()
            self.host_s["balance"] += time.perf_counter() - t1
        return len(comps)

    def top_up(self, take: Callable, clients: int) -> None:
        """Gives every server ops from ``take(n)`` until ``clients`` of
        its ops are in flight."""
        with self.spans.harness("bench.feed"):
            for s in range(self.be.n):
                free = clients - int(self.busy[s])
                if free > 0:
                    t = time.perf_counter()
                    ops = take(free)
                    self.host_s["feed"] += time.perf_counter() - t
                    self.feed(s, *ops)

    def load(self, kinds, keys, per_server: int) -> None:
        pos = [0]

        def take(n):
            i = pos[0]
            pos[0] = min(i + n, len(kinds))
            return kinds[i:pos[0]], keys[i:pos[0]]

        while pos[0] < len(kinds):
            self.top_up(take, per_server)
            self.step()
        self.drain()

    def drain(self, seconds: float = float("inf")) -> bool:
        """Steps until every op is answered and the servers are quiet."""
        t0 = time.perf_counter()
        for _ in range(DRAIN_ROUNDS):
            if not self.inflight and self.be.quiescent():
                return True
            if time.perf_counter() - t0 > seconds:
                return False
            self.step()
        return False

    def settle(self) -> None:
        """Balancer passes until one issues nothing, draining after each
        (``benchmarks/run.py::_settle``)."""
        if self.bal is None:
            return
        for _ in range(SETTLE_PASSES):
            if not any(self.bal.step().values()):
                return
            self.drain()

    def history(self) -> Dict[str, np.ndarray]:
        """Every op fed: kind, key, round and time of its feed, round and
        time of its answer (-1 and 0 where none came) and the answer."""
        n = self.n_ops
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        sizes = [len(k) for k, _, _, _ in self.fed]
        h = dict(kind=cat([k for k, _, _, _ in self.fed], np.int64),
                 key=cat([k for _, k, _, _ in self.fed], np.int64),
                 submitted=np.repeat([r for _, _, r, _ in self.fed],
                                     sizes).astype(np.int64),
                 sub_time=np.repeat([t for _, _, _, t in self.fed],
                                    sizes).astype(np.float64),
                 answered=np.full(n, -1, np.int64),
                 done_time=np.zeros(n), res=np.zeros(n, np.int64))
        for idx, r, t, res in self.answers:
            h["answered"][idx] = r
            h["done_time"][idx] = t
            h["res"][idx] = res
        return h


def program_backend(conf: dict, devices, spans):
    """The port's servers and balancer, as the configuration states."""
    from repro_torch.api import LocalBackend, ShardMapBackend
    from repro_torch.core import types as T
    from repro_torch.core.balancer import Balancer
    from . import ycsb
    if (T.OP_FIND, T.OP_INSERT, T.OP_REMOVE) != (
            ycsb.OP_FIND, ycsb.OP_INSERT, ycsb.OP_REMOVE):
        raise RuntimeError("the program's op kinds moved; update ycsb.py")
    cfg = T.DiLiConfig(**conf["dili"])
    if cfg.num_shards != conf["servers"] or len(devices) != conf["servers"]:
        raise ValueError("servers, dili.num_shards and devices disagree")
    if conf["backend"] == "local":
        be = LocalBackend(cfg, device=devices[0], timer=spans)
    elif conf["backend"] == "shardmap":
        be = ShardMapBackend(cfg, devices=list(devices), timer=spans)
    else:
        raise ValueError(f"unknown backend {conf['backend']!r}")
    return be, Balancer(be)


def server_keys(backend) -> List[List[int]]:
    """The keys of the sublists each server owns, from its own state."""
    out = []
    for s in range(backend.n):
        keys: List[int] = []
        for e in backend.sublists(s):
            if e["owner"] == s and not e["switched"]:
                keys.extend(backend.shard_chain(s, e["head_idx"]))
        out.append(keys)
    return out


def _sync(devices) -> None:
    import torch
    for d in dict.fromkeys(str(d) for d in devices):
        if d.startswith("cuda"):
            torch.cuda.synchronize(d)


def run(conf: dict, mix: dict, seed: int, seconds: float, trace: bool,
        devices, t_start: float, make=program_backend, wrap=None,
        profile_window=None, window_rounds=None) -> dict:
    """One run of a cell: set-up, the window, the drain, the history.

    ``make(conf, devices, spans)`` gives ``(backend, balancer)``; ``wrap``
    may replace the backend (the tests break it there). With ``trace`` the
    window's first half runs under a ``PhaseTimer`` and its second under
    ``profile_window(round_fn, seconds)``, which returns the profiler's
    record. ``window_rounds``, where given, makes the window that many
    rounds instead of ``seconds`` (the tests' and the control's runs)."""
    spans = Spans() if trace else None
    backend, balancer = make(conf, devices, spans)
    if wrap is not None:
        backend = wrap(backend)
    n = conf["servers"]
    clients = mix["clients"] // n
    if not 1 <= clients <= conf["dili"]["batch_size"]:
        raise ValueError(f"{mix['clients']} clients over {n} servers does "
                         f"not fit batch_size {conf['dili']['batch_size']}")
    loop = Loop(backend, balancer, mix["balance_every"], spans)

    t0 = time.perf_counter()
    loop.load(*traffic.load_stream(seed, conf["keys"], conf["key_space"]),
              per_server=conf["load_feed"])
    load_rounds = loop.round
    load_s = time.perf_counter() - t0
    loop.settle()
    settle_rounds = loop.round - load_rounds
    stream = traffic.OpStream(seed, conf["key_space"], mix)

    def mix_round():
        loop.top_up(stream.take, clients)
        loop.step()

    for _ in range(mix["warm_rounds"]):
        mix_round()
    _sync(devices)
    t_win = time.perf_counter()
    rec = dict(setup_s=t_win - t_start, load_rounds=load_rounds,
               settle_rounds=settle_rounds, load_s=load_s,
               load_settle_s=t_win - t0)

    r_win = loop.round
    stats0 = dict(backend.stats)
    host0 = dict(loop.host_s)
    if window_rounds is not None:
        for _ in range(window_rounds):
            mix_round()
    elif not trace:
        while time.perf_counter() - t_win < seconds:
            mix_round()
    else:
        from repro_torch.timing import PhaseTimer
        timer = PhaseTimer(devices)
        spans.target = timer
        r_t = loop.round
        while time.perf_counter() - t_win < seconds / 2:
            mix_round()
        spans.target = None
        rec["spans"] = dict(timer.seconds)
        rec["timer_rounds"] = loop.round - r_t
        left = seconds - (time.perf_counter() - t_win)
        spans.target = "profile"
        rec["profile"] = profile_window(mix_round, left)
        spans.target = None
    _sync(devices)
    t_end = time.perf_counter()
    r_end = loop.round
    rec["window_s"] = t_end - t_win
    rec["host_s"] = {k: v - host0[k] for k, v in loop.host_s.items()}
    rec["window_rounds"] = r_end - r_win
    rec["stats"] = {k: backend.stats[k] - stats0.get(k, 0)
                    for k in ("blk_hits", "fast_hits", "mut_hits",
                              "delegated", "move_hits")
                    if k in backend.stats}

    rec["drained"] = loop.drain(DRAIN_SECONDS)
    if rec["drained"]:
        loop.settle()
    rec["final_sets"] = server_keys(backend)
    rec["rounds"] = loop.round
    rec["after_window_s"] = time.perf_counter() - t_end
    h = loop.history()
    rec["history"] = h
    win = (h["answered"] >= r_win) & (h["answered"] < r_end)
    rec["window_ops"] = int(win.sum())
    rec["latency_s"] = (h["done_time"] - h["sub_time"])[win]
    # due in the window: submitted before it closed, not answered before
    # it opened
    due = (h["submitted"] < r_end) & ~((h["answered"] >= 0)
                                       & (h["answered"] < r_win))
    rec["due"] = due
    return rec
