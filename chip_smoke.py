#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA card and the CUDA toolkit (``nvcc``). Phases, each of
which makes the script exit non-zero when it fails:

  1. build   — compile every kernel of the main path from the checkout's
               sources (``nvcc`` for ``sm_90a``; into ``build/kernels/``);
  2. kernels — each kernel against its plain PyTorch version on the card,
               bit for bit (tolerance 0: the outputs are integers), at the
               main path's shapes and on the edge cases of the tests; its
               device time (``torch.profiler``) beside its bound;
  3. fig3a   — the paper's single-machine configuration (Fig. 3a) as
               ``benchmarks/run.py`` runs it, YCSB r50 mix: 1 shard,
               Balancer, block probe on. The final key set must equal the
               sequential oracle's, and the protocol counts must equal the
               JAX reference's (recorded from a run of the reference with
               the same seeds and code path). The kernel's launch count
               shows the main path went through it. Then a profiler
               window (the device's busy share) and a second run under
               the per-phase timer (the round's breakdown);
  4. client  — a few hundred ops through ``DiLiClient`` futures, each
               result equal to the oracle's;
  5. scale   — the paper's capacities (2**21 pool nodes, 16384 registry
               entries) with ``SCALE_KEYS`` loaded keys and as many r50
               ops, checked against the oracle; then a window of rounds
               under the per-phase timer and a profiler window.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
The script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# fig3a r50 with the block probe, as the JAX reference gives it with the
# same config, seeds and driver; tests/test_torch_fig3a.py recomputes these
# from the reference and from the port on the CPU
FIG3A_EXPECTED = dict(rounds=107, load_rounds=34, settle_rounds=44,
                      fast_hits=1865, mut_hits=3228, blk_hits=4235,
                      sublists=29, keys=2218)

# Keys loaded (and r50 ops) in the scale phase: half of the 2**16 the
# capacities were sized for. With 2**16 the whole script took 1120 s of
# its 1200 s limit on one H100 host, the round being host-bound
# (PERF.md, "Cells")
SCALE_KEYS = 1 << 15

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the CUDA-core
# rate, the nearest table entry for the kernel's int32 compares
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers

def time_cuda(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the mean per-call time (ms) of ``iters``
    back-to-back calls, between two CUDA events. For a call whose host
    side outlasts its device work this is the host's issue rate."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def _device_events(prof):
    """``key_averages()`` rows that ran on the card (kernels, copies), not
    the host ops that launched them."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int = 100, name: str | None = None) -> float:
    """Device time (ms) per call of ``fn``, from a ``torch.profiler`` trace
    of ``iters`` calls: the summed duration of the kernels it ran, or of
    the kernels whose name holds ``name``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in _device_events(prof)
             if name is None or name in e.key)
    if us <= 0:
        fail(f"the profiler saw no device time for {name or 'the call'}")
    return us / 1e3 / iters


def drive_backend(backend, kinds, keys, batch, *, balancer=None,
                  max_drain=4000):
    """``benchmarks/run.py::_drive_backend``: feed ops round-robin at the
    raw backend surface, balancer every 4th round, then drain."""
    n = len(kinds)
    pending = i = r = 0
    while i < n:
        for s in range(backend.n):
            j = min(i + batch, n)
            if i < j:
                backend.submit(s, kinds[i:j].tolist(), keys[i:j].tolist())
                pending += j - i
                i = j
        pending -= len(backend.step())
        if balancer is not None and r % 4 == 3:
            balancer.step()
        r += 1
    for _ in range(max_drain):
        if pending == 0 and backend.quiescent():
            return
        pending -= len(backend.step())
    fail(f"backend did not drain: pending={pending}")


def settle(backend, balancer, max_passes: int = 200) -> None:
    """``benchmarks/run.py::_settle``."""
    import numpy as np
    for _ in range(max_passes):
        if not any(balancer.step().values()):
            return
        drive_backend(backend, np.zeros(0, np.int64), np.zeros(0, np.int64),
                      64)


def bench_cfg(**kw):
    """``benchmarks/run.py::_bench_cfg(1, block_probe=True)``."""
    from repro_torch.core.types import DiLiConfig
    base = dict(num_shards=1, pool_capacity=1 << 15, max_sublists=256,
                max_ctrs=256, max_scan=1 << 15, batch_size=64,
                mailbox_cap=512, split_threshold=125, move_batch=32,
                find_fastpath=True, mut_fastpath=True, block_probe=True)
    base.update(kw)
    return DiLiConfig(**base)


def breakdown(timer, rounds: int) -> dict:
    """Per-round milliseconds of each timed phase."""
    return {k: round(1e3 * v / max(rounds, 1), 4)
            for k, v in sorted(timer.seconds.items())}


# ------------------------------------------------------------------ phases

def phase_build() -> None:
    from repro_torch.kernels import hybrid_search as HS
    t0 = time.perf_counter()
    path = HS.build(verbose=True)
    log(f"[build] hybrid_search -> {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


def _registry(rng, m_live, m, c, coverage=0.6):
    """Sorted keymin + sorted INT32_MAX-padded blocks, ``m_live`` live
    rows padded to ``m`` as the runtime's registry is."""
    import numpy as np
    imax = np.iinfo(np.int32).max
    bounds = np.sort(rng.choice(np.arange(0, 40 * m_live, 7), m_live,
                                replace=False))
    bounds[0] = -1
    keymin = np.full(m, imax, np.int32)
    keymin[:m_live] = bounds
    blocks = np.full((m, c), imax, np.int32)
    for i in range(m_live):
        lo = int(bounds[i]) + 1
        hi = int(bounds[i + 1]) if i + 1 < m_live else lo + 300
        take = np.sort(rng.permutation(np.arange(lo, max(hi, lo + 1)))
                       [:int(c * coverage)])
        blocks[i, :take.size] = take
    blocks[0, :] = np.arange(-c, 0)        # one full block, all < 0
    return keymin, blocks


def _queries(rng, blocks, b):
    """Half present keys, half misses, and the edges up front: the pad
    sentinel, the largest real key, and 0 — routed to the full block 0,
    whose keys are all below it (pos == C)."""
    import numpy as np
    imax = np.iinfo(np.int32).max
    live = blocks[blocks != imax]
    q = np.concatenate([rng.choice(live, b // 2),
                        rng.integers(-5, int(live.max()) + 5, b - b // 2)])
    q = q.astype(np.int32)
    q[:min(3, b)] = [imax, imax - 1, 0][:min(3, b)]
    return q


def phase_kernels() -> dict:
    """Kernel vs plain on the card; returns the timing record."""
    import numpy as np
    import torch
    from repro_torch.kernels import hybrid_search as HS
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    imax = np.iinfo(np.int32).max

    def run_case(keymin, blocks, q):
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (keymin, blocks, q)]
        slot, found = K.hybrid_search(*a)
        slot_r, found_r = K.hybrid_search_ref(*a)
        torch.cuda.synchronize()
        err = int((slot.long() - slot_r.long()).abs().max()) \
            if slot.numel() else 0
        err = max(err, int((found != found_r).sum()))
        return err, a

    # the edge cases of the tests
    c = 8
    keymin = np.asarray([-1, 50], np.int32)
    blocks = np.full((2, c), imax, np.int32)
    blocks[0] = np.arange(10, 10 + c)
    blocks[1, :3] = [60, 70, 80]
    err, _ = run_case(keymin, blocks,
                      np.asarray([49, 18, 75, 60, imax, 10], np.int32))
    check(err == 0, f"hybrid_search full-block/sentinel case: err {err}")
    rng = np.random.default_rng(0)
    for b in (3, 100, 129):
        km, bl = _registry(rng, 8, 8, 32)
        err, _ = run_case(km, bl, rng.integers(-5, 400, b).astype(np.int32))
        check(err == 0, f"hybrid_search ragged B={b}: err {err}")

    shapes = {"fig3a": (200, 256, 160, 128), "scale_path": (8000, 16384, 160,
                                                            128),
              "scale": (8000, 16384, 160, 4096)}
    rec = {}
    for name, (m_live, m, c, b) in shapes.items():
        km, bl = _registry(rng, m_live, m, c)
        q = _queries(rng, bl, b)
        err, args = run_case(km, bl, q)
        check(err == 0, f"hybrid_search {name} (M={m}, C={c}, B={b}): "
                        f"kernel != plain, max err {err}")
        ms = device_ms(lambda: K.hybrid_search(*args),
                       name="hybrid_search_kernel")
        plain_ms = device_ms(lambda: K.hybrid_search_ref(*args))
        call_ms = time_cuda(lambda: K.hybrid_search(*args))
        plain_call_ms = time_cuda(lambda: K.hybrid_search_ref(*args),
                                  iters=50)
        # least work: each query, the row it reads and the outputs once,
        # plus the registry column; ops: the search steps and the row
        # compares (two per key)
        entry = np.clip(np.searchsorted(km, q, side="left") - 1, 0, m - 1)
        rows = np.unique(entry).size
        nbytes = m * 4 + rows * c * 4 + b * 4 + b * 5
        nops = b * (HS.levels(m) + 2 * c)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / CORE_OPS_PER_S * 1e3
        rec[name] = dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                         plain_call_ms=plain_call_ms, max_abs_err=err,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", shape=[m, c, b])
        log(f"[kernels] hybrid_search {name} M={m} C={c} B={b}: kernel "
            f"{ms * 1e3:.3f} us on the device per launch, bound "
            f"{rec[name]['bound_ms'] * 1e3:.4f} us ({rec[name]['bound_by']});"
            f" one wrapper call back to back {call_ms * 1e3:.2f} us; plain "
            f"version (reference only) {plain_ms * 1e3:.3f} us on the device, "
            f"{plain_call_ms * 1e3:.2f} us per call; bit-identical")
    return rec


def _run_fig3a(timer):
    import numpy as np
    import torch
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.data.ycsb import load_phase, mixed_phase
    from repro_torch.kernels import ops as K

    load_kinds, load_keys = load_phase(2000, 8000, seed=1)
    kinds, keys = mixed_phase(4000, 8000, 0.5, seed=2)
    backend = LocalBackend(bench_cfg(), device="cuda", timer=timer)
    bal = Balancer(backend)
    K.hybrid_search.launches = 0
    drive_backend(backend, load_kinds, load_keys, 64, balancer=bal)
    load_rounds = backend.stats["rounds"]
    settle(backend, bal)
    settle_rounds = backend.stats["rounds"]
    if timer is not None:
        timer.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_backend(backend, kinds, keys, 64, balancer=bal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches

    oracle = OracleList()
    oracle.apply_batch(load_kinds.tolist(), load_keys.tolist())
    oracle.apply_batch(kinds.tolist(), keys.tolist())
    got = backend.all_keys()
    check(got == sorted(oracle.snapshot()),
          "fig3a: final key set differs from the sequential oracle")
    st = backend.stats
    counts = dict(rounds=st["rounds"], load_rounds=load_rounds,
                  settle_rounds=settle_rounds, fast_hits=st["fast_hits"],
                  mut_hits=st["mut_hits"], blk_hits=st["blk_hits"],
                  sublists=sum(1 for e in backend.sublists(0)
                               if e["owner"] == 0), keys=len(got))
    check(counts == FIG3A_EXPECTED,
          f"fig3a: counts {counts} != reference {FIG3A_EXPECTED}")
    check(launches > 0 and counts["blk_hits"] > 0,
          f"fig3a: hybrid_search launched {launches} times, blk_hits "
          f"{counts['blk_hits']}: the main path did not reach the kernel")
    mix_rounds = st["rounds"] - settle_rounds
    return dict(ops_per_s=len(kinds) / dt, seconds=dt,
                mix_rounds=mix_rounds, launches=launches, counts=counts,
                backend=backend, kinds=kinds, keys=keys)


def profile_rounds(backend, kinds, keys, rounds: int = 8) -> dict:
    """A ``torch.profiler`` window over ``rounds`` rounds of r50 traffic on
    a settled list: the device's busy share of the wall time, and the
    device work that fills it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(rounds):
            sl = slice(64 * r, 64 * (r + 1))
            backend.submit(0, kinds[sl].tolist(), keys[sl].tolist())
            backend.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = _device_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    launches = sum(e.count for e in ev)
    # every host read of a device scalar (an early-exit test, a count)
    # waits for the device
    reads = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    top = sorted(ev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    log(f"[profile] {rounds} r50 rounds: wall {wall * 1e3:.2f} ms, device "
        f"busy {busy * 1e3:.3f} ms ({100 * busy / wall:.2f}% of wall, idle "
        f"{100 - 100 * busy / wall:.2f}%); {launches / rounds:.0f} device "
        f"launches and {reads / rounds:.0f} host reads of a device scalar "
        f"per round; top: " + "; ".join(
            f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in top))
    return dict(busy_share=busy / wall, launches_per_round=launches / rounds,
                reads_per_round=reads / rounds)


def phase_fig3a() -> dict:
    from repro_torch.timing import PhaseTimer
    plain = _run_fig3a(None)
    log(f"[fig3a] r50 block probe: {plain['ops_per_s']:.1f} ops/s over the "
        f"mix ({plain['mix_rounds']} rounds, {plain['seconds']:.3f} s, "
        f"{1e3 * plain['seconds'] / plain['mix_rounds']:.3f} ms/round); "
        f"counts equal the reference: {plain['counts']}; hybrid_search "
        f"launches over load+settle+mix: {plain['launches']}")
    prof = profile_rounds(plain.pop("backend"), plain.pop("kinds"),
                          plain.pop("keys"))
    timer = PhaseTimer("cuda")
    timed = _run_fig3a(timer)
    for k in ("backend", "kinds", "keys"):
        timed.pop(k)
    bd = breakdown(timer, timed["mix_rounds"])
    log(f"[fig3a] with the phase timer: {timed['ops_per_s']:.1f} ops/s; "
        f"per-round ms over the mix: {json.dumps(bd)}; round "
        f"{1e3 * timed['seconds'] / timed['mix_rounds']:.3f} ms")
    return dict(plain=plain, timed=timed, breakdown=bd, profile=prof)


def phase_client() -> None:
    import numpy as np
    from repro_torch.api import local_client
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.types import (DiLiConfig, OP_FIND, OP_INSERT,
                                        OP_REMOVE)

    cfg = DiLiConfig(num_shards=1, pool_capacity=4096, max_sublists=32,
                     max_ctrs=32, max_scan=4096, batch_size=16,
                     mailbox_cap=256, split_threshold=48, block_probe=True)
    client = local_client(cfg, device="cuda")
    client.balance = Balancer(client.backend)
    rng = np.random.default_rng(9)
    n = 400
    kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], n,
                       p=[0.4, 0.4, 0.2]).tolist()
    keys = rng.integers(1, 300, n).tolist()
    futs = client.submit(kinds, keys)
    client.settle()
    got = [f.result(wait=False) for f in futs]
    oracle = OracleList()
    check(got == oracle.apply_batch(kinds, keys),
          "client: a future's result differs from the sequential oracle")
    check(client.all_keys() == sorted(oracle.snapshot()),
          "client: key set differs from the sequential oracle")
    log(f"[client] {n} ops through DiLiClient futures match the oracle; "
        f"stats {json.dumps(client.stats)}")


def phase_scale(n_keys: int, timed_rounds: int = 64) -> dict:
    """Load, settle and an untimed r50 mix (ops/s) checked against the
    oracle; then ``timed_rounds`` more rounds of the same mix under the
    phase timer (the breakdown) and a profiler window."""
    import torch
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.data.ycsb import load_phase, mixed_phase
    from repro_torch.kernels import ops as K
    from repro_torch.timing import PhaseTimer

    key_space = 1 << 21
    cfg = bench_cfg(pool_capacity=1 << 21, max_sublists=16384,
                    max_ctrs=16384)
    load_kinds, load_keys = load_phase(n_keys, key_space, seed=1)
    kinds, keys = mixed_phase(n_keys, key_space, 0.5, seed=2)
    backend = LocalBackend(cfg, device="cuda")
    bal = Balancer(backend)
    K.hybrid_search.launches = 0
    t0 = time.perf_counter()
    drive_backend(backend, load_kinds, load_keys, 64, balancer=bal)
    t_load = time.perf_counter() - t0
    load_rounds = backend.stats["rounds"]
    settle(backend, bal)
    settle_rounds = backend.stats["rounds"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_backend(backend, kinds, keys, 64, balancer=bal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches

    oracle = OracleList()
    oracle.apply_batch(load_kinds.tolist(), load_keys.tolist())
    oracle.apply_batch(kinds.tolist(), keys.tolist())
    got = backend.all_keys()
    check(got == sorted(oracle.snapshot()),
          "scale: final key set differs from the sequential oracle")
    st = dict(backend.stats)
    mix_rounds = st["rounds"] - settle_rounds
    sub = sum(1 for e in backend.sublists(0) if e["owner"] == 0)
    check(launches > 0 and st["blk_hits"] > 0,
          f"scale: hybrid_search launched {launches} times, blk_hits "
          f"{st['blk_hits']}")
    log(f"[scale] {n_keys} keys loaded into 2**21-node pool, "
        f"{sub} sublists: load {n_keys / t_load:.1f} ops/s "
        f"({load_rounds} rounds, {t_load:.1f} s), settle "
        f"{settle_rounds - load_rounds} rounds, r50 mix "
        f"{len(kinds) / dt:.1f} ops/s ({mix_rounds} rounds, {dt:.1f} s, "
        f"{1e3 * dt / mix_rounds:.3f} ms/round); fast_hits "
        f"{st['fast_hits']} mut_hits {st['mut_hits']} blk_hits "
        f"{st['blk_hits']}; launches {launches}")

    # the breakdown, from a window after the measured mix
    timer = PhaseTimer("cuda")
    backend.cluster.timer = timer
    r0 = backend.stats["rounds"]
    n = 64 * timed_rounds
    t0 = time.perf_counter()
    drive_backend(backend, kinds[:n], keys[:n], 64, balancer=bal)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    backend.cluster.timer = None
    rounds_t = backend.stats["rounds"] - r0
    bd = breakdown(timer, rounds_t)
    log(f"[scale] with the phase timer, {rounds_t} more r50 rounds: "
        f"{n / dt_t:.1f} ops/s, round {1e3 * dt_t / rounds_t:.3f} ms; "
        f"per-round ms: {json.dumps(bd)}")
    profile_rounds(backend, kinds, keys)
    return dict(ops_per_s=len(kinds) / dt, launches=launches)


# ------------------------------------------------------------------- main

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device: the port's smoke runs on a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    phase_build()
    krec = phase_kernels()
    f3 = phase_fig3a()
    phase_client()
    scale = phase_scale(SCALE_KEYS)

    k = krec["fig3a"]
    kernels = [dict(
        name="hybrid_search", route="cuda",
        source="src/repro_torch/kernels/csrc/hybrid_search.cu",
        replaces="src/repro/kernels/hybrid_search.py:58",
        launches=f3["plain"]["launches"], max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], call_ms=k["call_ms"],
        ms_scale_path=krec["scale_path"]["ms"],
        launches_scale=scale["launches"])]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
