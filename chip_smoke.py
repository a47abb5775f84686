#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA card and the CUDA toolkit (``nvcc``). Phases, each of
which makes the script exit non-zero when it fails:

  1. build   — compile every kernel from the checkout's sources, one
               ``nvcc`` per source, all at once (``sm_90a``; into
               ``build/kernels/``);
  2. kernels — each kernel against its plain PyTorch version on the card:
               ``hybrid_search`` bit for bit at the fig3a and scale shapes
               and on the edge cases of the tests; ``paged_attention`` at
               the reference's three test shapes in f32 and bf16 (atol
               2e-5 / 2e-2, rtol 2e-2) and the serving shape, plus the
               padding-page invariance, the edge cases of the tests
               (``seq_len`` 0, one page, past the table; lengths on split
               boundaries; ragged and one-page splits; S=64 with D=256;
               11, 16 and 32 query heads per KV head) and bitwise
               repeatability. Device times (``torch.profiler``, every
               device operation of a call) beside the bound, the
               wrapper's host time per call and, for ``paged_attention``,
               the nearest library call (gather + SDPA, timed only);
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
  5. serving — Qwen2-0.5B at full width, f32, random weights from a fixed
               seed, through ``ServingEngine`` over a one-shard DiLi page
               index, as ``benchmarks/run.py::serving`` drives it (``SERVE``):
               static, rescan and range modes give identical greedy tokens,
               the index splits live and RANGE heals the snapshot, and
               ``paged_attention`` launches once per layer per decode step;
               then a profiler window (busy share, device launches per
               decode step) and the kernel path against the gather path on
               4 decode steps;
  6. scale   — the paper's capacities (2**21 pool nodes, 16384 registry
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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the CUDA-core f32
# rate (also the nearest table entry for int32 compares) and the bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the kernels of the port's paths, each built from csrc/<name>.cu
KERNELS = ("hybrid_search", "paged_attention")

# the serving phase (benchmarks/run.py::serving at the full width of
# Qwen2-0.5B, one DiLi shard): live requests, their prompt lengths and
# new tokens, parked sequences padding the page index, timed decode steps
# and the rebalance period
SERVE = dict(live=8, prompt_lo=256, prompt_hi=512, max_new=32, idle=32,
             page_size=16, steps=24, rebalance_every=4, seed=0)


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


def device_ms(fn, iters: int = 100, name: str | None = None,
              traces: int = 3) -> float:
    """Device time (ms) per call of ``fn``: the summed duration of the
    device operations it ran (or of those whose name holds ``name``) in a
    ``torch.profiler`` trace of ``iters`` calls. A trace can lose events
    (one smoke run on an H100 lost all of one trace and most of another),
    so ``traces`` traces are taken, those with fewer events than the
    fullest are dropped, and the median of the rest is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in _device_events(prof)
              if name is None or name in e.key]
        runs.append((sum(e.count for e in ev),
                     sum(e.self_device_time_total for e in ev)))
    full = max(n for n, _ in runs)
    kept = sorted(t for n, t in runs if n == full)
    us = kept[(len(kept) - 1) // 2]
    if full == 0 or us <= 0:
        fail(f"the profiler saw no device time for {name or 'the call'} "
             f"in {traces} traces")
    if any(n < full for n, _ in runs):
        log(f"[profile] {sum(n < full for n, _ in runs)} of {traces} "
            f"traces of {name or 'a call'} lost device events")
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
    """Build every kernel's source at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(
            lambda name: B.build(name, verbose=True), KERNELS)))
    for name, path in paths.items():
        log(f"[build] {name} -> {path.relative_to(ROOT)} in "
            f"{B.build_seconds[name]:.2f} s")
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


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


# (B, H, KH, D, pages per sequence, page size): the reference's test shapes
# (tests/test_kernels.py) and the serving shape of Qwen2-0.5B
PAGED_SHAPES = {"test_gqa": (4, 8, 2, 64, 8, 16),
                "test_mha": (2, 16, 16, 128, 4, 32),
                "test_mqa": (8, 4, 1, 64, 16, 8)}
PAGED_TOL = {"f32": dict(atol=2e-5, rtol=2e-2),
             "bf16": dict(atol=2e-2, rtol=2e-2)}


def _paged_case(b, h, kh, d, pages, ps, dtype, seed, lens=None):
    """The reference test's inputs on the card: q and pages from a seeded
    normal, a random page table over a pool 3x the pages, random lengths
    (or ``lens``)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    pool = pages * 3
    dev = torch.device("cuda")

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    q = t(rng.standard_normal((b, h, d)))
    kp = t(rng.standard_normal((pool, ps, kh, d)) * 0.3)
    vp = t(rng.standard_normal((pool, ps, kh, d)) * 0.3)
    pt = rng.integers(0, pool, (b, pages)).astype(np.int32)
    sl = (rng.integers(1, pages * ps + 1, (b,)) if lens is None
          else np.asarray(lens)).astype(np.int32)
    return [q, kp, vp, torch.from_numpy(pt).to(dev),
            torch.from_numpy(sl).to(dev)]


def _paged_library(q, kp, vp, pt, sl, ps):
    """The nearest library call, timed for the table only: a gather of
    each sequence's pages, then ``scaled_dot_product_attention`` with GQA
    and the length mask."""
    import torch
    import torch.nn.functional as F
    b, h, d = q.shape
    pp = pt.shape[1]
    kh = kp.shape[2]
    k = kp[pt.long()].reshape(b, pp * ps, kh, d).transpose(1, 2)
    v = vp[pt.long()].reshape(b, pp * ps, kh, d).transpose(1, 2)
    mask = (torch.arange(pp * ps, device=q.device)[None, :]
            < sl[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                          attn_mask=mask,
                                          enable_gqa=True)[:, :, 0]


def _paged_edge_cases(sms: int):
    """The edge cases of ``tests/test_torch_paged_attention.py``, each as
    (name, shape (B, H, KH, D, PP, S), lengths, dtypes)."""
    from repro_torch.kernels import paged_attention as PA
    cases = []
    b, h, kh, d, pp, ps = 6, 8, 2, 32, 4, 8
    cases.append(("edge_lengths", (b, h, kh, d, pp, ps),
                  [0, 1, ps, ps + 1, pp * ps, pp * ps + 5], ("f32", "bf16")))
    b, h, kh, d, pp, ps = 6, 8, 2, 64, 34, 16
    _, n_split, per = PA.plan(b, h, kh, pp, sms)
    check(n_split > 1, f"paged_attention: {pp} pages of {b} sequences "
                       f"gave one split on {sms} SMs")
    lens = []
    for i in (1, n_split - 2):
        start, end = i * per * ps, min((i + 1) * per, pp) * ps
        lens += [start + 1, end, start]
    cases.append(("split_boundaries", (b, h, kh, d, pp, ps), lens,
                  ("f32", "bf16")))
    b, h, kh, d, ps = 8, 14, 2, 64, 16
    ragged = next(n for n in range(5, 200)
                  if 1 < PA.plan(b, h, kh, n, sms)[1]
                  and n % PA.plan(b, h, kh, n, sms)[1])
    for pp in (ragged, 1):
        cases.append((f"pages_{pp}", (b, h, kh, d, pp, ps),
                      [0, 1, ps, pp * ps, pp * ps + 5, 3, ps + 1,
                       max(pp * ps - 1, 1)], ("f32", "bf16")))
    cases.append(("tiles_s64_d256", (3, 8, 2, 256, 3, 64), [1, 192, 100],
                  ("f32", "bf16")))
    for shape in ((4, 32, 1, 64, 6, 16), (3, 32, 2, 128, 5, 16),
                  (2, 22, 2, 64, 3, 32)):
        b, h, kh, d, pp, ps = shape
        cases.append((f"heads_{h // kh}", shape,
                      [0, 1, pp * ps, 17][:b] + [17] * max(b - 4, 0),
                      ("f32", "bf16")))
    return cases


def phase_paged_kernel(serve_lens) -> dict:
    """``paged_attention`` against its plain twin on the card, at the
    reference's test shapes in f32 and bf16 and at the serving shape (with
    the serving phase's prompt lengths); the padding-page invariance; the
    tests' edge cases; bitwise repeatability; and, per shape, the device
    time of every device operation a call issues beside the bound, the
    wrapper's host time per call and the library call."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attention as PA

    sms = PA.sm_count(torch.device("cuda"))
    shapes = [(f"{n}_{dt}", shp, dt) for n, shp in PAGED_SHAPES.items()
              for dt in ("f32", "bf16")]
    pages = -(-(SERVE["prompt_hi"] + SERVE["max_new"]) // SERVE["page_size"])
    shapes.append(("serving_f32", (SERVE["live"], 14, 2, 64, pages,
                                   SERVE["page_size"]), "f32"))
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def vs_twin(name, args, ps, dt):
        out = K.paged_attention(*args, page_size=ps)
        twin = K.paged_attention_ref(*args, page_size=ps)
        torch.cuda.synchronize()
        err = float((out.float() - twin.float()).abs().max())
        tol = PAGED_TOL[dt]
        ok = bool(torch.allclose(out.float(), twin.float(), **tol))
        check(ok, f"paged_attention {name}: kernel != twin, max err {err} "
                  f"(tolerance {tol})")
        return err, tol, twin

    rec = {}
    for name, (b, h, kh, d, pp, ps), dt in shapes:
        lens = serve_lens if name.startswith("serving") else None
        args = _paged_case(b, h, kh, d, pp, ps, dts[dt], seed=b * 100 + h,
                           lens=lens)
        err, tol, twin = vs_twin(name, args, ps, dt)
        lib = _paged_library(*args, ps)
        lib_err = float((lib.float() - twin.float()).abs().max())
        # every device operation of the wrapper's call, not only the
        # kernel: a memset or a second kernel would count here
        ms = device_ms(lambda: K.paged_attention(*args, page_size=ps))
        call_ms = time_cuda(lambda: K.paged_attention(*args, page_size=ps))
        plain_ms = device_ms(lambda: K.paged_attention_ref(*args,
                                                           page_size=ps))
        library_ms = device_ms(lambda: _paged_library(*args, ps))
        gb, n_split, per = PA.plan(b, h, kh, pp, sms)
        # least work: each live token's K and V rows once, q, the output,
        # the table and the lengths; 4*H*D flops per live token (q.k and
        # p*v), at the rate of the inputs' type
        live = int(args[4].clamp(max=pp * ps).sum())
        elt = args[0].element_size()
        nbytes = live * kh * d * 2 * elt + 2 * b * h * d * elt \
            + b * pp * 4 + b * 4
        nops = 4 * live * (h // kh) * kh * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / (CORE_OPS_PER_S if dt == "f32"
                        else BF16_OPS_PER_S) * 1e3
        rec[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_abs_err=err,
                         library_err=lib_err, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", shape=[b, h, kh, d, pp, ps],
                         dtype=dt, splits=n_split, split_pages=per)
        log(f"[kernels] paged_attention {name} B={b} H={h} KH={kh} D={d} "
            f"PP={pp} S={ps}: max |kernel - twin| {err:.3e} (tolerance "
            f"{tol}); {n_split} splits of {per} pages "
            f"({b * h // gb * n_split} blocks on {sms} SMs); "
            f"{ms * 1e3:.3f} us on the device per "
            f"call, bound {rec[name]['bound_ms'] * 1e3:.4f} us "
            f"({rec[name]['bound_by']}); one wrapper call back to back "
            f"{call_ms * 1e3:.2f} us; twin {plain_ms * 1e3:.3f} us; "
            f"gather + SDPA {library_ms * 1e3:.3f} us (max |lib - twin| "
            f"{lib_err:.3e})")

    # the tests' edge cases against the twin
    for name, (b, h, kh, d, pp, ps), lens, dtypes in _paged_edge_cases(sms):
        for dt in dtypes:
            args = _paged_case(b, h, kh, d, pp, ps, dts[dt], seed=pp,
                               lens=lens)
            err, tol, _ = vs_twin(f"{name}_{dt}", args, ps, dt)
            log(f"[kernels] paged_attention {name}_{dt} B={b} H={h} KH={kh} "
                f"D={d} PP={pp} S={ps} lens {lens}: max |kernel - twin| "
                f"{err:.3e} (tolerance {tol})")

    # the splits merge in a fixed order: repeated calls are bitwise equal
    b, h, kh, d, pp, ps = rec["serving_f32"]["shape"]
    args = _paged_case(b, h, kh, d, pp, ps, torch.float32, seed=1,
                       lens=serve_lens)
    outs = [K.paged_attention(*args, page_size=ps) for _ in range(3)]
    torch.cuda.synchronize()
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "paged_attention: repeated calls on the same inputs differ")
    log("[kernels] paged_attention: 3 calls at the serving shape are "
        "bitwise equal")

    # positions at or past seq_len never count: scrambling the fully
    # masked tail pages leaves the output unchanged
    q, kp, vp, pt, sl = _paged_case(2, 4, 2, 32, 4, 8, torch.float32, 0,
                                    lens=[9, 17])
    pt2 = pt.clone()
    pt2[0, 2:] = (pt2[0, 2:] + 5) % kp.shape[0]
    pt2[1, 3:] = (pt2[1, 3:] + 3) % kp.shape[0]
    o1 = K.paged_attention(q, kp, vp, pt, sl, page_size=8)
    o2 = K.paged_attention(q, kp, vp, pt2, sl, page_size=8)
    torch.cuda.synchronize()
    err = float((o1 - o2).abs().max())
    check(err <= 1e-6, f"paged_attention padding pages changed the output "
                       f"by {err}")
    log(f"[kernels] paged_attention ignores padding pages (max diff "
        f"{err:.1e})")
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


def serve_requests(vocab: int):
    """The serving phase's live requests: prompt lengths and tokens drawn
    from ``SERVE["seed"]``."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    lens = rng.integers(SERVE["prompt_lo"], SERVE["prompt_hi"] + 1,
                        SERVE["live"])
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _timed(fn, spent):
    """``fn``, adding its wall time to ``spent[0]`` on each call that is
    not nested in another timed call (``spent[1]`` is the depth)."""
    def call(*a, **k):
        spent[1] += 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent[1] -= 1
            if spent[1] == 0:
                spent[0] += time.perf_counter() - t0
    return call


def _serve_mode(cfg, params, prompts, mode: str) -> dict:
    """One run of ``benchmarks/run.py::serving`` in ``mode`` (static,
    rescan or range): park the idle sequences, admit the live ones, one
    warm step, then the timed steps with a rebalance every
    ``rebalance_every``-th (not in static)."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine
    ps, live, idle = SERVE["page_size"], SERVE["live"], SERVE["idle"]
    pages = -(-(SERVE["prompt_hi"] + SERVE["max_new"]) // ps)
    eng = ServingEngine(cfg, params, page_size=ps,
                        num_pages=(live + idle + 2) * pages, max_batch=live,
                        dili_shards=1, use_kernel=True,
                        refresh_mode="rescan" if mode == "static" else mode,
                        device="cuda")
    stats = eng.kv.backend.stats
    K.paged_attention.launches = 0
    K.hybrid_search.launches = 0
    t0 = time.perf_counter()
    for sid in range(live, live + idle):
        eng.kv.alloc_pages(sid, pages)
    park_rounds = stats["rounds"]
    t_park = time.perf_counter() - t0
    reqs = [Request(seq_id=i, prompt=p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.admit(r)
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    admit_rounds = stats["rounds"] - park_rounds
    eng.step()                                   # warm step
    torch.cuda.synchronize()
    # the rebalance's own cost: balancer + drain + heal, timed where the
    # engine calls them (nothing else calls them during the timed steps)
    spent = [0.0, 0]
    for obj, fn in ((eng.balancer, "step"), (eng.kv.client, "drain"),
                    (eng.kv, "refresh_seqs"), (eng.kv, "refresh_table")):
        setattr(obj, fn, _timed(getattr(obj, fn), spent))
    step_ms, reb = [], []
    t_all = time.perf_counter()
    for s in range(SERVE["steps"]):
        rebalance = mode != "static" and \
            s % SERVE["rebalance_every"] == SERVE["rebalance_every"] - 1
        r0, subs0 = stats["rounds"], len(eng.kv.backend.sublists(0))
        spent[0] = 0.0
        t0 = time.perf_counter()
        eng.step(rebalance=rebalance)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rebalance:
            reb.append(dict(ms=1e3 * spent[0], step_ms=1e3 * dt,
                            rounds=stats["rounds"] - r0,
                            sublists=(subs0,
                                      len(eng.kv.backend.sublists(0)))))
        else:
            step_ms.append(1e3 * dt)
    wall = time.perf_counter() - t_all
    for obj, fn in ((eng.balancer, "step"), (eng.kv.client, "drain"),
                    (eng.kv, "refresh_seqs"), (eng.kv, "refresh_table")):
        delattr(obj, fn)
    launches = K.paged_attention.launches
    return dict(eng=eng, reqs=reqs, pages=pages, wall=wall, step_ms=step_ms,
                reb=reb,
                launches=launches, hs_launches=K.hybrid_search.launches,
                tokens=[list(r.out) for r in reqs], stats=dict(stats),
                park=(park_rounds, t_park), admit=(admit_rounds, t_admit),
                sublists=len(eng.kv.backend.sublists(0)))


def _kernel_vs_gather(eng, steps: int = 4) -> float:
    """``paged_decode_step`` with the kernel and with the gather on
    identical inputs for ``steps`` steps from the engine's live state.
    Logits within 1e-3; the pages written identically where the inputs
    are identical (layer 0, and every cell not written this step), the
    later layers' new K/V within 1e-3 (their inputs carry the two
    attentions' rounding). Returns the largest logit difference."""
    import numpy as np
    import torch
    from repro_torch.serving.paged import paged_decode_step
    cfg, ps = eng.cfg, eng.page_size
    live = [r for r in eng.active if not r.done]
    ids = [r.seq_id for r in live]
    pt = eng.kv.page_table(ids, [eng._pages(r) for r in live])
    sl = np.asarray([len(r.prompt) + len(r.out) - 1 for r in live],
                    np.int32)
    tok = torch.tensor([[r.out[-1]] for r in live], device="cuda")
    kp, vp = eng.kv.k_pages.clone(), eng.kv.v_pages.clone()
    worst = 0.0
    for _ in range(steps):
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        la, _, _ = paged_decode_step(eng.params, cfg, tok, ka, va, pt, sl,
                                     page_size=ps, use_kernel=True)
        lb, _, _ = paged_decode_step(eng.params, cfg, tok, kb, vb, pt, sl,
                                     page_size=ps, use_kernel=False)
        err = float((la - lb).abs().max())
        worst = max(worst, err)
        check(err <= 1e-3, f"serving: kernel vs gather logits differ by "
                           f"{err}")
        for a, b_, base in ((ka, kb, kp), (va, vb, vp)):
            check(torch.equal(a[0], b_[0]),
                  "serving: layer 0 pages differ between kernel and gather")
            new = (a != base) | (b_ != base)
            check(torch.equal(a[~new], b_[~new]),
                  "serving: a page cell outside this step's writes changed")
            check(float((a - b_).abs().max()) <= 1e-3,
                  "serving: later layers' new K/V differ by more than 1e-3")
        kp, vp = ka, va
        tok = la.argmax(-1, keepdim=True)
        sl = sl + 1
    return worst


def phase_serving() -> dict:
    """Qwen2-0.5B at full width, f32, random weights from a fixed seed,
    through ``ServingEngine(use_kernel=True, dili_shards=1)`` in the three
    modes of ``benchmarks/run.py::serving``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen2_0_5b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], dtype=torch.float32,
                           device="cuda")
    torch.cuda.synchronize()
    log(f"[serving] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e6:.1f} M "
        f"random f32 weights in {time.perf_counter() - t0:.1f} s")
    prompts = serve_requests(cfg.vocab)
    runs = {}
    for mode in ("static", "rescan", "range"):
        r = runs[mode] = _serve_mode(cfg, params, prompts, mode)
        decode_steps = 1 + SERVE["steps"]
        check(r["launches"] == cfg.n_layers * decode_steps,
              f"serving {mode}: paged_attention launched {r['launches']} "
              f"times, not {cfg.n_layers} layers x {decode_steps} steps")
        toks = SERVE["steps"] * SERVE["live"]
        reb = r["reb"]
        log(f"[serving] {mode}: {toks / r['wall']:.1f} tokens/s over "
            f"{SERVE['steps']} steps ({r['wall']:.3f} s); decode step "
            f"{statistics.median(r['step_ms']):.2f} ms median "
            f"({min(r['step_ms']):.2f}-{max(r['step_ms']):.2f}); "
            + (f"rebalances (balancer + drain + heal) "
               f"{[round(x['ms'], 1) for x in reb]} ms in steps of "
               f"{[round(x['step_ms'], 1) for x in reb]} ms, DiLi rounds "
               f"{[x['rounds'] for x in reb]}, sublists "
               f"{[x['sublists'] for x in reb]}; " if reb else "")
            + f"parking {SERVE['idle']} sequences {r['park'][0]} rounds "
            f"{r['park'][1]:.1f} s, admitting {SERVE['live']} "
            f"{r['admit'][0]} rounds {r['admit'][1]:.1f} s; "
            f"paged_attention launches {r['launches']}, hybrid_search "
            f"{r['hs_launches']}; stats {json.dumps(r['stats'])}")
    static, rescan, ranged = runs["static"], runs["rescan"], runs["range"]
    check(rescan["tokens"] == static["tokens"]
          and ranged["tokens"] == static["tokens"],
          "serving: greedy tokens differ across static/rescan/range")
    for mode in ("rescan", "range"):
        check(runs[mode]["sublists"] > 1,
              f"serving {mode}: the page index never split")
    check(ranged["stats"]["range_hits"] > 0,
          "serving range: no RANGE segment was served by the pre-pass")

    eng = static["eng"]
    # two windows of 2 decode steps; the one whose trace holds more device
    # events is kept (a trace can lose events)
    windows = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _device_events(prof)
        windows.append((sum(e.count for e in ev), wall, ev))
    _, wall, ev = max(windows, key=lambda w: w[0])
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    pa = sum(e.self_device_time_total for e in ev
             if "paged_attention_kernel" in e.key) / 1e6
    per_step = sum(e.count for e in ev) / 2
    top = sorted(ev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    log(f"[serving] profiler, 2 decode steps: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.2f}% of "
        f"wall), paged_attention {pa * 1e3:.3f} ms; {per_step:.0f} device "
        f"launches per decode step; top: " + "; ".join(
            f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in top))
    worst = _kernel_vs_gather(eng)
    log(f"[serving] kernel vs gather on 4 decode steps: max |logits| "
        f"difference {worst:.3e} (<= 1e-3), layer-0 pages identical")

    # decode to the end: each finished request frees its pages
    r0, t0 = eng.kv.backend.stats["rounds"], time.perf_counter()
    while eng.active:
        eng.step()
    t_free = time.perf_counter() - t0
    parked = SERVE["idle"] * static["pages"]
    check(all(r.done and len(r.out) == SERVE["max_new"]
              for r in static["reqs"])
          and len(eng.kv.free_slots) == eng.kv.num_pages - parked,
          "serving: finished requests did not free their pages")
    log(f"[serving] decoding to {SERVE['max_new']} tokens freed "
        f"{SERVE['live']} sequences' pages: "
        f"{eng.kv.backend.stats['rounds'] - r0} DiLi rounds, "
        f"{t_free:.1f} s")
    lens = [len(p) for p in prompts]
    return dict(runs={m: {k: v for k, v in r.items()
                          if k not in ("eng", "reqs")}
                      for m, r in runs.items()},
                busy_share=busy / wall, launches_per_step=per_step,
                lens=lens, kvg=worst)


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
    from repro_torch.configs import get_config
    serve_lens = [len(p) for p in
                  serve_requests(get_config("qwen2_0_5b").vocab)]
    prec = phase_paged_kernel(serve_lens)
    f3 = phase_fig3a()
    phase_client()
    serving = phase_serving()
    scale = phase_scale(SCALE_KEYS)

    k = krec["fig3a"]
    p = prec["serving_f32"]
    kernels = [dict(
        name="hybrid_search", route="cuda",
        source="src/repro_torch/kernels/csrc/hybrid_search.cu",
        replaces="src/repro/kernels/hybrid_search.py:58",
        launches=f3["plain"]["launches"], max_abs_err=k["max_abs_err"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], call_ms=k["call_ms"],
        ms_scale_path=krec["scale_path"]["ms"],
        launches_scale=scale["launches"]), dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:29",
        launches=serving["runs"]["range"]["launches"],
        max_abs_err=p["max_abs_err"],
        ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
        bound_by=p["bound_by"], library_ms=p["library_ms"],
        shape=p["shape"], dtype=p["dtype"], call_ms=p["call_ms"],
        splits=p["splits"], split_pages=p["split_pages"],
        serving_launches_per_step=serving["launches_per_step"],
        launches_all_modes=sum(r["launches"]
                               for r in serving["runs"].values()),
        ms_by_shape={n: r["ms"] for n, r in prec.items()})]
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
