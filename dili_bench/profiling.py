"""The profiler stretch of a traced window, and what is read from it.

Rewritten from ``chip_smoke.py::profile_rounds`` at commit ``a359376``:
``torch.profiler`` with host and device activity over whole rounds,
ending in a synchronise. The device is busy while any of its operations
runs: the union of their intervals on each card, so that overlapping
streams count once (the smoke summed self times; one stream gives the
same). The idle gaps between a card's operations are named by the
innermost span the host was in at their middle: the program's spans, or
the loop's own ``bench.*`` ones. The device work the host launched inside
``roofline.RECORD_SPAN`` is the benchmark's own copies and is left out:
it is found by the correlation id that a launch and its device operation
share.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

from .roofline import RECORD_SPAN, HybridSearchCalls

TOP = 10
# device operation names are C++ signatures; their head names them
NAME_CHARS = 120
KERNEL = "hybrid_search_kernel"


def _ns(e):
    """An event's start and end in ns on the profiler's clock."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return 1e3 * e.start_us(), 1e3 * (e.start_us() + e.duration_us())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _namer(spans):
    """Innermost span (shortest) holding a time, among the 64 that start
    last before it: spans nest a few deep, so the holder is close."""
    spans.sort()
    starts = [s for s, _, _ in spans]

    def name(t):
        i = bisect.bisect_right(starts, t)
        best = None
        for s, e, n in spans[max(0, i - 64):i]:
            if e >= t and (best is None or e - s < best[0]):
                best = (e - s, n)
        return best[1] if best else "outside spans"
    return name


def _launched_inside(events, spans, device_type):
    """Correlation ids of the launches and copies the host made inside
    ``spans``, a list of ``(start, end)`` ns that do not overlap."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    ids = set()
    for e in events:
        if e.device_type() == device_type or e.is_user_annotation():
            continue
        cid = e.correlation_id()
        if not cid:
            continue
        t, _ = _ns(e)
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            ids.add(cid)
    return ids


def read_events(events, cards, device_type) -> dict:
    """Busy seconds per card, the device operations by time, and the idle
    gaps by the host span they fall in, from the profiler's events; also
    ``hybrid_search``'s kernel time and the benchmark's own device time."""
    notes = {e.name() for e in events if e.is_user_annotation()}
    ours = _launched_inside(
        events, [_ns(e) for e in events if e.is_user_annotation()
                 and e.device_type() != device_type
                 and e.name() == RECORD_SPAN], device_type)
    per_card = defaultdict(list)
    op_time = defaultdict(float)
    spans = []
    hs_s = 0.0
    hs_n = 0
    own_s = 0.0
    for e in events:
        s, t = _ns(e)
        if e.device_type() == device_type:
            # record_function spans also show on the card, covering the
            # kernels launched inside: they are no device work
            if e.is_user_annotation() or e.name() in notes:
                continue
            if e.correlation_id() in ours:
                own_s += (t - s) / 1e9
                continue
            per_card[e.device_index()].append((s, t))
            op_time[e.name()[:NAME_CHARS]] += (t - s) / 1e9
            if KERNEL in e.name():
                hs_s += (t - s) / 1e9
                hs_n += 1
        elif e.is_user_annotation():
            spans.append((s, t, e.name()))
    name = _namer(spans)
    busy = {}
    gaps = defaultdict(float)
    for c in cards:
        merged = _merge(per_card.get(c, []))
        busy[c] = sum(e - s for s, e in merged) / 1e9
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            gaps[name((e0 + s1) / 2)] += (s1 - e0) / 1e9
    top = sorted(op_time.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=sum(busy.values()) / max(len(busy), 1),
                busy_by_card={str(c): v for c, v in busy.items()},
                device_ops=[[k, v] for k, v in top],
                idle_gaps=[[k, v] for k, v in idle],
                hs_kernel_s=hs_s, hs_kernel_events=hs_n,
                bench_device_s=own_s)


def profile_window(round_fn, seconds: float, devices) -> dict:
    """Runs ``round_fn`` for ``seconds`` under the profiler and returns the
    device's busy seconds (the mean over the cell's cards), the stretch's
    wall seconds, the operations and idle gaps that took most time, and
    ``hybrid_search``'s kernel time beside its calls' least time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = sorted({torch.device(d).index or 0 for d in devices
                    if str(d).startswith("cuda")})
    for c in cards:
        torch.cuda.synchronize(c)
    with HybridSearchCalls() as calls, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds = 0
        while time.perf_counter() - t0 < seconds:
            round_fn()
            rounds += 1
        for c in cards:
            torch.cuda.synchronize(c)
        wall = time.perf_counter() - t0

    # the profiler's own events, not the per-event Python objects that
    # ``prof.events()`` builds: those cost ~60 us each, minutes per window
    out = read_events(prof.profiler.kineto_results.events(), cards,
                      DeviceType.CUDA)
    return dict(out, wall_s=wall, rounds=rounds, hs_calls=len(calls.calls),
                hs_least_s=calls.least_seconds())
