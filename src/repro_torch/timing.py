"""Per-phase wall-clock breakdown of rounds (host clock, synchronized), and
counts of what happened inside each phase.

A ``PhaseTimer`` is created by the caller and handed to ``Cluster`` (which
passes it to ``shard_round``). On CUDA each phase synchronizes the devices
the timer was given (the run's one device, or ``ShardMapBackend``'s
placement, whose exchange copies between cards) before and after itself,
so its time covers the device work it issued there; the synchronizations
are the instrumentation's cost, paid only when a timer is given.

``count(name, n)`` adds to a counter of the innermost span open on a
``PhaseTimer`` (``PhaseTimer.counts[span, name]``); with none open it
returns at once, so the program counts without holding the timer. A count
that costs a read of the card is taken only where ``counting()`` says a
span is open. The counters the round keeps: ``refresh_steps``
(``blocks.refresh_blocks``'s longest walk), ``prepass_steps``
(``traverse.probe_batch``'s walk), and ``host_reads`` / ``to_host_bytes``,
every read of a card's tensor by the host (``crossed``), each of which
waits for the card.

``tracer(timer)`` is ``timer``, or where it is None the no-op tracer,
whose spans do nothing.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Optional

import torch

# (timer, span) of every PhaseTimer span open, innermost last
_OPEN: list = []
_LATEST: Optional["PhaseTimer"] = None
_NO_SPAN = contextlib.nullcontext()


class PhaseTimer:
    def __init__(self, device):
        """``device``: the device the timed run uses, or a list of them
        (one per shard, repeats allowed)."""
        global _LATEST
        devs = device if isinstance(device, (list, tuple)) else [device]
        self.devices = list(dict.fromkeys(
            d for d in map(torch.device, devs) if d.type == "cuda"))
        self.sync = bool(self.devices)
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.counts = defaultdict(int)        # (span, counter) -> total
        _LATEST = self

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            self.synchronize()
        _OPEN.append((self, name))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _OPEN.pop()
            if self.sync:
                self.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def synchronize(self) -> None:
        """Wait for the timer's devices."""
        for d in self.devices:
            torch.cuda.synchronize(d)

    def total(self, counter: str) -> Optional[int]:
        """``counter`` summed over the spans, or None where it was never
        counted."""
        got = [v for (_, c), v in self.counts.items() if c == counter]
        return sum(got) if got else None

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
        self.counts.clear()


def latest() -> Optional[PhaseTimer]:
    """The newest ``PhaseTimer`` made in this process, or None."""
    return _LATEST


def counting() -> bool:
    """Whether a ``PhaseTimer`` span is open, so that ``count`` records."""
    return bool(_OPEN)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost span open on a
    ``PhaseTimer``; nothing where none is open."""
    if not _OPEN:
        return
    timer, span = _OPEN[-1]
    timer.counts[span, name] += n


def crossed(t: torch.Tensor, reads: int = 1,
            nbytes: Optional[int] = None) -> None:
    """Count ``reads`` reads of ``t`` by the host, which wait for its card:
    ``host_reads`` and ``to_host_bytes`` (``t.nbytes`` a read, or
    ``nbytes`` in all). A tensor on the CPU crosses nothing."""
    if not _OPEN or t.device.type == "cpu":
        return
    count("host_reads", reads)
    count("to_host_bytes", reads * t.nbytes if nbytes is None else nbytes)


def _no_span(name: str):
    return _NO_SPAN


def tracer(timer):
    """``timer``, or the no-op tracer where it is None."""
    return _no_span if timer is None else timer
