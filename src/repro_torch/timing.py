"""Per-phase wall-clock breakdown of rounds (host clock, synchronized).

A ``PhaseTimer`` is created by the caller and handed to ``Cluster`` (which
passes it to ``shard_round``). On CUDA each phase synchronizes the devices
the timer was given (the run's one device, or ``ShardMapBackend``'s
placement, whose exchange copies between cards) before and after itself,
so its time covers the device work it issued there; the synchronizations
are the instrumentation's cost, paid only when a timer is given.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device):
        """``device``: the device the timed run uses, or a list of them
        (one per shard, repeats allowed)."""
        devs = device if isinstance(device, (list, tuple)) else [device]
        self.devices = list(dict.fromkeys(
            d for d in map(torch.device, devs) if d.type == "cuda"))
        self.sync = bool(self.devices)
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            self.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                self.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def synchronize(self) -> None:
        """Wait for the timer's devices."""
        for d in self.devices:
            torch.cuda.synchronize(d)

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
