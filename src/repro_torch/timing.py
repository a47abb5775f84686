"""Per-phase wall-clock breakdown of rounds (host clock, synchronized).

A ``PhaseTimer`` is created by the caller and handed to ``Cluster`` (which
passes it to ``shard_round``). On a CUDA device each phase synchronizes the
device before and after itself, so its time covers the device work it
issued; the synchronizations are the instrumentation's cost, paid only
when a timer is given.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class PhaseTimer:
    def __init__(self, device):
        self.sync = torch.device(device).type == "cuda"
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()
