"""The ``hybrid_search`` kernel's least time, frozen for the benchmark.

The count and the peaks are copied from ``chip_smoke.py`` at commit
``a359376`` (``HBM_BYTES_PER_S`` / ``CORE_OPS_PER_S`` at ``:442-443``, the
count in ``phase_kernels`` at ``:1496-1506``). Least work of one call:
the registry column, each distinct row the queries land in, the queries
and the outputs once; operations: a binary search's compares over the
registry and two compares per key of the row. The least time is the
larger of bytes over the HBM rate and operations over the core rate of
one H100 SXM (NVIDIA's data sheet, 700 W).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# the span the recording copies run under: the profiler's reading leaves
# the device work launched inside it out of the device's busy time
RECORD_SPAN = "bench.hs_record"


def least_seconds(keymin: np.ndarray, c: int, queries: np.ndarray) -> float:
    """Least time of one call on ``keymin`` int32[M], rows of ``c`` keys
    and ``queries`` int32[B]."""
    m = keymin.shape[0]
    b = queries.shape[0]
    entry = np.clip(np.searchsorted(keymin, queries, side="left") - 1, 0,
                    m - 1)
    rows = np.unique(entry).size
    nbytes = m * 4 + rows * c * 4 + b * 4 + b * 5
    nops = b * ((max(m, 2) - 1).bit_length() + 2 * c)
    return max(nbytes / HBM_BYTES_PER_S, nops / CORE_OPS_PER_S)


class HybridSearchCalls:
    """While entered, records the inputs of every call the program makes
    to ``repro_torch.kernels.ops.hybrid_search`` (copies on the card, two
    small copies a call, made under ``RECORD_SPAN``), so that each call's
    least time is worked out after the window from its own M, C, B and
    rows."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.kernels import ops
        self.ops = ops
        self.orig = orig = ops.hybrid_search

        def recorded(keymin, blocks, queries):
            with record_function(RECORD_SPAN):
                self.calls.append((keymin.clone(), int(blocks.shape[1]),
                                   queries.clone()))
            return orig(keymin, blocks, queries)

        # the wrapper counts launches under the module's name, which is
        # ours while we are entered
        recorded.launches = orig.launches
        ops.hybrid_search = recorded
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.ops.hybrid_search.launches
        self.ops.hybrid_search = self.orig
        return False

    def least_seconds(self) -> float:
        return sum(least_seconds(k.cpu().numpy(), c, q.cpu().numpy())
                   for k, c, q in self.calls)
