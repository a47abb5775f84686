"""Deterministic digests for replay checking (DESIGN.md §11).

``trace_entry`` compresses one round's observable outcome and
``trace_digest`` fingerprints a whole round trace; both are byte for byte
the reference's, so a trace digest taken here equals the reference's for
the same run. ``state_digest`` fingerprints the port's own states for
self-replay checks. It hashes ``str(dtype)`` as the reference's does, and
the reference keeps refs as ``uint32`` where the port keeps their int32
bit patterns, so a state digest never matches across the two packages
(the parity tests compare canonical int32 views instead).
"""
from __future__ import annotations

import hashlib
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch



def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def state_digest(*trees) -> str:
    """SHA-256 over every tensor or array leaf (shape + dtype + bytes) of
    the given states, tables or lists of them, order-stable. Identical
    digests == identical states."""
    h = hashlib.sha256()
    for tree in trees:
        for leaf in _leaves(tree):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().numpy()
            arr = np.asarray(leaf)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def trace_entry(round_no: int, completions: Sequence[Tuple[int, int, int]],
                out_counts: Iterable[int], extra: int = 0) -> str:
    """One round's observable outcome, as a stable compact string."""
    comp = ",".join(f"{s}:{v}:{r}" for s, v, r in sorted(completions))
    outs = ",".join(str(int(c)) for c in out_counts)
    return f"r{round_no}|c[{comp}]|o[{outs}]|x{extra}"


def trace_digest(trace: List[str]) -> str:
    h = hashlib.sha256()
    for line in trace:
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()
