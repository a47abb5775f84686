"""Round-trace entries for replay checking (DESIGN.md §11).

``trace_entry`` compresses one round's observable outcome. (State digests
that line up with the reference's live with the parity tests: they hash
canonical int32 views, where the reference's own digest hashes
``str(dtype)`` and cannot match across the two packages.)
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def trace_entry(round_no: int, completions: Sequence[Tuple[int, int, int]],
                out_counts: Iterable[int], extra: int = 0) -> str:
    """One round's observable outcome, as a stable compact string."""
    comp = ",".join(f"{s}:{v}:{r}" for s, v, r in sorted(completions))
    outs = ",".join(str(int(c)) for c in out_counts)
    return f"r{round_no}|c[{comp}]|o[{outs}]|x{extra}"
