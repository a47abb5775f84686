"""YCSB-style zipfian op-stream generator (paper §7.2).

Workloads: a load phase of N inserts, then a mixed phase with the paper's
read proportions (10% / 50% / 90%), writes split evenly between inserts and
removes, keys drawn zipfian — matching the evaluation protocol of the paper.

``zipf_keys`` is the *bounded* YCSB Zipfian(θ) generator (Gray et al.,
"Quickly generating billion-record synthetic databases"): rank ``i`` of
``n`` has probability ``(1/i^θ) / ζ_n(θ)``, drawn by the closed-form
inverse-CDF approximation every YCSB port uses. This is NOT numpy's
``rng.zipf`` — that one samples an *unbounded* power law with exponent
``a > 1`` whose tail mass depends on ``a`` alone; rejection-sampling it
into ``[1, n]`` both mis-maps θ (YCSB θ→1 means *more* skew, while
exponent→1 under rejection flattens toward the truncation) and distorts
the head/tail ratio the benchmark is calibrated against.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..core.types import OP_FIND, OP_INSERT, OP_REMOVE

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def _zeta(n: int, theta: float) -> float:
    return float(np.sum(1.0 / np.arange(1, n + 1) ** theta))


def zipf_keys(rng: np.random.Generator, n: int, key_space: int,
              theta: float = 0.99, scrambled: bool = False) -> np.ndarray:
    """``n`` draws of the bounded YCSB Zipfian(θ) over ``[1, key_space]``.

    θ ∈ [0, 1): 0 is uniform, →1 is maximally skewed; rank 1 is the
    hottest key. ``scrambled=True`` applies YCSB's ScrambledZipfian
    variant — ranks are FNV-hashed over the key space, so the hot keys
    scatter instead of forming a contiguous prefix (a hot *sublist* vs
    hot *keys* distinction that matters to range-partitioned stores).
    """
    if not 0.0 <= theta < 1.0:
        raise ValueError(f"YCSB theta must be in [0, 1), got {theta}")
    if theta == 0.0:
        ranks = rng.integers(1, key_space + 1, size=n)
    else:
        zetan = _zeta(key_space, theta)
        zeta2 = _zeta(2, theta)
        alpha = 1.0 / (1.0 - theta)
        eta = ((1.0 - (2.0 / key_space) ** (1.0 - theta))
               / (1.0 - zeta2 / zetan))
        u = rng.random(n)
        uz = u * zetan
        ranks = (1 + (key_space * (eta * u - eta + 1.0) ** alpha)).astype(
            np.int64)
        ranks = np.where(uz < 1.0, 1, ranks)
        ranks = np.where((uz >= 1.0) & (uz < 1.0 + 0.5 ** theta), 2, ranks)
        ranks = np.clip(ranks, 1, key_space)
    if scrambled:
        h = (FNV_OFFSET ^ ranks.astype(np.uint64)) * FNV_PRIME
        h ^= h >> np.uint64(27)
        h *= FNV_PRIME
        ranks = 1 + (h % np.uint64(key_space)).astype(np.int64)
    return ranks.astype(np.int32)


def load_phase(n_keys: int, key_space: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    keys = rng.permutation(key_space)[:n_keys] + 1
    kinds = np.full(n_keys, OP_INSERT, np.int32)
    return kinds, keys.astype(np.int32)


def mixed_phase(n_ops: int, key_space: int, read_frac: float,
                seed: int = 0, theta: float = 0.99,
                scrambled: bool = False):
    rng = np.random.default_rng(seed + 1)
    keys = zipf_keys(rng, n_ops, key_space, theta=theta,
                     scrambled=scrambled)
    r = rng.random(n_ops)
    w = (1.0 - read_frac) / 2.0
    kinds = np.where(r < read_frac, OP_FIND,
                     np.where(r < read_frac + w, OP_INSERT,
                              OP_REMOVE)).astype(np.int32)
    return kinds, keys
