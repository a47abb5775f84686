"""Bounded YCSB Zipfian op streams (paper §7.2), frozen for the benchmark.

Copied from ``src/repro_torch/data/ycsb.py`` at commit ``a359376``, with
the op kinds written out instead of imported, so that the yardstick does
not move when the program's generator does. ``zipf_keys`` is the bounded
YCSB Zipfian(θ) generator (Gray et al., "Quickly generating
billion-record synthetic databases"): rank ``i`` of ``n`` has probability
``(1/i^θ) / ζ_n(θ)``, drawn by the closed-form inverse-CDF approximation
every YCSB port uses. ``scrambled=True`` is YCSB's ScrambledZipfian: ranks
are FNV-hashed over the key space, so hot keys scatter instead of forming
a contiguous hot sublist.
"""
from __future__ import annotations

import numpy as np

# the port's op kinds (src/repro_torch/core/types.py); run.py checks that
# they still agree before it submits anything
OP_FIND = 1
OP_INSERT = 2
OP_REMOVE = 3

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def zeta(n: int, theta: float) -> float:
    return float(np.sum(1.0 / np.arange(1, n + 1) ** theta))


def zipf_keys(rng: np.random.Generator, n: int, key_space: int,
              theta: float = 0.99, scrambled: bool = False,
              zetan: float | None = None) -> np.ndarray:
    """``n`` draws of the bounded YCSB Zipfian(θ) over ``[1, key_space]``;
    rank 1 is the hottest key. ``zetan`` may pass ζ_key_space(θ) in, so a
    stream drawn in chunks computes it once."""
    if not 0.0 <= theta < 1.0:
        raise ValueError(f"YCSB theta must be in [0, 1), got {theta}")
    if theta == 0.0:
        ranks = rng.integers(1, key_space + 1, size=n)
    else:
        if zetan is None:
            zetan = zeta(key_space, theta)
        zeta2 = zeta(2, theta)
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


def load_phase(rng: np.random.Generator, n_keys: int, key_space: int):
    """``n_keys`` distinct keys of ``[1, key_space]``, all INSERTs."""
    keys = rng.permutation(key_space)[:n_keys] + 1
    return np.full(n_keys, OP_INSERT, np.int32), keys.astype(np.int32)


def mixed_kinds(rng: np.random.Generator, n: int, read_share: float,
                insert_share_of_writes: float = 0.5) -> np.ndarray:
    """Op kinds: FIND with ``read_share``, the writes split between INSERT
    and REMOVE (evenly in the paper)."""
    r = rng.random(n)
    w = (1.0 - read_share) * insert_share_of_writes
    return np.where(r < read_share, OP_FIND,
                    np.where(r < read_share + w, OP_INSERT,
                             OP_REMOVE)).astype(np.int32)
