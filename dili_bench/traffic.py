"""The one generator every traffic mix goes through.

A mix is a data file, ``traffic/<mix>.json``, of parameters only; this
module turns it and a configuration's key counts into the op streams of
one run, all from ``--seed``:

- the load: ``keys`` distinct keys of ``[1, key_space]``, INSERTs;
- the mix: an endless stream, drawn in fixed chunks, of FIND / INSERT /
  REMOVE with the mix's read share and insert share of the writes, keys
  bounded YCSB Zipfian(``theta``) over the key space, scrambled or not.

The same seed gives the same streams, however many ops a run takes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from . import ycsb

CHUNK = 1 << 16
REQUIRED = ("read_share", "theta")
# what a mix file may leave out: YCSB's even split of writes, the
# unscrambled Zipfian the paper runs, 1,024 closed-loop clients, the
# balancer every 4th round as ``benchmarks/run.py::_drive_backend`` runs
# it, and 8 warm rounds
DEFAULTS = {"insert_share_of_writes": 0.5, "scrambled": False,
            "clients": 1024, "balance_every": 4, "warm_rounds": 8}


def complete_mix(raw: dict, where: str) -> dict:
    """A mix file's parameters over ``DEFAULTS``, checked to be in range."""
    missing = [k for k in REQUIRED if k not in raw]
    if missing:
        raise ValueError(f"{where}: missing {missing}")
    mix = {**DEFAULTS, **raw}
    if not 0.0 <= mix["read_share"] <= 1.0:
        raise ValueError(f"{where}: read_share {mix['read_share']}")
    if not 0.0 <= mix["insert_share_of_writes"] <= 1.0:
        raise ValueError(f"{where}: insert_share_of_writes")
    if not 0.0 <= mix["theta"] < 1.0:
        raise ValueError(f"{where}: theta {mix['theta']} not in [0, 1)")
    if mix["clients"] < 1 or mix["balance_every"] < 1 \
            or mix["warm_rounds"] < 0:
        raise ValueError(f"{where}: clients, balance_every, warm_rounds")
    return mix


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, stream]))


def load_stream(seed: int, n_keys: int,
                key_space: int) -> Tuple[np.ndarray, np.ndarray]:
    return ycsb.load_phase(_rng(seed, 0), n_keys, key_space)


class OpStream:
    """The mix's ops, drawn ``CHUNK`` at a time from one generator."""

    def __init__(self, seed: int, key_space: int, mix: dict):
        self.rng = _rng(seed, 1)
        self.key_space = key_space
        self.mix = mix
        self.zetan = (ycsb.zeta(key_space, mix["theta"])
                      if mix["theta"] > 0 else None)
        self.kinds = np.zeros(0, np.int32)
        self.keys = np.zeros(0, np.int32)
        self.pos = 0

    def _grow(self) -> None:
        m = self.mix
        keys = ycsb.zipf_keys(self.rng, CHUNK, self.key_space,
                              theta=m["theta"], scrambled=m["scrambled"],
                              zetan=self.zetan)
        kinds = ycsb.mixed_kinds(self.rng, CHUNK, m["read_share"],
                                 m["insert_share_of_writes"])
        self.kinds = np.concatenate([self.kinds[self.pos:], kinds])
        self.keys = np.concatenate([self.keys[self.pos:], keys])
        self.pos = 0

    def take(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        while self.kinds.shape[0] - self.pos < n:
            self._grow()
        i = self.pos
        self.pos += n
        return self.kinds[i:i + n], self.keys[i:i + n]
