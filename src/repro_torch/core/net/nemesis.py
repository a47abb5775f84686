"""Deterministic nemesis: a seeded adversary for the wire (DESIGN.md §11).

The nemesis sits *below* the reliable transport: it perturbs raw wire
frames (drop / duplicate / reorder / delay / partition) and the transport
above it must still deliver every DiLi message exactly once, in per-lane
order. Everything here is a pure function of ``(seed, NemesisConfig,
frame sequence)`` — the same schedule replays byte-identically from its
``(seed, config)`` pair, which is what turns a hunt-found failure into a
checked-in regression (tests/nemesis_corpus.json).

Fault model per frame, applied in this order each round:

  1. **partition** — frames crossing an active partition cut are dropped
     unconditionally (they retransmit after the cut heals);
  2. **drop** — lost with probability ``drop_prob``;
  3. **dup** — with probability ``dup_prob`` a surviving frame is
     delivered twice (the duplicate rides the same round);
  4. **delay** — with probability ``delay_prob`` a frame is held for
     1..``delay_rounds`` rounds before becoming deliverable;
  5. **reorder** — with probability ``reorder_prob`` per frame, the
     round's deliverable batch is locally shuffled (a perturbed sort, so
     reordering is also seed-deterministic).

``link_overrides`` replaces the four probabilities on named (src, dst)
links — e.g. one asymmetric lossy link in an otherwise clean fabric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

# A wire frame: (emitting shard, destination shard, int32 message row).
# The lane identity travels out-of-band of the row because F_SRC is
# protocol metadata (the reply shard for MSG_OP), not the emitter.
Frame = Tuple[int, int, np.ndarray]


@dataclass(frozen=True)
class LinkFaults:
    """Per-link fault probabilities (also the global defaults)."""
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    delay_prob: float = 0.0


@dataclass(frozen=True)
class Partition:
    """Links between ``group`` and every other shard are cut while
    ``start_round <= round < end_round`` (both directions)."""
    start_round: int
    end_round: int
    group: Tuple[int, ...]


@dataclass(frozen=True)
class CrashPlan:
    """kill -9 ``shard`` at the top of ``crash_round``; restart it (via
    snapshot + WAL replay, DESIGN.md §14) at the top of
    ``restart_round``. The crash lands on a round boundary — the WAL's
    fsync-before-ack discipline means a round's effects are durable
    before any peer can observe them, so mid-round torn state is not a
    reachable fault (the wire-level nemesis already covers torn traffic).
    """
    shard: int
    crash_round: int
    restart_round: int

    def __post_init__(self):
        if self.restart_round <= self.crash_round:
            raise ValueError(
                f"CrashPlan(shard={self.shard}): restart_round "
                f"{self.restart_round} must follow crash_round "
                f"{self.crash_round}")


@dataclass(frozen=True)
class NemesisConfig:
    """One adversarial schedule, replayable from ``(seed, config)``."""
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    reorder_prob: float = 0.0
    delay_prob: float = 0.0
    delay_rounds: int = 2
    partitions: Tuple[Partition, ...] = ()
    # (src, dst) -> LinkFaults overriding the global probabilities
    link_overrides: Tuple[Tuple[Tuple[int, int], LinkFaults], ...] = ()
    # crash-restart schedules (the durable-recovery fault axis, §14)
    crashes: Tuple[CrashPlan, ...] = ()

    def faults_for(self, src: int, dst: int) -> LinkFaults:
        for (s, d), lf in self.link_overrides:
            if s == src and d == dst:
                return lf
        return LinkFaults(self.drop_prob, self.dup_prob,
                          self.reorder_prob, self.delay_prob)

    def repro(self, seed: int) -> str:
        """The one-line ``(seed, config)`` repro string printed on failure
        and stored in the regression corpus."""
        return f"(seed={seed}, config={self.to_dict()})"

    def to_dict(self) -> dict:
        return {
            "drop_prob": self.drop_prob, "dup_prob": self.dup_prob,
            "reorder_prob": self.reorder_prob,
            "delay_prob": self.delay_prob,
            "delay_rounds": self.delay_rounds,
            "partitions": [[p.start_round, p.end_round, list(p.group)]
                           for p in self.partitions],
            "link_overrides": [
                [[s, d], [lf.drop_prob, lf.dup_prob, lf.reorder_prob,
                          lf.delay_prob]]
                for (s, d), lf in self.link_overrides],
            "crashes": [[c.shard, c.crash_round, c.restart_round]
                        for c in self.crashes],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NemesisConfig":
        return cls(
            drop_prob=float(d.get("drop_prob", 0.0)),
            dup_prob=float(d.get("dup_prob", 0.0)),
            reorder_prob=float(d.get("reorder_prob", 0.0)),
            delay_prob=float(d.get("delay_prob", 0.0)),
            delay_rounds=int(d.get("delay_rounds", 2)),
            partitions=tuple(Partition(int(a), int(b), tuple(g))
                             for a, b, g in d.get("partitions", ())),
            link_overrides=tuple(
                ((int(s), int(d_)), LinkFaults(*map(float, lf)))
                for (s, d_), lf in d.get("link_overrides", ())),
            crashes=tuple(CrashPlan(int(s), int(a), int(b))
                          for s, a, b in d.get("crashes", ())),
        )


class Nemesis:
    """Applies a ``NemesisConfig`` to each round's wire batch.

    Draws come from one ``numpy`` Generator seeded by a child of the
    run's root ``SeedSequence`` — the nemesis stream is independent of
    the sim's delay stream and the balancer stream, so adding faults
    never perturbs the other streams' draws (single-seed replayability).
    """

    def __init__(self, config: NemesisConfig, rng: np.random.Generator):
        self.config = config
        self.rng = rng
        # frames held back by `delay`, keyed by due round
        self._held: Dict[int, List[Frame]] = {}
        self.stats = {"dropped": 0, "duplicated": 0, "reordered": 0,
                      "delayed": 0, "partitioned": 0}

    # ------------------------------------------------------------ helpers
    def _cut(self, src: int, dst: int, round_no: int) -> bool:
        for p in self.config.partitions:
            if p.start_round <= round_no < p.end_round:
                if (src in p.group) != (dst in p.group):
                    return True
        return False

    def in_flight(self) -> int:
        """Frames held by `delay` and not yet released."""
        return sum(len(v) for v in self._held.values())

    def held_touching(self, shard: int) -> int:
        """Held frames on lanes touching ``shard`` — consulted by
        ``Transport.shard_idle`` so a lane reset can't race a delayed
        duplicate into the fresh sequence stream (DESIGN.md §13)."""
        return sum(1 for frames in self._held.values()
                   for src, dst, _ in frames
                   if src == shard or dst == shard)

    # ------------------------------------------------------------- perturb
    def perturb(self, frames: List[Frame], round_no: int) -> List[Frame]:
        """Adversarially filter one round's wire batch.

        ``frames``: (src, dst, row) wire frames, already transport-
        stamped. Returns the frames deliverable this round (including
        released delayed frames and injected duplicates), possibly
        reordered.
        """
        # frames coming due from the delay stage re-enter at the
        # partition check: a cut that started while they were held must
        # still cut them (they retransmit after it heals)
        out: List[Frame] = []
        for src, dst, row in self._held.pop(round_no, []):
            if self._cut(src, dst, round_no):
                self.stats["partitioned"] += 1
                continue
            out.append((src, dst, row))
        for src, dst, row in frames:
            if self._cut(src, dst, round_no):
                self.stats["partitioned"] += 1
                continue
            lf = self.config.faults_for(src, dst)
            # one draw per decision keeps the stream layout stable: a
            # frame consumes draws only for the stages it reaches
            if lf.drop_prob > 0.0 and self.rng.random() < lf.drop_prob:
                self.stats["dropped"] += 1
                continue
            copies = 1
            if lf.dup_prob > 0.0 and self.rng.random() < lf.dup_prob:
                copies = 2
                self.stats["duplicated"] += 1
            for _ in range(copies):
                if (lf.delay_prob > 0.0
                        and self.rng.random() < lf.delay_prob):
                    hold = 1 + int(self.rng.integers(
                        max(1, self.config.delay_rounds)))
                    self._held.setdefault(round_no + hold, []).append(
                        (src, dst, row.copy()))
                    self.stats["delayed"] += 1
                else:
                    out.append((src, dst, row.copy()))
        # reorder: perturb a stable sort key — frames flagged for reorder
        # jump a seeded distance, everything else keeps arrival order
        rp = max((self.config.reorder_prob,
                  *(lf.reorder_prob
                    for _, lf in self.config.link_overrides)))
        if rp > 0.0 and len(out) > 1:
            key = np.arange(len(out), dtype=np.float64)
            for i, (src, dst, _) in enumerate(out):
                lf = self.config.faults_for(src, dst)
                if lf.reorder_prob > 0.0 and \
                        self.rng.random() < lf.reorder_prob:
                    key[i] += self.rng.uniform(-len(out), len(out))
                    self.stats["reordered"] += 1
            out = [out[i] for i in np.argsort(key, kind="stable")]
        return out
