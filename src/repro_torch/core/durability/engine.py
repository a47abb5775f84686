"""``Durability``: the per-backend orchestration facade.

``Cluster`` drives durability through this one object, as the
reference's backends do:

  * ``ensure_genesis`` — written at attach time so recovery always has a
    durable base (the pre-round-0 state, snapshot step 0);
  * ``log_submit``    — client rows journaled before their op ids leak;
  * ``log_round``     — one record per live shard per round, fsync'd
    before the engine moves on (fsync-before-ack);
  * ``maybe_snapshot``/``snapshot_now`` — cadence snapshots + the
    post-recovery snapshot, each followed by incremental WAL truncation;
  * ``recover``       — snapshot + replay, returning what to reinstall.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..types import DiLiConfig
from .recovery import RecoveredShard, recover_shard
from .snapshot import ShardSnapshots
from .wal import KIND_COMMAND, KIND_ROUND, KIND_SUBMIT, WriteAheadLog

_LANE = "lane/"


def validate_crash_plans(crashes, num_shards: int) -> None:
    """CrashPlan sanity: shard in range, per-shard windows disjoint (a
    shard must restart before it can crash again). ``Cluster`` calls this
    at construction so a bad schedule fails fast."""
    windows: Dict[int, list] = {}
    for c in crashes:
        if not 0 <= c.shard < num_shards:
            raise ValueError(
                f"CrashPlan shard {c.shard} out of range 0..{num_shards - 1}")
        windows.setdefault(c.shard, []).append(
            (c.crash_round, c.restart_round))
    for s, spans in windows.items():
        spans.sort()
        for (_, e0), (b1, _) in zip(spans, spans[1:]):
            if b1 <= e0:
                raise ValueError(
                    f"CrashPlans for shard {s} overlap: a shard must "
                    f"restart before it can crash again")


@dataclass(frozen=True)
class DurabilityConfig:
    """Knobs for the durability subsystem (host-side; not jit-static)."""
    snapshot_every: int = 64     # cadence in rounds; <=0 disables cadence
    keep: int = 2                # snapshot retention per shard
    group_commit_rounds: int = 1  # fsync KIND_ROUND records every N
                                 # rounds instead of per record: write
                                 # amplification drops ~N:1 while the
                                 # fsync-before-ack discipline holds at
                                 # every batch boundary. 1 = the legacy
                                 # sync-per-round behavior. Submits and
                                 # commands always sync (durable on
                                 # acceptance).


class Durability:
    """Per-shard WALs + snapshot stores rooted at one directory."""

    def __init__(self, directory: str, cfg: DiLiConfig,
                 config: Optional[DurabilityConfig] = None):
        self.dir = directory
        self.cfg = cfg
        self.config = config or DurabilityConfig()
        os.makedirs(directory, exist_ok=True)
        self._wals: Dict[int, WriteAheadLog] = {}
        self._snaps: Dict[int, ShardSnapshots] = {}
        self.stats = {"records": 0, "submits": 0, "commands": 0,
                      "snapshots": 0, "recoveries": 0,
                      "replayed_rounds": 0}

    def wal(self, s: int) -> WriteAheadLog:
        if s not in self._wals:
            self._wals[s] = WriteAheadLog(
                os.path.join(self.dir, f"shard_{s:02d}.wal"))
        return self._wals[s]

    def snaps(self, s: int) -> ShardSnapshots:
        if s not in self._snaps:
            self._snaps[s] = ShardSnapshots(self.dir, s,
                                            keep=self.config.keep)
        return self._snaps[s]

    # ------------------------------------------------------------- journal
    def ensure_genesis(self, s: int, state, bg, backlog,
                       lanes: Dict[str, np.ndarray]) -> None:
        if self.snaps(s).latest_round() is None:
            self.snaps(s).save(-1, state, bg, backlog, lanes)
            self.stats["snapshots"] += 1

    def log_submit(self, s: int, round_no: int, rows: np.ndarray) -> None:
        self.wal(s).append({
            "round": np.int64(round_no), "kind": np.int64(KIND_SUBMIT),
            "appends": np.asarray(rows, np.int32)})
        self.stats["submits"] += 1

    def log_command(self, s: int, round_no: int, cmd: int,
                    args, ok: bool) -> None:
        """A balancer split/move/merge queued host-side into shard
        ``s``'s BgTable — journaled because it bypasses the inbox (see
        wal.py). ``ok`` (whether a slot accepted it) is audited on
        replay."""
        self.wal(s).append({
            "round": np.int64(round_no), "kind": np.int64(KIND_COMMAND),
            "cmd": np.int64(cmd),
            "args": np.asarray(list(args), np.int64),
            "ok": np.int64(bool(ok))})
        self.stats["commands"] += 1

    def log_round(self, s: int, round_no: int, *, appends, client, comp,
                  bg_phases, epoch: int,
                  lanes: Dict[str, np.ndarray]) -> None:
        rec = {
            "round": np.int64(round_no), "kind": np.int64(KIND_ROUND),
            "appends": np.asarray(appends, np.int32),
            "client": np.asarray(client, np.int32),
            "comp": np.asarray(comp, np.int32).reshape(-1, 4),
            "bg_phases": np.asarray(bg_phases),
            "epoch": np.int64(epoch),
        }
        for k, v in lanes.items():
            rec[_LANE + k] = v
        every = max(1, int(self.config.group_commit_rounds))
        self.wal(s).append(rec, sync=(round_no + 1) % every == 0)
        self.stats["records"] += 1

    # ----------------------------------------------------------- snapshots
    def maybe_snapshot(self, s: int, round_no: int, state, bg, backlog,
                       lanes: Dict[str, np.ndarray]) -> bool:
        every = self.config.snapshot_every
        if every <= 0 or (round_no + 1) % every != 0:
            return False
        self.snapshot_now(s, round_no, state, bg, backlog, lanes)
        return True

    def snapshot_now(self, s: int, round_no: int, state, bg, backlog,
                     lanes: Dict[str, np.ndarray]) -> None:
        """Durable snapshot at ``round_no``, then drop the WAL prefix it
        covers. Ordering matters: truncate only after the snapshot's
        atomic rename — a crash between the two replays the (still
        intact) longer suffix onto the older snapshot instead."""
        self.snaps(s).save(round_no, state, bg, backlog, lanes)
        self.wal(s).truncate_upto(round_no)
        self.stats["snapshots"] += 1

    def fsync_count(self) -> int:
        """Total fsyncs issued across every shard's WAL — the write-
        amplification observable the group-commit test pins down."""
        return sum(w.fsyncs for w in self._wals.values())

    def fsync_seconds(self) -> float:
        """Host seconds spent in WAL flush + fsync, over every shard."""
        return sum(w.fsync_seconds for w in self._wals.values())

    def wal_bytes(self) -> int:
        """Framed WAL bytes appended, over every shard (truncation does
        not subtract)."""
        return sum(w.bytes_written for w in self._wals.values())

    # ------------------------------------------------------------- recover
    def recover(self, s: int, *, in_cap: int,
                device="cuda") -> RecoveredShard:
        """Snapshot + replay of shard ``s`` on ``device``."""
        rec = recover_shard(self.cfg, s, self.wal(s), self.snaps(s),
                            in_cap=in_cap, device=device)
        self.stats["recoveries"] += 1
        self.stats["replayed_rounds"] += rec.replayed_rounds
        return rec
