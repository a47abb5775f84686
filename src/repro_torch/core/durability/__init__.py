"""Durable recovery: per-shard WAL + snapshots + crash-restart replay.

The reference's design (DESIGN.md §14), with the same files on disk.
Rounds are the unit of both linearization and durability: every round
each live shard journals the *inputs* that round consumed (backlog
appends, client feed) plus the post-routing image of its transport-lane
halves, fsyncs, and only then lets the next round's acks make the
round's effects observable to peers. A crash therefore lands on a round
boundary, and recovery is snapshot + deterministic re-execution of
``shard_round`` over the logged feeds (audited against the journaled
completions).

  * ``wal``      — append-only framed record log (crc32, torn-tail safe)
  * ``snapshot`` — periodic full-state snapshots via CheckpointManager,
                   with incremental WAL truncation up to the snapshot
  * ``recovery`` — replay a shard's WAL suffix through ``shard_round``
  * ``engine``   — the orchestration facade ``Cluster`` drives
                   (``Durability``)
"""
from .engine import (Durability, DurabilityConfig,  # noqa: F401
                     validate_crash_plans)
from .recovery import RecoveredShard, RecoveryError, recover_shard  # noqa: F401
from .snapshot import ShardSnapshots                        # noqa: F401
from .wal import (KIND_COMMAND, KIND_ROUND, KIND_SUBMIT,  # noqa: F401
                  WriteAheadLog)
