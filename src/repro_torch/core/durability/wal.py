"""Per-shard write-ahead log: append-only, framed, torn-tail safe.

One WAL file per shard holds a sequence of records, each a dict of
``str -> np.ndarray`` serialized as an in-memory ``.npz`` blob and framed

    MAGIC(4) | length u32 | crc32 u32 | payload

Appends are flush+fsync'd before returning — the fsync-before-ack
discipline (DESIGN.md §14): a round's record must be durable before the
*next* round's cumulative acks let peers forget the frames that fed it.
The reader validates magic + crc per frame and truncates at the first
torn/corrupt frame, so a crash mid-append costs exactly the record being
written (whose round, by the same discipline, nobody observed yet).

``truncate_upto`` drops the prefix a snapshot made redundant, rewriting
through a tmp file + ``os.replace`` — the same atomic-rename discipline
as ``checkpoint/ckpt.py`` (a crash mid-truncate leaves the old log).

Two record kinds, distinguished by the ``kind`` scalar:

  * ``KIND_ROUND``  — one executed round: the client feed it consumed,
    the rows appended to the host backlog by routing, the completions it
    produced (replay audit), post-round bg phases + epoch (audit), and
    the shard's transport-lane halves (``lane/...`` keys).
  * ``KIND_SUBMIT`` — client rows journaled at ``submit()`` time, before
    the round that will consume them (requests are durable on
    acceptance; a crash cannot lose an op whose id was handed out).
  * ``KIND_COMMAND`` — a balancer command (split/move/merge) queued
    host-side into the shard's BgTable between rounds. These bypass the
    inbox, so without a record of their own replay would never re-queue
    them and the bg phases would diverge from the journaled run. The
    record's round is the round the command will first be visible to
    (``round_no`` between steps is the next round), so stream order
    reproduces exactly when the live run queued it.
"""
from __future__ import annotations

import io
import os
import struct
import time
import zlib
from typing import Dict, Iterator, List

import numpy as np

MAGIC = b"DWAL"
_HEADER = struct.Struct("<4sII")     # magic, payload length, crc32

KIND_ROUND = 0
KIND_SUBMIT = 1
KIND_COMMAND = 2

# KIND_COMMAND verbs (the ``cmd`` scalar)
CMD_SPLIT = 0
CMD_MOVE = 1
CMD_MERGE = 2
CMD_REPLICATE = 3       # host replicate(entry_keymax, target) — §15;
                        # replays against ShardState.rep, not the BgTable
CMD_DROP_REPLICA = 4    # host drop_replica(entry_keymax, target)


def _encode(record: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **record)
    payload = buf.getvalue()
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def _decode(payload: bytes) -> Dict[str, np.ndarray]:
    data = np.load(io.BytesIO(payload))
    return {k: data[k] for k in data.files}


class WriteAheadLog:
    """Append-only record log for one shard (see module docstring)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")
        self.fsyncs = 0
        # observables of the write path: framed bytes appended, and the
        # host seconds spent in flush + fsync
        self.bytes_written = 0
        self.fsync_seconds = 0.0

    # ---------------------------------------------------------------- write
    def append(self, record: Dict[str, np.ndarray],
               sync: bool = True) -> None:
        """Append a record; with ``sync`` (the default) it is flushed and
        fsync'd before returning. ``sync=False`` leaves the record in the
        OS buffer for a later ``sync()`` — the group-commit path
        (``DurabilityConfig.group_commit_rounds``): durability of the
        batched records is deferred to the batch boundary, where the
        fsync-before-ack discipline is re-established."""
        blob = _encode(record)
        self._fh.write(blob)
        self.bytes_written += len(blob)
        if sync:
            self.sync()

    def sync(self) -> None:
        """Flush + fsync everything appended so far (a group-commit
        barrier)."""
        t0 = time.perf_counter()
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self.fsync_seconds += time.perf_counter() - t0
        self.fsyncs += 1

    # ----------------------------------------------------------------- read
    def records(self) -> Iterator[Dict[str, np.ndarray]]:
        """All intact records, oldest first; stops at the first torn or
        corrupt frame (the tail a mid-append crash may leave)."""
        self._fh.flush()
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as fh:
            while True:
                head = fh.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return
                magic, length, crc = _HEADER.unpack(head)
                if magic != MAGIC:
                    return
                payload = fh.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                yield _decode(payload)

    # ------------------------------------------------------------- truncate
    def truncate_upto(self, round_no: int) -> int:
        """Drop every record with ``round <= round_no`` (covered by a
        snapshot). Atomic: rewrite to tmp, fsync, rename. Returns the
        number of records kept."""
        keep: List[bytes] = []
        for rec in self.records():
            if int(rec["round"]) > round_no:
                keep.append(_encode(rec))
        self._fh.close()
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            for blob in keep:
                fh.write(blob)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        return len(keep)

    def close(self) -> None:
        self._fh.close()
