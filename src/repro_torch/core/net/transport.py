"""Reliable transport: exactly-once, in-order delivery over a lossy wire.

The DiLi protocol (handlers, replay pre-passes, pacing budgets) is built
on a reliable-FIFO-per-(src,dst) channel contract. This module *provides*
that contract over a wire that may drop, duplicate, reorder and delay
frames (the nemesis), so at-least-once delivery with duplicates collapses
to exactly-once *effects*:

  * **Sender** — every (src, dst) lane stamps frames with a monotone
    sequence number (``F_SEQ``), retains unacked frames in a bounded
    retransmit ring, and re-ships frames whose last transmission is older
    than ``retransmit_after`` rounds.
  * **Receiver** — per lane, a cumulative cursor (all seqs ``<= cursor``
    delivered) plus an out-of-order dedup window. A frame at or below the
    cursor, or already buffered, is a duplicate and is dropped; anything
    newer is buffered and the *contiguous prefix* above the cursor is
    released — so handlers see each frame exactly once, in send order,
    no matter what the wire did.
  * **Acks** — receivers emit cumulative ``MSG_NET_ACK`` frames (one per
    lane per round with traffic, re-emitted on duplicate arrival so a
    lost ack heals). Acks are unsequenced — cumulative and idempotent —
    and ride the same lossy wire.

A wire frame is ``(src, dst, row)``: the lane identity travels out-of-band
of the int32 row because ``F_SRC`` is protocol metadata (for ``MSG_OP`` it
names the *reply* shard, not the emitter). ``F_SEQ`` is stamped into the
row itself so delivered rows are self-describing in dumps.

Loopback (src == dst) frames bypass the transport: a shard's self-retry
is machine-local memory, not a network link.

The transport is host-side ``numpy``, carried over from the reference
unchanged: the simulator interposes it in ``Cluster.step`` routing, so a
run draws and delivers exactly as the reference's does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import messages as M
from .nemesis import Frame, Nemesis


class TransportOverflow(RuntimeError):
    """A lane's unacked retransmit ring exceeded ``window`` frames.

    Raised loudly (like ``sim.OutboxOverflow``) instead of dropping the
    oldest frame: a silently un-retransmittable frame is a protocol
    message that will never arrive, which deadlocks quiescence. Fix:
    raise ``window``, lower the fault rates, or pace the feed.
    """


class _Lane:
    """Sender + receiver state for one directed (src, dst) pair."""

    __slots__ = ("next_seq", "unacked", "last_ship", "acked",
                 "cursor", "pending", "ack_due")

    def __init__(self):
        # sender side
        self.next_seq = 1
        self.unacked: Dict[int, np.ndarray] = {}    # seq -> stamped row
        self.last_ship: Dict[int, int] = {}         # seq -> round shipped
        self.acked = 0                              # highest cumulative ack
        # receiver side
        self.cursor = 0                             # delivered prefix
        self.pending: Dict[int, np.ndarray] = {}    # ooo dedup window
        self.ack_due = False                        # emit cumulative ack


class Transport:
    """One cluster-wide reliable transport instance (see module docstring).

    ``ship_round`` returns per-destination row batches in a deterministic
    order (lanes ascending by source, each lane's released contiguous
    prefix in sequence order) — any deterministic inter-lane interleave
    is legal; pair-FIFO is what the protocol needs.
    """

    def __init__(self, num_shards: int, nemesis: Optional[Nemesis] = None,
                 *, retransmit_after: int = 4, window: int = 4096):
        self.n = int(num_shards)
        self.nemesis = nemesis
        self.retransmit_after = max(1, int(retransmit_after))
        self.window = int(window)
        self._lanes: Dict[Tuple[int, int], _Lane] = {}
        self._staged: List[Frame] = []      # fresh frames this round
        self.down: set = set()              # crashed shards (DESIGN.md §14)
        self.stats = {"sent": 0, "retransmits": 0, "acks": 0,
                      "dup_dropped": 0, "delivered": 0, "down_dropped": 0}

    def _lane(self, src: int, dst: int) -> _Lane:
        key = (src, dst)
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _Lane()
        return lane

    # ---------------------------------------------------------------- send
    def send(self, src: int, rows: np.ndarray) -> List[np.ndarray]:
        """Stage one shard's outbox rows for this round's wire.

        ``src`` is the *emitting* shard (the lane identity); rows keep
        whatever ``F_SRC`` the protocol wrote. Returns loopback rows
        (dst == src) for the caller to deliver directly — they never
        touch the wire.
        """
        loopback: List[np.ndarray] = []
        for row in np.asarray(rows, np.int32):
            dst = int(row[M.F_DST])
            if dst == src:
                loopback.append(row.copy())
                continue
            lane = self._lane(src, dst)
            if len(lane.unacked) >= self.window:
                raise TransportOverflow(
                    f"lane ({src}->{dst}) has {len(lane.unacked)} unacked "
                    f"frames (window={self.window}): the wire is losing "
                    f"more than retransmission can absorb")
            stamped = row.copy()
            stamped[M.F_SEQ] = lane.next_seq
            lane.unacked[lane.next_seq] = stamped
            lane.next_seq += 1
            self._staged.append((src, dst, stamped))
            self.stats["sent"] += 1
        return loopback

    # ---------------------------------------------------------------- ship
    def ship_round(self, round_no: int) -> List[np.ndarray]:
        """Route one round: fresh frames + due retransmissions + acks go
        through the nemesis; survivors are acked and deduped per lane.
        Returns ``deliveries`` — ``deliveries[dst]`` is a [K, FIELDS]
        array of rows released to shard ``dst``, in order."""
        wire: List[Frame] = []
        for src, dst, row in self._staged:
            self._lane(src, dst).last_ship[int(row[M.F_SEQ])] = round_no
            wire.append((src, dst, row))
        self._staged = []
        # due retransmissions (shipped but never cumulatively acked); a
        # down sender can't retransmit and a down receiver is pointless
        # to ship at — skipping WITHOUT touching last_ship leaves the
        # frame immediately due once the shard restarts
        for (src, dst), lane in sorted(self._lanes.items()):
            if src in self.down or dst in self.down:
                continue
            for seq in sorted(lane.unacked):
                shipped = lane.last_ship.get(seq)
                if shipped is not None and \
                        round_no - shipped >= self.retransmit_after:
                    lane.last_ship[seq] = round_no
                    wire.append((src, dst, lane.unacked[seq]))
                    self.stats["retransmits"] += 1
        # cumulative acks for lanes with (re)arrivals; an ack for lane
        # (src, dst) travels the reverse link (dst, src). A dead process
        # emits nothing — its ack_due flags freeze until recovery
        # restores the receiver halves from the durable lane image.
        for (src, dst), lane in sorted(self._lanes.items()):
            if lane.ack_due and dst not in self.down:
                lane.ack_due = False
                ack = np.zeros((M.FIELDS,), np.int32)
                ack[M.F_KIND] = M.MSG_NET_ACK
                ack[M.F_DST] = src
                ack[M.F_SRC] = dst
                ack[M.F_A] = lane.cursor
                wire.append((dst, src, ack))
                self.stats["acks"] += 1

        if self.nemesis is not None:
            wire = self.nemesis.perturb(wire, round_no)

        # receive: ack processing + per-lane dedup/buffer. Frames whose
        # recipient is down hit a dead NIC — dropped here (not earlier)
        # so nemesis-held frames released mid-outage die the same way
        # fresh ones do; the sender's retransmit ring re-ships them
        # after the restart.
        touched = set()
        for src, dst, row in wire:
            if dst in self.down:
                self.stats["down_dropped"] += 1
                continue
            if int(row[M.F_KIND]) == M.MSG_NET_ACK:
                lane = self._lane(dst, src)     # the lane being acked
                cum = int(row[M.F_A])
                if cum > lane.acked:
                    lane.acked = cum
                    for seq in [q for q in lane.unacked if q <= cum]:
                        del lane.unacked[seq]
                        lane.last_ship.pop(seq, None)
                continue
            lane = self._lane(src, dst)
            seq = int(row[M.F_SEQ])
            lane.ack_due = True                 # re-ack even duplicates
            if seq <= lane.cursor or seq in lane.pending:
                self.stats["dup_dropped"] += 1
                continue
            lane.pending[seq] = row.copy()
            touched.add((src, dst))

        # release each touched lane's contiguous prefix, lanes in
        # deterministic (src asc) order per destination
        deliveries: List[List[np.ndarray]] = [[] for _ in range(self.n)]
        for (src, dst) in sorted(touched):
            lane = self._lane(src, dst)
            while lane.cursor + 1 in lane.pending:
                lane.cursor += 1
                deliveries[dst].append(lane.pending.pop(lane.cursor))
                self.stats["delivered"] += 1
        return [np.stack(rows).astype(np.int32) if rows
                else np.zeros((0, M.FIELDS), np.int32)
                for rows in deliveries]

    # --------------------------------------------------------------- route
    def route_round(self, backlogs: List[np.ndarray],
                    per_src_rows, round_no: int) -> None:
        """Route one round's outbox rows into per-destination host
        backlogs: loopback rows go straight to their own backlog, the
        rest cross the wire (send + ship + deliver). One home for the
        routing sequence, called by ``Cluster.step``.

        ``per_src_rows``: iterable of (src shard, [K, FIELDS] rows).
        ``backlogs`` is mutated in place.
        """
        for s, rows in per_src_rows:
            loop = self.send(s, rows)
            if loop:
                backlogs[s] = np.concatenate(
                    [backlogs[s], np.stack(loop)], axis=0)
        for d, rows in enumerate(self.ship_round(round_no)):
            if rows.size:
                backlogs[d] = np.concatenate([backlogs[d], rows], axis=0)

    # --------------------------------------------------- membership (§13)
    def shard_idle(self, shard: int) -> bool:
        """No frame anywhere in the system references a lane touching
        ``shard``: nothing staged, unacked, buffered out-of-order, owing
        an ack, or held by the nemesis' delay stage. This is the
        precondition for ``reset_shard`` — resetting a lane while any old
        frame survives would let a stale sequence number alias into the
        fresh lane's numbering (a delayed duplicate of old seq 5 would sit
        in the new lane's dedup window and eventually be *delivered* into
        the new stream)."""
        shard = int(shard)
        if any(s == shard or d == shard for s, d, _ in self._staged):
            return False
        for (src, dst), lane in self._lanes.items():
            if src != shard and dst != shard:
                continue
            if lane.unacked or lane.pending or lane.ack_due:
                return False
        if self.nemesis is not None and self.nemesis.held_touching(shard):
            return False
        return True

    def reset_shard(self, shard: int) -> None:
        """Drop every lane touching ``shard`` — the re-handshake across a
        membership epoch bump (DESIGN.md §13). A later send lazily
        allocates a fresh lane starting at seq 1 / cursor 0, so a slot
        reused by a future ``join_shard`` starts with clean channels.
        Refuses (loudly) while any such lane is non-idle: see
        ``shard_idle`` for why a hot reset would break exactly-once."""
        if not self.shard_idle(shard):
            raise RuntimeError(
                f"reset_shard({shard}): lanes touching the shard still "
                f"have frames in flight — retire must drain first")
        for key in [k for k in self._lanes
                    if k[0] == shard or k[1] == shard]:
            del self._lanes[key]

    # ------------------------------------------------- crash-restart (§14)
    # A crashed shard's halves of its lanes — sender rings on (s, *),
    # receiver cursors on (*, s) — are process memory and die with it.
    # They are journaled per round into the WAL as a flat str -> ndarray
    # image and reinstalled at restart; the surviving peers' halves of
    # the same lane objects are never touched. Frames the dead shard had
    # sent but nobody acked are still in the restored ring and retransmit
    # immediately; frames peers sent it while it was down were never
    # delivered (down-NIC drop above) and retransmit once it returns —
    # exactly-once holds across the reboot without a lane reset.

    def crash_shard(self, shard: int) -> None:
        """Mark ``shard``'s process dead: it ships nothing, acks nothing,
        and every frame addressed to it hits a dead NIC. Lane objects are
        left in place — the volatile halves are overwritten at restart."""
        self.down.add(int(shard))

    def export_shard_lanes(self, shard: int) -> Dict[str, np.ndarray]:
        """Snapshot the halves of every lane that live in ``shard``'s
        process memory, as a flat npz-able dict (the WAL lane image)."""
        shard = int(shard)
        img: Dict[str, np.ndarray] = {}
        for (src, dst), lane in sorted(self._lanes.items()):
            if src == shard:                      # sender half of (s, p)
                seqs = sorted(lane.unacked)
                img[f"send/{dst}/next_seq"] = np.int64(lane.next_seq)
                img[f"send/{dst}/acked"] = np.int64(lane.acked)
                img[f"send/{dst}/seqs"] = np.asarray(seqs, np.int64)
                img[f"send/{dst}/rows"] = (
                    np.stack([lane.unacked[q] for q in seqs])
                    if seqs else np.zeros((0, M.FIELDS), np.int32))
            if dst == shard:                      # receiver half of (p, s)
                seqs = sorted(lane.pending)
                img[f"recv/{src}/cursor"] = np.int64(lane.cursor)
                img[f"recv/{src}/ack_due"] = np.int64(int(lane.ack_due))
                img[f"recv/{src}/seqs"] = np.asarray(seqs, np.int64)
                img[f"recv/{src}/rows"] = (
                    np.stack([lane.pending[q] for q in seqs])
                    if seqs else np.zeros((0, M.FIELDS), np.int32))
        return img

    def restart_shard(self, shard: int,
                      image: Dict[str, np.ndarray]) -> None:
        """Reinstall ``shard``'s lane halves from a durable image and
        bring its NIC back up. Halves not present in the image (a peer
        opened the lane while the shard was down) reset to the fresh
        handshake state, which is what the restarted process remembers."""
        shard = int(shard)
        long_ago = -(1 << 30)   # restored unacked frames: due immediately
        for (src, dst), lane in self._lanes.items():
            if src == shard:
                lane.next_seq, lane.acked = 1, 0
                lane.unacked, lane.last_ship = {}, {}
            if dst == shard:
                lane.cursor, lane.pending, lane.ack_due = 0, {}, False
        peers = {key.split("/")[1] for key in image}
        for p in sorted(int(x) for x in peers):
            if f"send/{p}/next_seq" in image:
                lane = self._lane(shard, p)
                lane.next_seq = int(image[f"send/{p}/next_seq"])
                lane.acked = int(image[f"send/{p}/acked"])
                seqs = image[f"send/{p}/seqs"]
                rows = image[f"send/{p}/rows"]
                lane.unacked = {int(q): np.asarray(r, np.int32).copy()
                                for q, r in zip(seqs, rows)}
                lane.last_ship = {int(q): long_ago for q in seqs}
            if f"recv/{p}/cursor" in image:
                lane = self._lane(p, shard)
                lane.cursor = int(image[f"recv/{p}/cursor"])
                lane.ack_due = bool(int(image[f"recv/{p}/ack_due"]))
                seqs = image[f"recv/{p}/seqs"]
                rows = image[f"recv/{p}/rows"]
                lane.pending = {int(q): np.asarray(r, np.int32).copy()
                                for q, r in zip(seqs, rows)}
        self.down.discard(shard)

    # --------------------------------------------------------------- state
    def in_flight(self) -> int:
        """Frames whose delivery is not yet certain to be settled:
        unacked (possibly lost; will retransmit), buffered out-of-order,
        staged this round, or held by the nemesis' delay stage."""
        total = len(self._staged) + sum(
            len(l.unacked) + len(l.pending) for l in self._lanes.values())
        if self.nemesis is not None:
            total += self.nemesis.in_flight()
        return total

    def idle(self) -> bool:
        return self.in_flight() == 0
