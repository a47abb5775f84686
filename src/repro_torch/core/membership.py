"""Elastic shard membership: the epoch-stamped host-side view (DESIGN.md §13).

``cfg.num_shards`` stays what it always was — the jit-static *capacity* of
the cluster (mesh size, mailbox sizing, broadcast loop bounds). What varies
at runtime is which of those capacity slots are *members*, tracked here as
a per-shard lifecycle:

    RETIRED --begin_join--> JOINING --promote--> ACTIVE
    ACTIVE/JOINING --begin_drain--> DRAINING --finish_drain--> RETIRED
    ACTIVE/JOINING/DRAINING --crash--> CRASHED --restart--> JOINING

  * **active** — owns sublists, receives client ops, counts in balancer
    load means, and is a valid move target.
  * **joining** — participates in rounds and is a valid move target (the
    balancer drains sublists onto it), but clients do not route fresh ops
    to it until it owns something; promoted to active by the host once it
    owns its first sublist.
  * **draining** — still owns and executes (ops delegated to it must land
    somewhere), but the balancer force-evacuates everything it owns and
    never targets it with new moves.
  * **retired** — owns nothing, receives no client ops, excluded from the
    registry-broadcast fan-out (its replica goes stale, which is *safe* —
    the registry is lazily replicated by design). Its transport lanes are
    reset (re-handshaken) at the moment it leaves.
  * **crashed** — the process died mid-run (kill -9); unlike draining it
    still *owns* its sublists on durable storage, but it executes nothing
    and is excluded from routing, broadcast fan-out, and move targeting
    until recovery restarts it. Crash ≠ drain: a crashed shard re-enters
    as JOINING-with-state (it already owns entries, so host maintenance
    promotes it immediately), and carve-out / delegation healing repairs
    whatever restructured while it was down (DESIGN.md §14).

Every transition bumps ``epoch``. The on-device witness of the view is the
``(epoch, peers)`` pair in ``ShardState``, merged monotonically by the
``MSG_EPOCH`` handler — so broadcast fan-out loops can gate on the peer
bitmask without dynamic shapes, and a partitioned shard simply acts on a
stale-but-safe view until the transport heals.

The class is pure host-side bookkeeping: it queues no messages and reads
no device state. ``Cluster``/``ShardMapBackend`` own the actuation
(broadcasting MSG_EPOCH, checking drain completion, resetting lanes).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import messages as M

JOINING = "joining"
ACTIVE = "active"
DRAINING = "draining"
RETIRED = "retired"
CRASHED = "crashed"

# peers bitmask lives in one int32 message lane / ShardState scalar
MASK_BITS = 31


def live_mask(members: Sequence[int], capacity: int) -> int:
    """int32 bitmask with bit ``s`` set for every live (non-retired) shard.

    A full mask at capacity >= MASK_BITS is representable as -1 (all bits
    set; arithmetic right-shift keeps every probe true) — partial
    membership at that scale is rejected by ``Membership`` itself.
    """
    members = sorted(set(int(s) for s in members))
    if capacity >= MASK_BITS:
        if len(members) != capacity:
            raise ValueError(
                f"elastic membership needs capacity < {MASK_BITS} "
                f"(peer bitmask is one int32 lane), got {capacity}")
        return -1
    m = 0
    for s in members:
        m |= 1 << s
    return m


class Membership:
    """Epoch-stamped membership over a fixed capacity of shard slots."""

    def __init__(self, capacity: int, initial: Optional[int] = None):
        self.capacity = int(capacity)
        if self.capacity > MASK_BITS:
            # bit ``s`` of the int32 live_mask must exist for every slot;
            # widening past 31 needs a multi-lane mask (ROADMAP follow-on).
            raise ValueError(
                f"num_shards={self.capacity} exceeds the {MASK_BITS}-slot "
                f"int32 peer-bitmask bound; widen the mask before scaling "
                f"capacity past {MASK_BITS}")
        initial = self.capacity if initial is None else int(initial)
        if not 1 <= initial <= self.capacity:
            raise ValueError(
                f"initial_shards={initial} out of range 1..{self.capacity}")
        if initial != self.capacity and self.capacity >= MASK_BITS:
            raise ValueError(
                f"elastic membership needs capacity < {MASK_BITS} "
                f"(peer bitmask is one int32 lane), got {self.capacity}")
        self.epoch = 0
        self._state: List[str] = ([ACTIVE] * initial
                                  + [RETIRED] * (self.capacity - initial))
        # (epoch, event, shard) — the membership half of the replay witness
        self.log: List[Tuple[int, str, int]] = []

    # -------------------------------------------------------------- queries
    def _by_state(self, which: str) -> Tuple[int, ...]:
        return tuple(s for s in range(self.capacity)
                     if self._state[s] == which)

    @property
    def active(self) -> Tuple[int, ...]:
        return self._by_state(ACTIVE)

    @property
    def joining(self) -> Tuple[int, ...]:
        return self._by_state(JOINING)

    @property
    def draining(self) -> Tuple[int, ...]:
        return self._by_state(DRAINING)

    @property
    def retired(self) -> Tuple[int, ...]:
        return self._by_state(RETIRED)

    @property
    def crashed(self) -> Tuple[int, ...]:
        return self._by_state(CRASHED)

    @property
    def routable(self) -> Tuple[int, ...]:
        """Shards that may own sublists / execute ops right now."""
        return tuple(s for s in range(self.capacity)
                     if self._state[s] not in (RETIRED, CRASHED))

    @property
    def targets(self) -> Tuple[int, ...]:
        """Valid destinations for new Moves (active + joining)."""
        return tuple(s for s in range(self.capacity)
                     if self._state[s] in (ACTIVE, JOINING))

    def state_of(self, shard: int) -> str:
        return self._state[shard]

    def is_routable(self, shard: int) -> bool:
        return (0 <= shard < self.capacity
                and self._state[shard] not in (RETIRED, CRASHED))

    def is_active(self, shard: int) -> bool:
        return 0 <= shard < self.capacity and self._state[shard] == ACTIVE

    def mask(self) -> int:
        """Live-peer bitmask (what MSG_EPOCH carries in F_X1)."""
        return live_mask(self.routable, self.capacity)

    def view(self) -> Dict[str, object]:
        """Serializable snapshot (trace / repro artifacts)."""
        return {"epoch": self.epoch, "active": list(self.active),
                "joining": list(self.joining),
                "draining": list(self.draining),
                "retired": list(self.retired)}

    # ---------------------------------------------------------- transitions
    def _bump(self, event: str, shard: int) -> None:
        self.epoch += 1
        self.log.append((self.epoch, event, shard))

    def begin_join(self, shard: Optional[int] = None) -> int:
        """RETIRED -> JOINING. Picks the lowest retired slot when ``shard``
        is None; the new member enters empty."""
        if self.capacity >= MASK_BITS:
            raise ValueError(
                f"elastic membership needs capacity < {MASK_BITS}")
        if shard is None:
            retired = self.retired
            if not retired:
                raise ValueError("no retired shard slot available to join")
            shard = retired[0]
        shard = int(shard)
        if self._state[shard] != RETIRED:
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot join")
        self._state[shard] = JOINING
        self._bump("join", shard)
        return shard

    def promote(self, shard: int) -> None:
        """JOINING -> ACTIVE (host-driven, once the shard owns a sublist)."""
        shard = int(shard)
        if self._state[shard] != JOINING:
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot promote")
        self._state[shard] = ACTIVE
        self._bump("promote", shard)

    def begin_drain(self, shard: int) -> None:
        """ACTIVE/JOINING -> DRAINING. Refuses to drain the last member
        that could own data — someone must absorb the evacuation."""
        shard = int(shard)
        if self._state[shard] not in (ACTIVE, JOINING):
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot drain")
        others = [s for s in self.targets if s != shard]
        if not others:
            raise ValueError(
                f"cannot drain shard {shard}: no other active/joining "
                f"shard to evacuate onto")
        self._state[shard] = DRAINING
        self._bump("drain", shard)

    def finish_drain(self, shard: int) -> None:
        """DRAINING -> RETIRED (host-driven, once drain is provably
        complete — see Cluster._drain_complete for the gate)."""
        shard = int(shard)
        if self._state[shard] != DRAINING:
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot retire")
        self._state[shard] = RETIRED
        self._bump("retire", shard)

    def crash(self, shard: int) -> None:
        """ACTIVE/JOINING/DRAINING -> CRASHED (kill -9 at a round boundary).

        Unlike ``begin_drain`` this never refuses — a crash is not a
        request. A draining shard that crashes forgets the drain intent;
        after restart it re-enters as JOINING like any other survivor.
        """
        if self.capacity >= MASK_BITS:
            raise ValueError(
                f"crash-restart needs capacity < {MASK_BITS} "
                f"(partial membership is not representable at {MASK_BITS}+)")
        shard = int(shard)
        if self._state[shard] not in (ACTIVE, JOINING, DRAINING):
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot crash")
        self._state[shard] = CRASHED
        self._bump("crash", shard)

    def restart(self, shard: int) -> None:
        """CRASHED -> JOINING (recovery installed snapshot+WAL state).

        The restarted shard is JOINING-*with-state*: it still owns its
        pre-crash sublists, so the regular host maintenance pass promotes
        it back to ACTIVE on the next round it owns an entry."""
        shard = int(shard)
        if self._state[shard] != CRASHED:
            raise ValueError(
                f"shard {shard} is {self._state[shard]}, cannot restart")
        self._state[shard] = JOINING
        self._bump("restart", shard)


# ------------------------------------------------------- actuation helpers
# Shared by Cluster and ShardMapBackend so the two backends' membership
# mechanics cannot drift.

def epoch_row(dst: int, src: int, epoch: int, mask: int) -> np.ndarray:
    """One MSG_EPOCH announcement row: F_KEY carries the epoch, F_X1 the
    live-peer bitmask. The handler merges monotonically (max on epoch), so
    duplicated or reordered deliveries are idempotent."""
    row = np.zeros((M.FIELDS,), np.int32)
    row[M.F_KIND] = M.MSG_EPOCH
    row[M.F_DST] = dst
    row[M.F_SRC] = src
    row[M.F_KEY] = epoch
    row[M.F_X1] = mask
    return row


def epoch_broadcast(membership: Membership) -> List[np.ndarray]:
    """Announcement rows for every capacity slot (retired shards included —
    they keep their epoch register current for a later rejoin), emitted
    from a deterministic coordinator (the lowest active shard)."""
    src = min(membership.active)
    return [epoch_row(dst, src, membership.epoch, membership.mask())
            for dst in range(membership.capacity)]


def owned_entry_count(cfg, states, s: int) -> int:
    """Non-switched registry entries shard ``s``'s own replica says it
    owns — the ownership witness for promote/finish_drain decisions."""
    from .sim import state_sublists
    return sum(1 for e in state_sublists(cfg, states, s)
               if e["owner"] == s and not e["switched"])


def moves_targeting(bgs, s: int) -> int:
    """In-flight Moves (any source shard) whose target is ``s`` and whose
    registry transfer has not landed — retiring ``s`` under one would
    strand the sublist mid-copy."""
    from . import bg as B
    return sum(1 for bg in bgs for _, tgt in B.active_moves(bg)
               if tgt == s)
