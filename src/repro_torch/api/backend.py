"""Execution backends behind ``DiLiClient`` (DESIGN.md §9).

A backend is one round-based execution engine for the DiLi protocol. The
client is backend-agnostic: the same workload runs unchanged against the
single-host simulator (``LocalBackend`` wrapping ``core.sim.Cluster``) or
the SPMD round (``ShardMapBackend`` wrapping
``core.distributed.make_dili_round``). The contract is the ``Backend``
protocol: ``submit`` enqueues ops and returns ids, ``step`` runs one
round and returns ``(op_id, result, src_shard)`` completions (recycling
their ids), ``quiescent`` says no message or background op is in flight,
and the balance surface (``sublists``/``middle_item``/``split``/``move``/
``merge`` plus ``states``/``bgs``/``cfg``/``n``) is the duck type
``core.balancer`` drives. With ``nemesis=`` either backend routes through
the reliable transport, with ``durability=`` it journals to a WAL (and
``CrashPlan``s recover from it), and ``join_shard``/``retire_shard``
change membership under traffic.

``ShardMapBackend(cfg)`` holds each shard on a device of its own, as the
reference's ``shard_map`` mesh places them (``device="cuda"`` by default:
shard ``s`` on ``cuda:{s % device_count}``; ``devices=`` lists them one
per shard; ``device="cpu"`` on a machine without a card), and routes with
the Local exchange, which copies each bucket to its destination's device.
One rank per shard over a process group is ``make_dili_round(cfg,
cap_pair, group=...)`` itself.
"""
from __future__ import annotations

import logging
import tempfile
from collections import deque
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from .. import timing
from ..core import bg as B
from ..core import messages as M
from ..core import range_scan as RS
from ..core import refs
from ..core import replica as R
from ..core.distributed import (gather_host, make_dili_round,
                                make_dili_round_hostroute, placement)
from ..core.durability import Durability, validate_crash_plans, wal
from ..core.host import to_cpu
from ..core.membership import (Membership, epoch_row, moves_targeting,
                               owned_entry_count)
from ..core.net import Nemesis, Transport, trace_entry
from ..core.sim import (Cluster, OpIdAllocator, OutboxOverflow, chain_keys,
                        global_keys, make_op_row, materialize_ops,
                        registry_entries, state_sublists)
from ..core.types import (DiLiConfig, KEY_MAX, KEY_MIN, SH_KEY, ST_KEY,
                          init_shard, on_device, tree_map)

_log = logging.getLogger(__name__)

Completion = Tuple[int, int, int]           # (op_id, result, src_shard)
RegEntry = Tuple[int, int, int]             # (keymin, keymax, owner)


class Backend(Protocol):
    """Round-based DiLi execution engine (see the module docstring)."""

    cfg: DiLiConfig
    stats: Dict[str, int]

    @property
    def n(self) -> int: ...

    def submit(self, shard: int, kinds: Sequence[int], keys: Sequence[int],
               values: Optional[Sequence[int]] = None) -> List[int]: ...

    # RANGE scans (DESIGN.md §16): completion carries the item *count*
    # (or a negative RES_* error); the (key, value) pairs are fetched
    # once with ``take_range_items`` after the op completes.
    def submit_range(self, shard: int, lo: int, hi: int,
                     limit: int) -> int: ...

    def take_range_items(self, op_id: int) -> List[Tuple[int, int]]: ...

    def step(self) -> List[Completion]: ...

    def quiescent(self) -> bool: ...

    def registry_entries(self, shard: int = 0) -> List[RegEntry]: ...

    # ------------------------------------------------------ balance surface
    def sublists(self, s: int) -> List[dict]: ...

    def middle_item(self, s: int, head_idx: int) -> Optional[int]: ...

    # each returns True when a background slot accepted the command,
    # False when it was dropped (no idle slot / entry already claimed)
    def split(self, s: int, entry_keymax: int, sitem_idx: int) -> bool: ...

    def move(self, s: int, entry_keymax: int, target: int) -> bool: ...

    def merge(self, s: int, left_keymax: int, right_keymax: int) -> bool: ...

    # -------------------------------------------------- replication (§15)
    # op-rate load signal + hot-entry read replication; ``replica_epoch``
    # bumps whenever the replica map changes so clients know to re-pull
    # ``replica_sets()`` for FIND routing.
    def replicate(self, s: int, entry_keymax: int, target: int) -> bool: ...

    def drop_replica(self, s: int, entry_keymax: int,
                     target: int = -1) -> bool: ...

    def replica_sets(self) -> Dict[int, Tuple[int, int, List[int]]]: ...


class LocalBackend:
    """The single-host simulator as a client backend.

    Wraps ``core.sim.Cluster`` — which stays the execution machinery (round
    loop, host-side routing, overflow detection) while this class adapts it
    to the backend contract: per-step completion harvesting with executing
    shard, and op-id recycling via ``Cluster.take_result``.
    """

    def __init__(self, cfg: Optional[DiLiConfig] = None, *,
                 cluster: Optional[Cluster] = None, seed: int = 0,
                 delay_prob: float = 0.0, nemesis=None,
                 retransmit_after: int = 4, net_window: int = 4096,
                 key_lo: int = KEY_MIN, key_hi: int = KEY_MAX,
                 initial_shards: Optional[int] = None,
                 trace: Optional[bool] = None, durability=None,
                 device="cuda", timer=None):
        if cluster is None:
            if cfg is None:
                raise ValueError("LocalBackend needs a DiLiConfig or Cluster")
            cluster = Cluster(cfg, seed=seed, delay_prob=delay_prob,
                              nemesis=nemesis,
                              retransmit_after=retransmit_after,
                              net_window=net_window,
                              key_lo=key_lo, key_hi=key_hi,
                              initial_shards=initial_shards, trace=trace,
                              durability=durability, device=device,
                              timer=timer)
        self.cluster = cluster
        self.cfg = cluster.cfg
        self._issued: set = set()
        # RANGE ops issued through this backend; items are captured at
        # harvest time (``Cluster.take_result`` purges the cluster-side
        # parts, so they must be pulled *before* the id is recycled) and
        # held here until the caller fetches them.
        self._range_issued: set = set()
        self._range_items: Dict[int, List[Tuple[int, int]]] = {}

    # ------------------------------------------------------------- protocol
    @property
    def n(self) -> int:
        return self.cluster.n

    @property
    def stats(self) -> Dict[str, int]:
        return self.cluster.stats

    def submit(self, shard, kinds, keys, values=None) -> List[int]:
        ids = self.cluster.submit(shard, kinds, keys, values)
        self._issued.update(ids)
        return ids

    def submit_range(self, shard: int, lo: int, hi: int,
                     limit: int) -> int:
        op_id = self.cluster.submit_range(shard, lo, hi, limit)
        self._issued.add(op_id)
        self._range_issued.add(op_id)
        return op_id

    def take_range_items(self, op_id: int) -> List[Tuple[int, int]]:
        return self._range_items.pop(op_id)

    def step(self) -> List[Completion]:
        """One round; returns and recycles completions of ops issued
        *through this backend*. Ops submitted raw at the wrapped cluster
        keep their results in ``cluster.results`` untouched — draining
        them would orphan the raw caller's poll loop and let its live id
        be reissued to a client op. Harvesting goes through
        ``cluster.results`` (not ``last_completions``, which the next raw
        ``Cluster.step`` overwrites) so tools stepping the cluster
        directly between backend rounds cannot orphan client futures."""
        self.cluster.step()
        comps = []
        done = [op_id for op_id in self._issued
                if op_id in self.cluster.results]
        for op_id in done:
            src = self.cluster.result_src.get(op_id, -1)
            if op_id in self._range_issued:
                # pull the scan items before take_result purges them
                self._range_items[op_id] = \
                    self.cluster.take_range_items(op_id)
                self._range_issued.discard(op_id)
            val = self.cluster.take_result(op_id)   # pops + recycles the id
            self._issued.discard(op_id)
            comps.append((op_id, val, src))
        return comps

    @property
    def timer(self):
        """The cluster's span tracer (a ``timing.PhaseTimer``), or None."""
        return self.cluster.timer

    @property
    def net(self):
        """The reliable transport, or None when routing is direct."""
        return self.cluster.net

    @property
    def balancer_rng(self):
        """Balancer child stream of the run's root SeedSequence."""
        return self.cluster.balancer_rng

    # ------------------------------------------------- membership (§13)
    @property
    def membership(self) -> Membership:
        return self.cluster.membership

    def join_shard(self, shard: Optional[int] = None) -> int:
        return self.cluster.join_shard(shard)

    def retire_shard(self, shard: int) -> None:
        self.cluster.retire_shard(shard)

    def quiescent(self) -> bool:
        cl = self.cluster
        if cl.membership.crashed:
            return False        # keep stepping toward the scheduled restart
        if any(b.shape[0] for b in cl.backlog):
            return False
        if cl.net is not None and not cl.net.idle():
            return False
        return not any(B.any_active(bg) for bg in cl.bgs)

    def registry_entries(self, shard: int = 0) -> List[RegEntry]:
        return self.cluster.registry_entries(shard)

    # ------------------------------------------------------ balance surface
    @property
    def states(self):
        return self.cluster.states

    @property
    def bgs(self):
        return self.cluster.bgs

    def sublists(self, s: int):
        return self.cluster.sublists(s)

    def middle_item(self, s: int, head_idx: int) -> Optional[int]:
        return self.cluster.middle_item(s, head_idx)

    def split(self, s, entry_keymax, sitem_idx) -> bool:
        return self.cluster.split(s, entry_keymax, sitem_idx)

    def move(self, s, entry_keymax, target) -> bool:
        return self.cluster.move(s, entry_keymax, target)

    def merge(self, s, left_keymax, right_keymax) -> bool:
        return self.cluster.merge(s, left_keymax, right_keymax)

    # -------------------------------------------------- replication (§15)
    @property
    def op_rate_ewma(self):
        return self.cluster.op_rate_ewma

    @property
    def rep_rate_ewma(self):
        return self.cluster.rep_rate_ewma

    @property
    def replica_epoch(self) -> int:
        return self.cluster.replica_epoch

    def replicate(self, s, entry_keymax, target) -> bool:
        return self.cluster.replicate(s, entry_keymax, target)

    def drop_replica(self, s, entry_keymax, target=-1) -> bool:
        return self.cluster.drop_replica(s, entry_keymax, target)

    def replica_sets(self):
        return self.cluster.replica_sets()

    # ------------------------------------------------------------ debugging
    def all_keys(self) -> List[int]:
        return self.cluster.all_keys()

    def shard_chain(self, s, head_idx, include_meta=False):
        return self.cluster.shard_chain(s, head_idx, include_meta)


def _host_tree(tree):
    """Every leaf of a tree on the host, one copy each."""
    return tree_map(to_cpu, tree)


def _to(tree, dev: torch.device):
    """``tree`` with every leaf on ``dev`` (no copy for a leaf already
    there)."""
    return tree_map(lambda x: x.to(dev), tree)


class ShardMapBackend:
    """The SPMD round as a client backend.

    Shard ``s``'s state, background table and routed inbox lie on
    ``placement[s]`` (``core.distributed.placement`` of ``device`` and
    ``devices``); routing is the exchange inside ``make_dili_round``,
    which copies each bucket to its destination's device. The host side
    here only feeds client batches, harvests completions, and keeps the
    same overflow discipline as the simulator: ``cap_pair`` defaults to
    ``mailbox_cap`` so no per-destination bucket can drop a row without
    the (host-checked) total outbox count exceeding ``mailbox_cap``
    first, which raises ``OutboxOverflow`` exactly like ``Cluster.step``.

    With ``nemesis=`` the round skips its exchange and the host routes
    the raw outboxes through the reliable transport (the nemesis lives on
    the wire), with crash plans, the WAL and snapshots as in ``Cluster``.
    Membership epochs are announced through each slot's client feed, so
    the round traces differ from ``Cluster``'s (whose announcements ride
    the routed wire) and equal the reference ``ShardMapBackend``'s.

    The balance surface works on per-shard host snapshots of the state
    (pulled lazily, invalidated each round); Split/Move/Merge and the
    replication commands replace one shard's table or state and execute
    inside the next round like any other background phase. ``timer``, a
    ``timing.PhaseTimer`` (made with the placement, so that its spans wait
    for every card the shards use), gets ``Cluster``'s spans plus
    ``bucket`` and ``exchange``.
    """

    def __init__(self, cfg: DiLiConfig, *, cap_pair: Optional[int] = None,
                 seed: int = 0, nemesis=None, retransmit_after: int = 4,
                 net_window: int = 4096,
                 key_lo: int = KEY_MIN, key_hi: int = KEY_MAX,
                 initial_shards: Optional[int] = None,
                 durability=None, device="cuda", devices=None,
                 timer=None):
        self.cfg = cfg
        self.placement = placement(cfg, device, devices)
        _log.info("ShardMapBackend: %d shards on %s", cfg.num_shards,
                  [str(d) for d in self.placement])
        self.timer = timer
        self.cap_pair = int(cap_pair if cap_pair is not None
                            else cfg.mailbox_cap)
        if self.cap_pair < cfg.mailbox_cap:
            # with cap_pair < mailbox_cap a single destination's bucket can
            # drop rows while the total outbox stays under mailbox_cap —
            # the host-side overflow check would never fire, and a dropped
            # replicate/ack deadlocks the protocol silently
            raise ValueError(
                f"cap_pair={self.cap_pair} < mailbox_cap="
                f"{cfg.mailbox_cap}: per-destination buckets could drop "
                f"rows undetected")
        # borrow the simulator's init: bootstrap sublist on shard 0 plus
        # synchronized registry replicas everywhere else — and the
        # membership overlay, so both backends share one lifecycle engine
        boot = Cluster(cfg, seed=seed, key_lo=key_lo, key_hi=key_hi,
                       initial_shards=initial_shards,
                       device=self.placement[0])
        self.membership = boot.membership
        self._mb_logged = 0
        self._states = [_to(st, d) for st, d in zip(boot.states,
                                                    self.placement)]
        self._bgs = [_to(bg, d) for bg, d in zip(boot.bgs, self.placement)]
        # same child-stream layout as Cluster: (delay, nemesis, balancer)
        self.seed = seed
        root = np.random.SeedSequence(seed)
        _, nemesis_ss, balancer_ss = root.spawn(3)
        self.balancer_rng = np.random.default_rng(balancer_ss)
        self.nemesis_config = nemesis
        self.net: Optional[Transport] = None
        self.round_trace: List[str] = []
        if nemesis is not None:
            self.net = Transport(
                cfg.num_shards,
                Nemesis(nemesis, np.random.default_rng(nemesis_ss)),
                retransmit_after=retransmit_after, window=net_window)
            self._rnd = make_dili_round_hostroute(cfg, timer=timer,
                                                  placed=True)
            self.in_cap = max(cfg.mailbox_cap * cfg.num_shards,
                              cfg.batch_size * 2)
            self._net_backlog = [np.zeros((0, M.FIELDS), np.int32)
                                 for _ in range(cfg.num_shards)]
        else:
            self._rnd = make_dili_round(cfg, cap_pair=self.cap_pair,
                                        timer=timer, placed=True)
            self.in_cap = cfg.num_shards * self.cap_pair
            # each shard's routed inbox stays on its device between rounds
            self._inbox = [torch.zeros((self.in_cap, M.FIELDS),
                                       dtype=torch.int32, device=d)
                           for d in self.placement]
        self._inflight_msgs = 0
        self._queues: List[deque] = [deque() for _ in range(cfg.num_shards)]
        self._ids = OpIdAllocator()
        self._host_states: Optional[list] = None
        self.round_no = 0
        # durability + crash plans (DESIGN.md §14): same semantics as
        # Cluster — crashes ride the nemesis config (hostroute path), so
        # the transport's down-NIC model and the WAL see the same rounds
        self._crash_plans = tuple(nemesis.crashes) if nemesis else ()
        if self._crash_plans:
            validate_crash_plans(self._crash_plans, cfg.num_shards)
        self._tmp_durability = None
        if durability is None and self._crash_plans:
            self._tmp_durability = tempfile.TemporaryDirectory(
                prefix="dili-durability-")
            durability = self._tmp_durability.name
        self.durability: Optional[Durability] = None
        if durability is not None:
            self.durability = (durability if isinstance(durability,
                                                        Durability)
                               else Durability(durability, cfg))
            empty = np.zeros((0, M.FIELDS), np.int32)
            for s in range(cfg.num_shards):
                self.durability.ensure_genesis(
                    s, boot.states[s], boot.bgs[s], empty,
                    self.net.export_shard_lanes(s)
                    if self.net is not None else {})
        self.stats = {"max_outbox": 0, "max_hops": 0, "rounds": 0,
                      "fast_hits": 0, "mut_hits": 0, "delegated": 0,
                      "move_hits": 0, "blk_hits": 0, "max_bg_active": 0,
                      "rep_hits": 0, "range_hits": 0}
        # RANGE reassembly (DESIGN.md §16) — same count-gated protocol as
        # ``Cluster``: items and the terminal count ride separate
        # completion rows (and, across shards, separate transport lanes),
        # so publication waits until every journaled item arrived
        self._range_ops: set = set()
        self._range_parts: Dict[int, List[Tuple[int, int]]] = {}
        self._range_done: Dict[int, Tuple[int, int]] = {}
        self._range_items: Dict[int, List[Tuple[int, int]]] = {}
        # same load/replication host state as Cluster: the balancer and
        # client API read one surface off either backend
        self.op_rate_ewma: Dict[int, float] = {}
        self.rep_rate_ewma: Dict[int, float] = {}
        self._replica_map: Dict[int, Tuple[int, set]] = {}
        self.replica_epoch = 0

    # ------------------------------------------------------------- protocol
    @property
    def n(self) -> int:
        return self.cfg.num_shards

    def submit(self, shard, kinds, keys, values=None) -> List[int]:
        if not self.membership.is_routable(shard):
            raise ValueError(
                f"submit: shard {shard} is "
                f"{self.membership.state_of(shard)} at epoch "
                f"{self.membership.epoch} — route ops to one of "
                f"{self.membership.routable}")
        kinds, keys, values = materialize_ops(kinds, keys, values)
        ids = []
        for kind, key, val in zip(kinds, keys, values):
            slot = self._ids.alloc()
            self._queues[shard].append(make_op_row(shard, kind, key, val,
                                                   slot))
            ids.append(slot)
        return ids

    def submit_range(self, shard: int, lo: int, hi: int,
                     limit: int) -> int:
        """Enqueue one RANGE(lo, hi, limit) scan at ``shard`` (§16)."""
        if not self.cfg.range_scan:
            raise ValueError(
                "submit_range: cfg.range_scan is off — the RANGE pre-pass "
                "and serial walk are off in shard_round")
        if not self.membership.is_routable(shard):
            raise ValueError(
                f"submit_range: shard {shard} is "
                f"{self.membership.state_of(shard)} at epoch "
                f"{self.membership.epoch}")
        if lo < KEY_MIN or hi > KEY_MAX + 1 or limit < 1:
            raise ValueError(
                f"submit_range: span [{lo}, {hi}) limit={limit} outside "
                f"[{KEY_MIN}, {KEY_MAX + 1}) or non-positive limit")
        slot = self._ids.alloc()
        self._queues[shard].append(RS.make_range_row(shard, lo, hi,
                                                     limit, slot))
        self._range_ops.add(slot)
        self._range_parts[slot] = []
        # a recycled id must not inherit a prior scan's unfetched items
        self._range_items.pop(slot, None)
        return slot

    def take_range_items(self, op_id: int) -> List[Tuple[int, int]]:
        return self._range_items.pop(op_id)

    # ------------------------------------------------- membership (§13)
    def join_shard(self, shard: Optional[int] = None) -> int:
        """Admit a retired slot as a JOINING member. Its state keeps its
        capacity: the slot was stepping empty rounds all along."""
        s = self.membership.begin_join(shard)
        self._broadcast_epoch()
        return s

    def retire_shard(self, shard: int) -> None:
        """Begin draining ``shard``; the host retires it (and resets its
        transport lanes, when routing is host-side) once drain completion
        is provable. The round keeps stepping the empty slot."""
        self.membership.begin_drain(shard)
        self._broadcast_epoch()

    def _broadcast_epoch(self) -> None:
        """Announce the membership view by injecting one MSG_EPOCH row
        into every capacity slot's client feed. The host feeds each slot
        directly (the rows never cross the shard-to-shard wire), so a
        nemesis partition cannot block the announcement — shards behind a
        cut still act on a stale mask safely, as in the Cluster backend,
        for the data-path messages."""
        mb = self.membership
        for dst in range(mb.capacity):
            self._queues[dst].append(
                epoch_row(dst, dst, mb.epoch, mb.mask()))

    def _drain_complete(self, s: int) -> bool:
        """Backend-specific half of the retire gate (see
        ``Cluster._drain_complete`` for the invariant): on the hostroute
        path the transport's per-lane idleness is exact; on the device
        path the routed inbox is opaque, so the conservative witness is
        the routed-message total hitting zero."""
        bgs = self.bgs
        if owned_entry_count(self.cfg, self.states, s) != 0:
            return False
        if B.any_active(bgs[s]):
            return False
        if moves_targeting(bgs, s) != 0:
            return False
        if len(self._queues[s]):
            return False
        if self.net is not None:
            if self._net_backlog[s].shape[0]:
                return False
            if not self.net.shard_idle(s):
                return False
        elif self._inflight_msgs:
            return False
        return True

    def _membership_maintenance(self) -> None:
        """Host-driven lifecycle advance, once per round (the rules of
        ``Cluster._membership_maintenance``)."""
        mb = self.membership
        if not (mb.joining or mb.draining):
            return
        changed = False
        for s in mb.joining:
            if owned_entry_count(self.cfg, self.states, s) > 0:
                mb.promote(s)
                changed = True
        for s in mb.draining:
            if self._drain_complete(s):
                mb.finish_drain(s)
                if self.net is not None:
                    self.net.reset_shard(s)
                changed = True
        if changed:
            self._broadcast_epoch()

    def _feed_client(self, down=()) -> np.ndarray:
        cfg = self.cfg
        client = np.zeros((self.n, cfg.batch_size, M.FIELDS), np.int32)
        for s in range(self.n):
            if s in down:
                continue        # queue is client-side memory: it survives
            q = self._queues[s]
            for b in range(min(len(q), cfg.batch_size)):
                client[s, b] = q.popleft()
        return client

    # ------------------------------------------------- crash-restart (§14)
    def _set_shard(self, s: int, state, bg) -> None:
        """Replace shard ``s``'s state and table, on ``placement[s]``."""
        self._states[s] = _to(state, self.placement[s])
        self._bgs[s] = _to(bg, self.placement[s])
        self._host_states = None

    def _apply_crash_plans(self) -> None:
        """``Cluster._apply_crash_plans``' order: restarts before crashes,
        so both backends execute one schedule identically."""
        for c in self._crash_plans:
            if c.restart_round == self.round_no and c.shard in self.net.down:
                self._restart_shard(c.shard)
        for c in self._crash_plans:
            if c.crash_round == self.round_no:
                self._crash_shard(c.shard)

    def _crash_shard(self, s: int) -> None:
        self.membership.crash(s)
        if not self.membership.active:
            raise RuntimeError(
                f"crash of shard {s} leaves no active shard — the "
                f"coordinator for epoch broadcasts must survive")
        self._broadcast_epoch()
        dev = self.placement[s]
        self._set_shard(s, init_shard(self.cfg, s, peers_mask=0,
                                      device=dev),
                        B.init_bg_table(self.cfg, dev))
        self._net_backlog[s] = np.zeros((0, M.FIELDS), np.int32)
        self.net.crash_shard(s)

    def _restart_shard(self, s: int) -> None:
        with on_device(self.placement[s]):
            rec = self.durability.recover(s, in_cap=self.in_cap,
                                          device=self.placement[s])
        self._set_shard(s, rec.state, rec.bg)
        self._net_backlog[s] = rec.backlog
        self.net.restart_shard(s, rec.lanes)
        self.membership.restart(s)
        self._broadcast_epoch()
        self.durability.snapshot_now(
            s, self.round_no - 1, rec.state, rec.bg, rec.backlog,
            self.net.export_shard_lanes(s))

    def _check_overflow(self, out_counts) -> None:
        """The overflow discipline of both round paths (``Cluster.step``'s
        check): a count past ``mailbox_cap`` means rows were not stored —
        raise, never truncate."""
        over = max(out_counts)
        self.stats["max_outbox"] = max(self.stats["max_outbox"], over)
        if over > self.cfg.mailbox_cap:
            s = int(np.argmax(np.asarray(out_counts)))
            raise OutboxOverflow(
                f"shard {s} emitted {over} messages in round "
                f"{self.round_no}, mailbox_cap={self.cfg.mailbox_cap} — "
                f"raise mailbox_cap or reduce the per-round feed")

    def _harvest(self, cs, cv, cr, ck) -> List[Completion]:
        """Completions of one round as (op_id, result, src) with id
        recycling, shared by both round paths. ``ck`` is the comp_key
        lane: SH_KEY marks a scalar completion; a real key marks a RANGE
        item row (key, value) for the slot's scan (DESIGN.md §16)."""
        comps: List[Completion] = []
        done = cs >= 0
        for slot, val, src, key in zip(cs[done].tolist(), cv[done].tolist(),
                                       cr[done].tolist(), ck[done].tolist()):
            if key != SH_KEY:
                self._range_parts.setdefault(slot, []).append((key, val))
                continue
            if slot in self._range_ops:
                # terminal row: F_A is the total item count (negative =
                # error). Publication is count-gated below — items from
                # other serving shards may still be in flight
                self._range_done[slot] = (val, src)
                continue
            comps.append((slot, val, src))
            self._ids.release(slot)
        for slot, (total, src) in list(self._range_done.items()):
            if total >= 0 and len(self._range_parts.get(slot, ())) < total:
                continue
            self._range_items[slot] = sorted(
                self._range_parts.pop(slot, []))
            self._range_ops.discard(slot)
            del self._range_done[slot]
            comps.append((slot, total, src))
            self._ids.release(slot)
        return comps

    def _update_op_rates(self, ent_hits, rep_hits) -> None:
        """Per-entry op-rate EWMA, ``Cluster``'s update (same alpha and
        prune): decay every tracked entry, add this round's per-shard hits
        keyed by registry keymax, drop entries decayed to noise.
        ``rep_hits`` (per-shard replica-served FINDs, [S]) feeds the
        per-shard ``rep_rate_ewma`` the balancer folds into shard load."""
        hits = ent_hits.numpy()                             # [S, M]
        ent_rates: Dict[int, int] = {}
        if hits.any():
            kmax = self._gather([st.registry.keymax
                                 for st in self._states])       # [S, M]
            for s, e in zip(*np.nonzero(hits)):
                k = int(kmax[s, e])
                if k != ST_KEY:
                    ent_rates[k] = ent_rates.get(k, 0) + int(hits[s, e])
        alpha = 0.3
        nxt: Dict[int, float] = {}
        for k, v in self.op_rate_ewma.items():
            d = v * (1.0 - alpha)
            if d > 1e-3:
                nxt[k] = d
        for k, h in ent_rates.items():
            nxt[k] = nxt.get(k, 0.0) + alpha * h
        self.op_rate_ewma = nxt
        nxt_rep: Dict[int, float] = {}
        for s, v in self.rep_rate_ewma.items():
            d = v * (1.0 - alpha)
            if d > 1e-3:
                nxt_rep[s] = d
        for s, h in enumerate(rep_hits.tolist()):
            if h:
                nxt_rep[s] = nxt_rep.get(s, 0.0) + alpha * h
        self.rep_rate_ewma = nxt_rep

    def _step_hostroute(self) -> List[Completion]:
        """One round on the nemesis path: the round without its exchange,
        then host-side transport routing of the raw outboxes."""
        if self._crash_plans:
            self._apply_crash_plans()
        down = self.net.down
        client = self._feed_client(down)
        inbox = np.zeros((self.n, self.in_cap, M.FIELDS), np.int32)
        for s in range(self.n):
            feed = self._net_backlog[s][:self.in_cap]
            self._net_backlog[s] = self._net_backlog[s][self.in_cap:]
            inbox[s, :feed.shape[0]] = feed
        out = self._rnd(self._states, self._bgs, inbox, client)
        self._states, self._bgs = out.states, out.bgs
        self._host_states = None
        with timing.tracer(self.timer)("host_routing"):
            rstats = out.stats.numpy()
            out_counts = [int(c) for c in rstats[:, 0]]
            self._check_overflow(out_counts)
            self.stats["max_bg_active"] = max(self.stats["max_bg_active"],
                                              int(rstats[:, 1].max()))
            for lane, name in enumerate(("move_hits", "fast_hits",
                                         "mut_hits", "blk_hits", "rep_hits",
                                         "range_hits"), start=2):
                self.stats[name] += int(rstats[:, lane].sum())
            self._update_op_rates(out.ent_hits, rstats[:, 6])
            outbox = out.inbox.numpy()
            per_src = []
            for s in range(self.n):
                rows = outbox[s][:out_counts[s]]
                hops = rows[rows[:, M.F_KIND] == M.MSG_OP, M.F_X2]
                if hops.size:
                    self.stats["max_hops"] = max(self.stats["max_hops"],
                                                 int(hops.max()))
                    self.stats["delegated"] += int(hops.size)
                per_src.append((s, rows))
            pre_lens = [b.shape[0] for b in self._net_backlog]
            self.net.route_round(self._net_backlog, per_src, self.round_no)
            cs, cv = out.comp_slot.numpy(), out.comp_val.numpy()
            cr, ck = out.comp_src.numpy(), out.comp_key.numpy()
            comps = self._harvest(cs, cv, cr, ck)
            self._membership_maintenance()
            if self.durability is not None:
                self._journal(down, client, pre_lens, cs, cv, cr, ck)
        for ep, ev, sh in self.membership.log[self._mb_logged:]:
            self.round_trace.append(f"r{self.round_no} mb {ev} s{sh} e{ep}")
        self._mb_logged = len(self.membership.log)
        self.round_trace.append(trace_entry(
            self.round_no, comps, out_counts,
            extra=sum(b.shape[0] for b in self._net_backlog)
            + self.net.in_flight()))
        self.round_no += 1
        self.stats["rounds"] += 1
        return comps

    def _journal(self, down, client, pre_lens, cs, cv, cr, ck) -> None:
        """Journal the round per live shard (``Cluster.step``'s record
        layout): the client feed consumed, the routed appends,
        completions + bg phases + epoch (replay audit), the post-routing
        lane image; then the periodic snapshot."""
        phases = self._gather([bg.phase for bg in self._bgs])
        epochs = self._gather([st.epoch for st in self._states])
        every = self.durability.config.snapshot_every
        for s in range(self.n):
            if s in down:
                continue
            done = cs[s] >= 0
            comp = np.stack([cs[s][done], cv[s][done], cr[s][done],
                             ck[s][done]], axis=1).astype(np.int32)
            lanes = self.net.export_shard_lanes(s)
            self.durability.log_round(
                s, self.round_no,
                appends=self._net_backlog[s][pre_lens[s]:],
                client=client[s], comp=comp, bg_phases=phases[s],
                epoch=int(epochs[s]), lanes=lanes)
            if every > 0 and (self.round_no + 1) % every == 0:
                self.durability.snapshot_now(
                    s, self.round_no, self._states[s], self._bgs[s],
                    self._net_backlog[s], lanes)

    def step(self) -> List[Completion]:
        if self.net is not None:
            return self._step_hostroute()
        client = self._feed_client()
        out = self._rnd(self._states, self._bgs, self._inbox, client)
        self._states, self._bgs, self._inbox = out.states, out.bgs, out.inbox
        self._host_states = None
        with timing.tracer(self.timer)("host_routing"):
            # per-shard int32[9] round stats (the routed inbox itself
            # never crosses to the host; see make_dili_round's lane list)
            rstats = out.stats.numpy()
            self._check_overflow([int(c) for c in rstats[:, 0]])
            self._inflight_msgs = int(rstats[:, 1].sum())
            self.stats["max_bg_active"] = max(self.stats["max_bg_active"],
                                              int(rstats[:, 4].max()))
            for lane, name in enumerate(("move_hits", "blk_hits",
                                         "rep_hits", "range_hits"),
                                        start=5):
                self.stats[name] += int(rstats[:, lane].sum())
            self._update_op_rates(out.ent_hits, rstats[:, 7])
            delegated = int(rstats[:, 2].sum())
            if delegated:
                self.stats["delegated"] += delegated
                self.stats["max_hops"] = max(self.stats["max_hops"],
                                             int(rstats[:, 3].max()))
            comps = self._harvest(out.comp_slot.numpy(),
                                  out.comp_val.numpy(),
                                  out.comp_src.numpy(),
                                  out.comp_key.numpy())
            self._membership_maintenance()
        self.round_no += 1
        self.stats["rounds"] += 1
        return comps

    def quiescent(self) -> bool:
        if self.membership.crashed:
            return False        # keep stepping toward the scheduled restart
        if any(len(q) for q in self._queues):
            return False
        if self.net is not None:
            if any(b.shape[0] for b in self._net_backlog):
                return False
            if not self.net.idle():
                return False
        elif self._inflight_msgs:
            return False
        return not (self._gather([bg.phase for bg in self._bgs])
                    != B.BG_IDLE).any()

    def registry_entries(self, shard: int = 0) -> List[RegEntry]:
        return registry_entries(self.states[shard])

    # ------------------------------------------------------ balance surface
    def _gather(self, per_shard) -> np.ndarray:
        """One tensor of every shard, stacked on the host with one copy
        per device."""
        return gather_host(per_shard, self.placement).numpy()

    @property
    def states(self):
        """Per-shard host snapshots of the state, pulled once per round."""
        if self._host_states is None:
            self._host_states = [_host_tree(st) for st in self._states]
        return self._host_states

    @property
    def bgs(self):
        """Per-shard host copies of the background tables."""
        return [_host_tree(bg) for bg in self._bgs]

    def sublists(self, s: int):
        return state_sublists(self.cfg, self.states, s)

    def middle_item(self, s: int, head_idx: int) -> Optional[int]:
        items = chain_keys(self.cfg, self.states, s, head_idx,
                           include_meta=True)
        if len(items) < 2:
            return None
        return items[len(items) // 2][1]

    def _queue_bg(self, s: int, fn, cmd: int, *args) -> bool:
        bg, ok = fn(self._bgs[s], *args)
        self._bgs[s] = bg
        if self.durability is not None:
            # host-side BgTable mutation bypasses the inbox — journal it
            # so WAL replay re-queues the command (wal.py KIND_COMMAND)
            self.durability.log_command(s, self.round_no, cmd, args,
                                        bool(ok))
        return bool(ok)

    def split(self, s, entry_keymax, sitem_idx) -> bool:
        return self._queue_bg(s, B.queue_split, wal.CMD_SPLIT,
                              entry_keymax, sitem_idx)

    def move(self, s, entry_keymax, target) -> bool:
        return self._queue_bg(s, B.queue_move, wal.CMD_MOVE,
                              entry_keymax, target)

    def merge(self, s, left_keymax, right_keymax) -> bool:
        return self._queue_bg(s, B.queue_merge, wal.CMD_MERGE,
                              left_keymax, right_keymax)

    # -------------------------------------------------- replication (§15)
    def _queue_state(self, s: int, fn, cmd: int, *args) -> bool:
        """Like ``_queue_bg`` but for commands that edit ``ShardState``
        (the replication session table) instead of the BgTable."""
        st, ok = fn(self._states[s], self.cfg, *args)
        self._states[s] = st
        self._host_states = None
        ok = bool(ok)
        if self.durability is not None:
            self.durability.log_command(s, self.round_no, cmd, args, ok)
        return ok

    def replicate(self, s, entry_keymax, target) -> bool:
        if not self.cfg.replication:
            raise ValueError(
                "replicate: cfg.replication is off — replica serve and "
                "publication do not run in shard_round")
        ok = self._queue_state(s, R.queue_replicate, wal.CMD_REPLICATE,
                               entry_keymax, target)
        if ok:
            _, tg = self._replica_map.get(entry_keymax, (s, set()))
            self._replica_map[int(entry_keymax)] = (s, set(tg)
                                                    | {int(target)})
            self.replica_epoch += 1
        return ok

    def drop_replica(self, s, entry_keymax, target=-1) -> bool:
        if not self.cfg.replication:
            raise ValueError("drop_replica: cfg.replication is off")
        ok = self._queue_state(s, R.queue_drop_replica,
                               wal.CMD_DROP_REPLICA, entry_keymax, target)
        if entry_keymax in self._replica_map:
            prim, tg = self._replica_map[entry_keymax]
            tg = set() if target < 0 else set(tg) - {int(target)}
            if tg:
                self._replica_map[entry_keymax] = (prim, tg)
            else:
                del self._replica_map[entry_keymax]
            self.replica_epoch += 1
        return ok

    def replica_sets(self):
        """``Cluster.replica_sets``' contract (the two backends expose one
        routing view to the client API)."""
        out = {}
        stale = []
        states = self.states
        for kmax, (prim, tg) in self._replica_map.items():
            reg = states[prim].registry
            kmaxes = reg.keymax[:int(reg.size)].numpy()
            at = np.nonzero(kmaxes == kmax)[0]
            if not (at.size and refs.ref_sid(int(reg.subhead[at[0]]))
                    == prim):
                stale.append(kmax)
                continue
            out[int(kmax)] = (int(reg.keymin[at[0]]), int(prim), sorted(tg))
        for kmax in stale:
            del self._replica_map[kmax]
            self.replica_epoch += 1
        return out

    # ------------------------------------------------------------ debugging
    def all_keys(self) -> List[int]:
        return global_keys(self.cfg, self.states)

    def shard_chain(self, s, head_idx, include_meta=False):
        return chain_keys(self.cfg, self.states, s, head_idx, include_meta)
