"""Execution backends behind ``DiLiClient`` (DESIGN.md §9).

``LocalBackend`` adapts the single-host simulator (``core.sim.Cluster``)
to the backend contract the client drives: ``submit`` enqueues ops and
returns ids, ``step`` runs one round and returns ``(op_id, result,
src_shard)`` completions (recycling their ids), ``quiescent`` says no
message or background op is in flight, and the balance surface
(``sublists``/``middle_item``/``split``/``move``/``merge`` plus
``states``/``bgs``/``cfg``/``n``) is the duck type ``core.balancer``
drives. With ``nemesis=`` it routes through the reliable transport, with
``durability=`` it journals to a WAL (and ``CrashPlan``s recover from
it), and ``join_shard``/``retire_shard`` change membership under traffic.
The SPMD backend comes with a later slice of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..core import bg as B
from ..core.membership import Membership
from ..core.sim import Cluster
from ..core.types import DiLiConfig, KEY_MAX, KEY_MIN

Completion = Tuple[int, int, int]           # (op_id, result, src_shard)
RegEntry = Tuple[int, int, int]             # (keymin, keymax, owner)


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
