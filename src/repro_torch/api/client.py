"""``DiLiClient`` — the public client API of the DiLi runtime (DESIGN.md §9).

The paper's clients are first-class participants: they cache registry
entries, learn corrected routes from wrong-shard replies, and keep
operating while sublists split and move underneath them. This client
reproduces that contract over any ``Backend``:

  * **Routing.** A client-side registry cache (seeded from a server
    replica at construction) predicts each key's owner, so ops are
    submitted where they will execute instead of a fixed shard. Stale
    routes are *safe* — servers delegate mis-routed ops (Theorem 4 bounds
    the hops) — they only cost hops, and every completion reports the
    shard that executed the op, so a mismatch triggers a cache refresh.
  * **Pacing.** Admission is bounded against ``mailbox_cap`` so overload
    queues client-side instead of surfacing ``OutboxOverflow`` from the
    round engine: every in-flight op occupies at most one message per
    round, so capping in-flight ops leaves outbox headroom for move
    replicates and registry broadcasts.
  * **Ordering.** At most one *mutation* per key is in flight at a time,
    and a mutation waits for every in-flight op on its key; FINDs on the
    same key may fly concurrently (reads commute when no write separates
    them, and any separating write still queued keeps later same-key ops
    behind it via the skip set). Same-key ops are admitted in submission
    order — exactly the per-key discipline linearizability needs, relaxed
    only where commutativity makes the relaxation unobservable. Without
    the relaxation a Zipfian read-mostly workload would serialize its hot
    keys one FIND per round, which is the workload replication exists to
    spread (DESIGN.md §15).
  * **Replica routing.** When replication is on, the client learns replica
    sets from the backend (``replica_sets()``, re-pulled whenever
    ``replica_epoch`` moves) and spreads FINDs round-robin over
    [primary] + replicas; mutations always go to the primary. A stale or
    expired replica is safe: the serving gate on the replica shard simply
    does not fire and the op delegates home like any mis-routed op.
  * **Balancing.** ``pump()`` periodically runs a pluggable balance policy
    (``core.balancer.Balancer`` is the paper's §7.1 policy) over the
    backend's balance surface.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import deque
from itertools import islice
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..core.types import OP_FIND, OP_INSERT, OP_REMOVE

from .backend import Backend, LocalBackend
from .futures import BatchResult, OpFuture, RangeResult


class RegistryCache:
    """Client-side replica of the registry: sorted (keymin, keymax, owner).

    Same semantics as ``core.registry.get_by_key``: an entry covers keys
    strictly greater than its keymin and up to (inclusive) its keymax.
    """

    def __init__(self, entries: Sequence[Tuple[int, int, int]] = ()):
        self._mins: List[int] = []
        self._maxs: List[int] = []
        self._owners: List[int] = []
        self.load(entries)

    def load(self, entries: Sequence[Tuple[int, int, int]]) -> None:
        ordered = sorted(entries)
        self._mins = [e[0] for e in ordered]
        self._maxs = [e[1] for e in ordered]
        self._owners = [e[2] for e in ordered]

    def lookup(self, key: int) -> Optional[int]:
        i = bisect_left(self._mins, key) - 1
        if i < 0:
            return None
        if self._mins[i] < key <= self._maxs[i]:
            return self._owners[i]
        return None

    def __len__(self) -> int:
        return len(self._mins)


class DiLiClient:
    """Futures-based client over a DiLi execution backend.

    ``route_cache=False`` degrades to fixed-shard submission (every op goes
    to ``home_shard``) — the pre-redesign behaviour, kept for comparison
    benchmarks and tests.
    """

    def __init__(self, backend: Backend, *, route_cache: bool = True,
                 balance=None, balance_every: int = 4,
                 home_shard: int = 0,
                 max_inflight: Optional[int] = None):
        self.backend = backend
        self.cfg = backend.cfg
        self.route_cache = route_cache
        self.balance = balance          # any object with .step() -> dict
        self.balance_every = max(1, int(balance_every))
        self.home_shard = int(home_shard)
        # Pacing budget (see _auto_inflight). A caller-pinned budget is
        # never recomputed; the automatic one follows the membership epoch
        # (DESIGN.md §13) — the fan-out reserve tracks the *live* shard
        # count, not the construction-time capacity.
        self._pinned_inflight = max_inflight is not None
        mb = getattr(backend, "membership", None)
        self._seen_epoch = mb.epoch if mb is not None else 0
        if mb is not None and not mb.is_routable(self.home_shard):
            self.home_shard = min(mb.active)
        self.max_inflight = int(max_inflight if self._pinned_inflight
                                else self._auto_inflight())
        self._queue: deque = deque()                 # unadmitted OpFutures
        self._inflight: Dict[int, OpFuture] = {}     # op_id -> future
        self._busy_mut: Set[int] = set()             # keys with mutation out
        self._find_out: Dict[int, int] = {}          # key -> in-flight FINDs
        self._scan_spans: Dict[int, Tuple[int, int]] = {}  # op_id -> [lo,hi)
        self._cache = RegistryCache(backend.registry_entries(self.home_shard))
        self._refresh_from: Optional[int] = None     # pending cache refresh
        self._rounds = 0
        self.wrong_routes = 0                        # completions off-route
        # replica routing (§15): {keymax: (keymin, primary, [replicas])}
        # plus the sorted keymax index for range lookup; re-pulled whenever
        # the backend's replica_epoch moves.
        self._replica_sets: Dict[int, Tuple[int, int, List[int]]] = {}
        self._replica_maxs: List[int] = []
        self._seen_replica_epoch = getattr(backend, "replica_epoch", 0)
        self._rr = 0                                 # read spread counter

    def _auto_inflight(self) -> int:
        """Pacing budget: each in-flight op contributes at most one outbox
        row per shard per round (its delegation XOR its result), plus one
        replicate while its sublist moves. Reserve headroom for the
        background slots (each can have ``move_batch`` MoveItems plus
        their acks in fabric per round, and a registry broadcast) and one
        broadcast row per *live* shard — the fan-out a registry update or
        epoch announcement can add to a single outbox. The reserve assumes
        ≤ bg_slots concurrent migrations touch any one shard (the §7.1
        balancer's behaviour); policies aiming more moves at a single
        target need a larger mailbox_cap or an explicit max_inflight
        (DESIGN.md §9).

        The budget stays a *global* cap equal to one shard's headroom (it
        does not scale with the live shard count): after a partition heals
        the transport can concentrate a multi-round backlog of delegated
        ops at one executor in one round, and a budget any wider than one
        shard's headroom turns that burst into OutboxOverflow.
        """
        mb = getattr(self.backend, "membership", None)
        n_live = (len(mb.routable) if mb is not None
                  else self.cfg.num_shards)
        bg_budget = self.cfg.bg_slots * (2 * self.cfg.move_batch + 2)
        if getattr(self.cfg, "replication", False):
            # publication reserve (§15): each replication session can put
            # ``replica_batch`` delta rows + an INSTALL/DROP on the wire
            # in one round
            bg_budget += self.cfg.replica_sessions * (
                self.cfg.replica_batch + 2)
        budget = max(1, self.cfg.mailbox_cap - bg_budget - n_live - 4)
        if getattr(self.backend, "net", None) is not None:
            # Lossy-wire headroom (DESIGN.md §11): the transport can
            # release a multi-round backlog of frames in one round
            # (retransmit bursts after a partition heals, delayed frames
            # coming due together), concentrating handler replies that a
            # clean run spreads out — so in-flight ops claim only half
            # the budget, leaving the rest for retransmit-burst fan-out.
            budget = max(1, budget // 2)
        return budget

    # ------------------------------------------------------------ submission
    def find(self, key: int) -> OpFuture:
        return self._enqueue(OP_FIND, key)

    def insert(self, key: int, value: int = 0) -> OpFuture:
        return self._enqueue(OP_INSERT, key, value)

    def remove(self, key: int) -> OpFuture:
        return self._enqueue(OP_REMOVE, key)

    def range(self, lo: int, hi: int, limit: int = 4096) -> RangeResult:
        """RANGE(lo, hi, limit): the sorted (key, value) pairs in
        ``[lo, hi)``, at most ``limit`` of them (DESIGN.md §16).

        Always aimed at the *primary* predicted to own ``lo`` — scans
        never ride read replicas (a replica's bounded staleness is fine
        for a single FIND but would tear a multi-key snapshot). Ordering:
        a scan waits for every in-flight mutation inside its span, and
        later mutations into the span hold until the scan resolves — the
        per-key discipline lifted to key *ranges*.
        """
        if not getattr(self.cfg, "range_scan", False):
            raise ValueError(
                "range: cfg.range_scan is off — the scan pre-pass and "
                "MSG_RANGE handlers are off in shard_round")
        if limit < 1:
            raise ValueError(f"range: limit={limit} must be >= 1")
        fut = RangeResult(self, lo, hi, limit)
        self._queue.append(fut)
        return fut

    def find_batch(self, keys: Sequence[int]) -> BatchResult:
        return BatchResult([self.find(k) for k in keys])

    def insert_batch(self, keys: Sequence[int],
                     values: Optional[Sequence[int]] = None) -> BatchResult:
        values = [0] * len(keys) if values is None else list(values)
        if len(values) != len(keys):
            raise ValueError(f"{len(values)} values vs {len(keys)} keys")
        return BatchResult([self.insert(k, v)
                            for k, v in zip(keys, values)])

    def remove_batch(self, keys: Sequence[int]) -> BatchResult:
        return BatchResult([self.remove(k) for k in keys])

    def submit(self, kinds: Sequence[int], keys: Sequence[int],
               values: Optional[Sequence[int]] = None) -> BatchResult:
        """Mixed batch, one future per (kind, key) in submission order."""
        kinds, keys = list(kinds), list(keys)
        if len(kinds) != len(keys):
            raise ValueError(f"{len(kinds)} kinds vs {len(keys)} keys")
        values = [0] * len(keys) if values is None else list(values)
        if len(values) != len(keys):
            raise ValueError(f"{len(values)} values vs {len(keys)} keys")
        return BatchResult([self._enqueue(k, x, v)
                            for k, x, v in zip(kinds, keys, values)])

    def _enqueue(self, kind: int, key: int, value: int = 0) -> OpFuture:
        fut = OpFuture(self, kind, key, value)
        self._queue.append(fut)
        return fut

    # ---------------------------------------------------------- driver loop
    @property
    def pending(self) -> int:
        """Ops submitted but not yet resolved."""
        return len(self._queue) + len(self._inflight)

    def pump(self, run_balance: bool = True) -> int:
        """One round: refresh-route, admit, execute, harvest. Returns the
        number of futures resolved this round."""
        mb = getattr(self.backend, "membership", None)
        if mb is not None and mb.epoch != self._seen_epoch:
            # membership changed (DESIGN.md §13): re-aim the home shard if
            # it left, recompute the pacing budget against the new live
            # count (unless the caller pinned it), and refresh the route
            # cache so draining shards stop receiving fresh ops promptly
            # (stale routes would still be *safe* — just slower to heal).
            self._seen_epoch = mb.epoch
            if not mb.is_routable(self.home_shard):
                self.home_shard = min(mb.active)
            if not self._pinned_inflight:
                self.max_inflight = self._auto_inflight()
            if self.route_cache:
                self._refresh_from = self.home_shard
        if self._refresh_from is not None and self.route_cache:
            self.refresh_route_cache(self._refresh_from)
        rep_epoch = getattr(self.backend, "replica_epoch", 0)
        if rep_epoch != self._seen_replica_epoch:
            self._seen_replica_epoch = rep_epoch
            self._replica_sets = dict(self.backend.replica_sets())
            self._replica_maxs = sorted(self._replica_sets)
        self._admit()
        ndone = 0
        for op_id, val, src in self.backend.step():
            fut = self._inflight.pop(op_id, None)
            if fut is None:
                # backends only report ops issued through them, and a
                # backend supports one driving client — unreachable unless
                # two clients share a backend (unsupported)
                continue
            if isinstance(fut, RangeResult):
                # the completion value is the item count (or error code);
                # the pairs are fetched once from the backend. The src
                # shard is whichever served the *last* segment — not a
                # routing signal, so no wrong-route refresh for scans.
                fut._resolve(val, src, self.backend.take_range_items(op_id))
                fut.op_id = None
                self._scan_spans.pop(op_id, None)
                ndone += 1
                continue
            fut._resolve(val, src)
            fut.op_id = None
            if fut.kind == OP_FIND:
                left = self._find_out.get(fut.key, 1) - 1
                if left > 0:
                    self._find_out[fut.key] = left
                else:
                    self._find_out.pop(fut.key, None)
            else:
                self._busy_mut.discard(fut.key)
            ndone += 1
            if src != fut.shard and not getattr(fut, "via_replica", False):
                # wrong-route reply: the executing shard's replica covers
                # this key freshest — refresh from it next pump. FINDs
                # deliberately aimed at read replicas (or bounced home by
                # an expired one) are not routing errors and don't
                # trigger refresh churn.
                self.wrong_routes += 1
                self._refresh_from = src
        self._rounds += 1
        if (run_balance and self.balance is not None
                and self._rounds % self.balance_every == 0):
            self.balance.step()
        return ndone

    def drain(self, max_rounds: int = 2000, *,
              run_balance: bool = False) -> None:
        """Pump until every future is resolved and the backend is quiet."""
        for _ in range(max_rounds):
            self.pump(run_balance=run_balance)
            if self.pending == 0 and self.backend.quiescent():
                return
        raise RuntimeError(
            f"client did not drain in {max_rounds} rounds: "
            f"queued={len(self._queue)} inflight={len(self._inflight)} "
            f"backend_quiet={self.backend.quiescent()}")

    def settle(self, max_passes: int = 200, max_rounds: int = 2000) -> None:
        """Drain, then run the balance policy to a fixed point (no commands
        issued), draining after each pass."""
        self.drain(max_rounds)
        if self.balance is None:
            return
        for _ in range(max_passes):
            if not any(self.balance.step().values()):
                return
            self.drain(max_rounds)
        raise RuntimeError(f"balance did not settle in {max_passes} passes")

    # -------------------------------------------------------------- routing
    def route(self, key: int) -> int:
        """Predicted owner shard for ``key`` (home shard when uncached or
        when the cached owner is no longer a routable member)."""
        if self.route_cache:
            owner = self._cache.lookup(key)
            if owner is not None and 0 <= owner < self.backend.n:
                mb = getattr(self.backend, "membership", None)
                if mb is None or mb.is_routable(owner):
                    return owner
        return self.home_shard

    def route_find(self, key: int) -> Tuple[int, bool]:
        """Route for a FIND: ``(shard, via_replica)``. When ``key`` falls
        in a replicated range, reads spread round-robin over the primary
        and its replicas; everything else (and all mutations) uses
        ``route``."""
        if self._replica_maxs:
            i = bisect_left(self._replica_maxs, key)
            if i < len(self._replica_maxs):
                kmax = self._replica_maxs[i]
                kmin, prim, reps = self._replica_sets[kmax]
                if kmin < key <= kmax and reps:
                    mb = getattr(self.backend, "membership", None)
                    choices = [prim] + [r for r in reps
                                        if mb is None or mb.is_routable(r)]
                    pick = choices[self._rr % len(choices)]
                    self._rr += 1
                    return pick, pick != prim
        return self.route(key), False

    def refresh_route_cache(self, shard: Optional[int] = None) -> None:
        """Re-seed the route cache from a server's registry replica."""
        src = self.home_shard if shard is None else int(shard)
        self._cache.load(self.backend.registry_entries(src))
        self._refresh_from = None

    def _admit(self) -> None:
        """Admit queued ops up to the pacing budget, preserving per-key
        submission order (a key with an earlier op deferred this pass
        keeps its later ops queued). Mutations wait for *every* in-flight
        op on their key; FINDs only wait for in-flight mutations — any
        number of same-key FINDs may fly at once (see module docstring)."""
        if not self._queue:
            return
        budget = self.max_inflight - len(self._inflight)
        per_round = self.cfg.batch_size      # backend feed bound per shard
        # a RANGE occupies one feed row but its serving shard may emit up
        # to range_batch items + a forward/terminal in one round — charge
        # it that many budget units so scans cannot overrun the outbox
        # headroom the pacing model reserves (see _auto_inflight)
        scan_cost = getattr(self.cfg, "range_batch", 32) + 2
        admit: Dict[int, List[OpFuture]] = {}
        scans: Dict[int, List[RangeResult]] = {}
        kept: deque = deque()
        skip: Set[int] = set()
        skip_spans: List[Tuple[int, int]] = []   # deferred scans' spans
        inflight_spans = list(self._scan_spans.values())
        for qi, fut in enumerate(self._queue):
            if budget <= 0:
                # budget spent: everything left stays queued in order —
                # stop scanning (a deep overload queue would otherwise make
                # each pump O(queue) for nothing)
                kept.extend(islice(self._queue, qi, None))
                break
            if isinstance(fut, RangeResult):
                lo, hi = fut.lo, fut.hi
                # a scan waits for in-flight mutations in its span and
                # for earlier-deferred ops on keys inside it (submission
                # order); concurrent FINDs and scans commute with it
                blocked = (any(lo <= k < hi for k in self._busy_mut)
                           or any(lo <= k < hi for k in skip))
                if blocked or budget < scan_cost:
                    kept.append(fut)
                    skip_spans.append((lo, hi))
                    continue
                shard = self.route(lo)          # primary-pinned (§16)
                lane = scans.setdefault(shard, [])
                if (len(lane) + len(admit.get(shard, ()))) >= per_round:
                    kept.append(fut)
                    skip_spans.append((lo, hi))
                    continue
                fut.shard = shard
                lane.append(fut)
                inflight_spans.append((lo, hi))
                budget -= scan_cost
                continue
            key = fut.key
            is_find = fut.kind == OP_FIND
            blocked = (key in self._busy_mut or key in skip
                       or (not is_find and self._find_out.get(key, 0)))
            if not is_find and not blocked:
                # mutations hold while any scan (in flight or deferred
                # ahead of us) covers their key — the span-level ordering
                # that makes a scan a consistent cut (DESIGN.md §16)
                blocked = any(lo <= key < hi
                              for lo, hi in inflight_spans) \
                    or any(lo <= key < hi for lo, hi in skip_spans)
            if blocked:
                kept.append(fut)
                skip.add(key)
                continue
            if is_find:
                shard, via_rep = self.route_find(key)
            else:
                shard, via_rep = self.route(key), False
            lane = admit.setdefault(shard, [])
            if (len(lane) + len(scans.get(shard, ()))) >= per_round:
                kept.append(fut)
                skip.add(key)
                continue
            fut.shard = shard
            fut.via_replica = via_rep
            lane.append(fut)
            if is_find:
                self._find_out[key] = self._find_out.get(key, 0) + 1
            else:
                self._busy_mut.add(key)
            budget -= 1
        self._queue = kept
        for shard, futs in admit.items():
            ids = self.backend.submit(
                shard, [f.kind for f in futs], [f.key for f in futs],
                [f.value for f in futs])
            for f, op_id in zip(futs, ids):
                f.op_id = op_id
                self._inflight[op_id] = f
        for shard, rfuts in scans.items():
            for f in rfuts:
                op_id = self.backend.submit_range(shard, f.lo, f.hi,
                                                  f.limit)
                f.op_id = op_id
                self._inflight[op_id] = f
                self._scan_spans[op_id] = (f.lo, f.hi)

    # ------------------------------------------------------------ inspection
    @property
    def stats(self) -> Dict[str, int]:
        return self.backend.stats

    def all_keys(self) -> List[int]:
        return self.backend.all_keys()


def local_client(cfg, **kw) -> DiLiClient:
    """Convenience: a ``DiLiClient`` over a fresh ``LocalBackend`` (on
    ``device=`` — CUDA unless the caller asks for the CPU)."""
    backend_kw = {k: kw.pop(k) for k in
                  ("seed", "delay_prob", "nemesis", "retransmit_after",
                   "net_window", "key_lo", "key_hi", "initial_shards",
                   "trace", "durability", "device", "timer") if k in kw}
    return DiLiClient(LocalBackend(cfg, **backend_kw), **kw)
