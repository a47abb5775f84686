"""The naive load balancer of §7.1, as a host-side policy over the cluster.

Policy, verbatim from the paper:

  * Split any owned sublist larger than ``split_threshold`` (125) roughly in
    the middle — this bounds the linear-traversal length of the hybrid search.
  * When a machine holds more than ``move_headroom`` (110%) of the mean load,
    Move one of its sublists to the least-loaded machine.
  * (Extension, Appendix B) Merge adjacent tiny sublists on the same shard
    when both fall below ``merge_threshold`` — keeps the registry compact.

With the slotted background engine (DESIGN.md §10) a pass is no longer
one-decision-per-shard: the gate is per registry *entry* (an entry already
claimed by an in-flight Split/Move/Merge is skipped; every other entry is
fair game), and a shard accepts up to ``bg_slots`` commands per pass. The
load model is kept honest within a pass — each issued Move immediately
transfers the sublist's size from source to target in the working
``loads`` snapshot, so one overloaded pass cannot dogpile every donor
onto the same least-loaded shard.

The load model reads sublist sizes and the BgTable's in-flight moves —
state advanced by move/switch *acks*. Under a lossy wire those acks ride
the reliable transport (DESIGN.md §11), whose per-lane dedup window
guarantees each ack reaches its handler exactly once, so ``acked``
counters (and with them the ``active_moves`` load discount) can never be
double-counted by duplicated deliveries; the balancer needs no defensive
clamping of its own.

This is a copy of the reference policy. With one shard it only splits:
moves need two targets and merges a positive ``merge_threshold``.

The Split/Move/Merge primitives are the *interface*; this policy is
deliberately simple and replaceable (the paper calls for workload-specific
balancers). ``Balancer`` is one ``BalancePolicy`` — the client driver loop
(``repro.api.DiLiClient``) runs any policy with a ``step() -> dict``
method at a configurable cadence, over any object exposing the balance
surface (``Cluster`` or an ``api.Backend``: ``n``/``cfg``/``bgs``/
``states``/``sublists``/``middle_item``/``split``/``move``/``merge``).
"""
from __future__ import annotations

from typing import Dict, Optional, Protocol

from .. import timing
from . import bg as B
from .host import to_numpy


class BalancePolicy(Protocol):
    """A pluggable balancing policy: one pass of decisions per call.

    ``step`` inspects the cluster/backend it was constructed over, queues
    Split/Move/Merge commands, and returns issued-command counts; an
    all-zero dict means the policy reached a fixed point (how
    ``DiLiClient.settle`` detects convergence).
    """

    def step(self) -> Dict[str, int]: ...


class Balancer:
    def __init__(self, cluster, *, split_threshold: Optional[int] = None,
                 move_headroom: float = 1.10, merge_threshold: int = 0,
                 registry_headroom: int = 4, rng=None,
                 rate_weight: float = 1.0, hot_rate: float = 8.0,
                 cold_rate: float = 2.0, hot_share: float = 0.0,
                 replica_fanout: int = 1):
        self.cl = cluster
        self.split_threshold = (split_threshold if split_threshold is not None
                                else cluster.cfg.split_threshold)
        self.move_headroom = move_headroom
        self.merge_threshold = merge_threshold
        self.registry_headroom = registry_headroom
        # Load model (§15): L(e) = size + rate_weight * op_rate_ewma(e).
        # The op-rate term is the primary signal under traffic; it decays
        # to zero at rest, where the key count is the tiebreak — so a
        # settled cluster balances exactly as the key-calibrated policy
        # always did.
        self.rate_weight = float(rate_weight)
        # Hot/cold hysteresis for read replication: an entry whose op-rate
        # EWMA crosses ``hot_rate`` gets replicated onto the
        # ``replica_fanout`` least-loaded other shards; replicas are
        # dropped only once the rate falls below ``cold_rate`` (< hot) —
        # the band keeps a sublist hovering near the threshold from
        # flapping replicate/drop every pass.
        self.hot_rate = float(hot_rate)
        self.cold_rate = float(cold_rate)
        # Absolute rate alone can't tell skew from volume: a driven
        # shard's hottest entry pins near the admission rate at *any*
        # skew. ``hot_share`` additionally requires the entry to carry
        # that fraction of the cluster-wide rate (0 disables the gate).
        self.hot_share = float(hot_share)
        self.replica_fanout = int(replica_fanout)
        # Move-target tie-break stream. None keeps the historical
        # lowest-index tie-break; passing the backend's ``balancer_rng``
        # (a child of the run's root SeedSequence) makes randomized
        # policies a pure function of the run seed — required for the
        # byte-identical (seed, config) replay contract (DESIGN.md §11).
        self.rng = rng

    def _owned(self, s: int):
        return [e for e in self.cl.sublists(s) if e["owner"] == s
                and e["size"] is not None]

    def step(self) -> dict:
        """One balancing pass; returns counts of issued commands. The pass
        is the span ``balance`` of the cluster's or backend's ``timer``."""
        with timing.tracer(getattr(self.cl, "timer", None))("balance"):
            return self._pass()

    def _pass(self) -> dict:
        cl = self.cl
        issued = {"split": 0, "move": 0, "merge": 0, "evacuate": 0,
                  "replicate": 0, "drop": 0}
        # membership view (DESIGN.md §13): sources of load are every
        # routable shard, valid destinations for new moves are
        # active+joining, and draining shards get force-evacuated below.
        # A membership-less cluster (raw duck-typed surface) balances over
        # all shards, exactly as before.
        mb = getattr(cl, "membership", None)
        if mb is None:
            routable = targets = list(range(cl.n))
            draining = []
        else:
            routable = list(mb.routable)
            targets = list(mb.targets)
            draining = list(mb.draining)
        owned = {s: self._owned(s) for s in routable}
        # per-entry effective load: op-rate EWMA (keyed by keymax, pulled
        # off the backend) weighted on top of the key count
        rates = getattr(cl, "op_rate_ewma", None) or {}

        # read replication (§15): the current replica map, and whether the
        # backend supports replication at all (raw duck-typed surfaces
        # without the command are balanced exactly as before)
        rep_on = (getattr(cl.cfg, "replication", False)
                  and hasattr(cl, "replica_sets"))
        repsets = cl.replica_sets() if rep_on else {}

        def eload(e):
            r = rates.get(e["keymax"], 0.0)
            rs = repsets.get(e["keymax"])
            if rs:
                # the entry rate is cluster-wide (replica shards bump the
                # same global registry entry when they serve), but the
                # client spreads reads round-robin over primary+replicas —
                # charge the owner only its share, or the primary looks
                # crushed by load it isn't serving and the balancer churns
                # moves it can never satisfy (the hot entry is pinned).
                # Serving shards are charged via rep_rate_ewma below.
                r /= 1 + len(rs[2])
            return e["size"] + self.rate_weight * r

        def shed_replicas(s, kmax):
            """True when ``kmax`` is replicated: its replicas are told to
            drop and the caller must skip restructuring it this pass —
            Move/Split/Merge on a replicated entry first retires the
            replicas (the primary's session self-audit is only the safety
            net for races, not the clean path)."""
            if kmax not in repsets:
                return False
            if cl.drop_replica(s, kmax):
                issued["drop"] += 1
            del repsets[kmax]
            return True

        loads = {s: sum(eload(e) for e in owned[s]) for s in routable}
        # replica service is real load on the serving shard but invisible
        # to the registry-keyed entry rates (the entry lives on the
        # primary): fold each shard's replica-served FIND EWMA in, or the
        # model reads serving replicas as idle and churns moves (and
        # `shed_replicas` teardowns) against phantom imbalance.
        rep_rates = getattr(cl, "rep_rate_ewma", None) or {}
        for s in routable:
            loads[s] += self.rate_weight * rep_rates.get(s, 0.0)
        total = sum(loads.values())
        # the mean the policy steers toward is over the shards that will
        # still hold data after the drains complete
        mean = total / max(len(targets), 1)

        # per-shard slot budget + per-entry claims of in-flight ops; both
        # are maintained locally as commands are issued this pass. Snapshot
        # ``cl.bgs`` once: on ShardMapBackend every access pulls every
        # shard's table device-to-host
        bgs = cl.bgs
        free = {s: B.free_slots(bgs[s]) for s in routable}
        claimed = {s: B.claimed_keys(bgs[s]) for s in routable}

        # account load already *en route*: an in-flight Move's sublist
        # still counts against its source until the registry transfer
        # lands, so without this discount every pass during the (multi-
        # round) copy re-diagnoses the same overload and dogpiles more
        # moves onto it
        for s in routable:
            for key, tgt in B.active_moves(bgs[s]):
                e = next((x for x in owned[s] if x["keymax"] == key), None)
                if e is not None and tgt in loads and tgt != s:
                    loads[s] -= eload(e)
                    loads[tgt] += eload(e)

        # registry budget for *new* splits this pass. The registry is
        # global (every split adds an entry on every replica), and a split
        # whose stabilization finds it full waits in BG_SPLIT_WAIT
        # forever — so the budget must discount (a) splits issued earlier
        # in this pass, and (b) splits still in flight from previous
        # passes on any shard, not just re-read a registry.size those
        # entries haven't landed in yet.
        inflight_splits = sum(
            int(((ph == B.BG_SPLIT_EXEC) | (ph == B.BG_SPLIT_WAIT)).sum())
            for ph in (B.slot_phases(bgs[s]) for s in routable))
        reg_used = max(int(to_numpy(cl.states[s].registry.size))
                       for s in range(cl.n))
        reg_room = (cl.cfg.max_sublists - reg_used
                    - self.registry_headroom - inflight_splits)

        def pick_target(exclude):
            cands = [d for d in targets if d != exclude]
            if not cands:
                return None
            if self.rng is not None:
                # seeded tie-break among equally-loaded targets; min() is
                # stable, so shuffling only reorders ties
                cands = list(cands)
                self.rng.shuffle(cands)
            return min(cands, key=lambda d: loads[d])

        # 0) evacuate draining shards: every sublist they own is force-
        # moved onto the least-loaded target, bypassing the improvement
        # gates of stage 2 — the point is to empty the shard, not to even
        # the load (retire_shard's finish gate waits on owned == 0)
        for s in draining:
            for e in sorted(owned[s], key=lambda x: -x["size"]):
                if free[s] <= 0:
                    break
                if e["keymax"] in claimed[s] or e["switched"]:
                    continue
                if shed_replicas(s, e["keymax"]):
                    continue
                tgt = pick_target(s)
                if tgt is None:
                    break
                if cl.move(s, e["keymax"], tgt):
                    issued["evacuate"] += 1
                    free[s] -= 1
                    claimed[s].add(e["keymax"])
                    loads[s] -= eload(e)
                    loads[tgt] += eload(e)

        for s in targets:
            entries = owned[s]

            def unclaimed(e):
                return e["keymax"] not in claimed[s] and not e["switched"]

            # 1) split oversized sublists (registry budget permitting)
            big = sorted((e for e in entries
                          if e["size"] > self.split_threshold
                          and unclaimed(e)),
                         key=lambda x: -x["size"])
            for e in big:
                if free[s] <= 0 or reg_room <= 0:
                    break
                if shed_replicas(s, e["keymax"]):
                    continue
                mid = cl.middle_item(s, e["head_idx"])
                if mid is None:
                    continue
                if cl.split(s, e["keymax"], mid):
                    issued["split"] += 1
                    free[s] -= 1
                    reg_room -= 1
                    claimed[s].add(e["keymax"])

            # 2) move sublists off an overloaded shard; the working
            # ``loads`` snapshot is adjusted per issued move so parallel
            # donors (and repeated moves within this pass) spread over
            # *currently* least-loaded targets instead of dogpiling the
            # pass-start minimum
            while (len(targets) > 1 and free[s] > 0
                   and loads[s] > self.move_headroom * mean):
                cands = [e for e in entries if unclaimed(e)]
                if not cands:
                    break
                tgt = pick_target(s)
                if tgt is None or loads[s] - loads[tgt] <= 1:
                    break
                # move the sublist that best evens the load — but only
                # if it strictly improves the pairwise imbalance (else a
                # lone big sublist ping-pongs between shards forever)
                gap = (loads[s] - loads[tgt]) / 2
                e = min(cands, key=lambda x: abs(eload(x) - gap))
                if loads[tgt] + eload(e) >= loads[s]:
                    break
                if shed_replicas(s, e["keymax"]):
                    # replicas retire first; the move is re-evaluated on a
                    # later pass once the entry is replica-free
                    entries = [x for x in entries if x is not e]
                    continue
                if not cl.move(s, e["keymax"], tgt):
                    break
                issued["move"] += 1
                free[s] -= 1
                claimed[s].add(e["keymax"])
                loads[s] -= eload(e)
                loads[tgt] += eload(e)
                entries = [x for x in entries if x is not e]

            # 3) merge adjacent runts on the same shard
            if self.merge_threshold > 0:
                entries_sorted = sorted(entries, key=lambda x: x["keymin"])
                for a, b in zip(entries_sorted, entries_sorted[1:]):
                    if free[s] <= 0:
                        break
                    if (a["keymax"] == b["keymin"]
                            and a["size"] + b["size"] < self.merge_threshold
                            and unclaimed(a) and unclaimed(b)):
                        if (shed_replicas(s, a["keymax"])
                                or shed_replicas(s, b["keymax"])):
                            continue
                        if cl.merge(s, a["keymax"], b["keymax"]):
                            issued["merge"] += 1
                            free[s] -= 1
                            claimed[s].add(a["keymax"])
                            claimed[s].add(b["keymax"])

            # 4) hot-sublist read replication (§15): entries whose op-rate
            # EWMA crossed the hot threshold get read replicas on the
            # least-loaded other shards; entries that cooled below the
            # (lower) cold threshold shed theirs. Claimed/switched entries
            # are skipped — a sublist mid-restructure is about to change
            # hands, and replicate-then-drop within one pass is churn.
            if rep_on and len(targets) > 1:
                total_rate = sum(rates.values())
                for e in entries:
                    kmax = e["keymax"]
                    if not unclaimed(e):
                        continue
                    r = rates.get(kmax, 0.0)
                    share = r / total_rate if total_rate > 0 else 0.0
                    have = set(repsets.get(kmax, (0, 0, []))[2])
                    if r >= self.hot_rate and share >= self.hot_share:
                        cands = sorted((d for d in targets
                                        if d != s and d not in have),
                                       key=lambda d: loads[d])
                        want = self.replica_fanout - len(have)
                        for tgt in cands[:max(want, 0)]:
                            if cl.replicate(s, kmax, tgt):
                                issued["replicate"] += 1
                                have.add(tgt)
                            else:
                                break   # session table full: stop asking
                    elif have and r <= self.cold_rate:
                        if cl.drop_replica(s, kmax):
                            issued["drop"] += 1
                        repsets.pop(kmax, None)
        return issued


class AutoscalePolicy:
    """Elastic sizing over a membership-aware backend (DESIGN.md §13):
    the human does not choose the shard count.

    Wraps a ``Balancer`` — every pass first runs the inner policy (splits,
    moves, evacuations), then considers at most *one* membership change:

      * **join** when total load exceeds ``join_headroom`` (125%) of what
        the current active set should carry at ``target_load`` keys per
        shard — a retired slot is admitted and the inner balancer's next
        passes drain sublists onto it;
      * **retire** the least-loaded active shard when total load falls
        below ``retire_headroom`` (45%) of the active set's target
        capacity.

    The wide hysteresis band between the two thresholds, plus a
    ``cooldown`` of quiet passes after every change and the one-change-
    at-a-time rule (no decision while any shard is joining or draining),
    keeps the policy from flapping when load hovers near a boundary.

    Returned counts include ``join``/``retire``, so ``DiLiClient.settle``
    treats a pass that resized the cluster as progress, not a fixed point.
    """

    def __init__(self, backend, *, target_load: int,
                 join_headroom: float = 1.25, retire_headroom: float = 0.45,
                 min_shards: int = 1, max_shards: Optional[int] = None,
                 cooldown: int = 3, balancer: Optional[Balancer] = None,
                 rng=None, rate_weight: float = 1.0):
        if not hasattr(backend, "membership"):
            raise ValueError(
                "AutoscalePolicy needs a membership-aware backend "
                "(Cluster / LocalBackend)")
        self.cl = backend
        self.balancer = (balancer if balancer is not None
                         else Balancer(backend, rng=rng,
                                       rate_weight=rate_weight))
        self.target_load = int(target_load)
        self.join_headroom = float(join_headroom)
        self.retire_headroom = float(retire_headroom)
        self.min_shards = int(min_shards)
        self.max_shards = max_shards
        self.cooldown = int(cooldown)
        # same load model as the inner balancer: op-rate EWMA weighted on
        # top of the key count (rate decays to zero at rest, where the
        # sizing decision falls back to pure key counts)
        self.rate_weight = float(rate_weight)
        self._cool = 0

    def _load(self, s: int) -> float:
        rates = getattr(self.cl, "op_rate_ewma", None) or {}
        return sum(e["size"] + self.rate_weight
                   * rates.get(e["keymax"], 0.0)
                   for e in self.cl.sublists(s)
                   if e["owner"] == s and e["size"] is not None
                   and not e["switched"])

    def step(self) -> dict:
        issued = self.balancer.step()
        issued.setdefault("join", 0)
        issued.setdefault("retire", 0)
        mb = self.cl.membership
        if self._cool > 0:
            # a cooling pass is NOT a fixed point — without the marker,
            # DiLiClient.settle would read the all-zero counts as "done"
            # and stop before the post-cooldown decision ever runs
            self._cool -= 1
            issued["cooldown"] = 1
            return issued
        if mb.joining or mb.draining:
            # one membership change at a time: the previous one must
            # finish (promote / retire) before the next decision —
            # marked as progress for the same reason as cooldown
            issued["inflight"] = 1
            return issued
        loads = {s: self._load(s) for s in mb.active}
        total = sum(loads.values())
        n = len(mb.active)
        cap = mb.capacity if self.max_shards is None else self.max_shards
        if (total > self.join_headroom * self.target_load * n
                and n < cap and mb.retired):
            self.cl.join_shard()
            issued["join"] += 1
            self._cool = self.cooldown
        elif (total < self.retire_headroom * self.target_load * n
                and n > self.min_shards):
            victim = min(mb.active, key=lambda s: (loads[s], s))
            self.cl.retire_shard(victim)
            issued["retire"] += 1
            self._cool = self.cooldown
        return issued
