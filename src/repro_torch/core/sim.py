"""Cluster simulator: N shards, reliable FIFO routing, round-based execution.

The single-host execution backend of the port. Each round every shard runs
``shard.shard_round`` on its inbox (state on the cluster's device), then
outboxes are routed host-side into next-round inboxes (per-(src,dst) FIFO
preserved; overflow is backlogged, never dropped). With ``delay_prob > 0``
whole (src,dst) channels are held back for a round, deterministically
under ``seed``.

With ``nemesis=NemesisConfig(...)`` the cluster routes through the
reliable transport (``core.net``, DESIGN.md §11): the wire below it may
drop, duplicate, reorder and delay frames, and the transport restores
exactly-once in-order delivery. ``CrashPlan``s kill and restart shards,
which recover from a per-shard WAL and snapshots (``core.durability``,
§14); ``join_shard``/``retire_shard`` change membership under traffic
(§13). Every random stream is spawned from one root ``SeedSequence``
exactly as in the reference, so a run — its per-round ``round_trace``
included — is a pure function of ``(seed, config)`` and equal to the
reference's line for line.

RANGE scans (DESIGN.md §16) complete here: item rows accumulate until the
terminal count says the set is whole. Background Split, Move and Merge
are host commands that claim a slot of a shard's table (``split``,
``move``, ``merge``). Read replication (DESIGN.md §15) is driven by the
``replicate``/``drop_replica`` commands, journaled like them;
``replica_sets`` is the routing view clients read.
"""
from __future__ import annotations

import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import timing
from . import bg as B
from . import messages as M
from . import range_scan as RS
from . import refs
from . import registry as reg_ops
from . import replica as R
from .durability import Durability, validate_crash_plans, wal
from .durability.recovery import completions_array
from .host import to_numpy as _np
from .membership import (Membership, epoch_broadcast, moves_targeting,
                         owned_entry_count)
from .net import Nemesis, NemesisConfig, Transport, trace_entry
from .shard import shard_round
from .types import (DiLiConfig, KEY_MAX, KEY_MIN, SH_KEY, ST_KEY,
                    ShardState, init_shard, resolve_device)

_NO_ROWS = np.zeros((0, M.FIELDS), np.int32)


class OutboxOverflow(RuntimeError):
    """A shard emitted more messages in one round than ``mailbox_cap``."""


# ------------------------------------------------------ client-op plumbing

class OpIdAllocator:
    """Op ids for the int32 ``F_TS`` message lane, with recycling."""

    def __init__(self):
        self.next_id = 0
        self.free: List[int] = []

    def alloc(self) -> int:
        if self.free:
            return self.free.pop()
        if self.next_id >= np.iinfo(np.int32).max:
            raise RuntimeError(
                "op-id space exhausted: op ids are int32 message lanes and "
                "would wrap — drain results (take_result / backend.step) "
                "so ids recycle")
        nid = self.next_id
        self.next_id += 1
        return nid

    def release(self, op_id: int) -> None:
        self.free.append(op_id)


def materialize_ops(kinds, keys, values):
    """Materialize (once) and length-check a client op batch."""
    kinds = [int(k) for k in kinds]
    keys = [int(k) for k in keys]
    if len(kinds) != len(keys):
        raise ValueError(f"submit: {len(kinds)} kinds vs {len(keys)} keys")
    values = ([0] * len(keys) if values is None
              else [int(v) for v in values])
    if len(values) != len(keys):
        raise ValueError(f"submit: {len(values)} values vs {len(keys)} keys")
    return kinds, keys, values


def make_op_row(shard: int, kind: int, key: int, val: int,
                slot: int) -> np.ndarray:
    """One fresh MSG_OP row addressed at server ``shard`` (null subhead
    hint; reply shard = ``shard``)."""
    row = np.zeros((M.FIELDS,), np.int32)
    row[M.F_KIND] = M.MSG_OP
    row[M.F_DST] = shard
    row[M.F_SRC] = shard
    row[M.F_A] = kind
    row[M.F_KEY] = key
    row[M.F_REF1] = refs.NULL_REF
    row[M.F_SID] = shard
    row[M.F_TS] = slot
    row[M.F_VAL] = val
    return row


# ------------------------------------------------------- state inspection

def host_view(state: ShardState) -> dict:
    """The columns the chain and registry walkers read, as numpy arrays
    (one device-to-host copy each)."""
    reg = state.registry
    return dict(nxt=_np(state.pool.nxt), key=_np(state.pool.key),
                vals=_np(state.pool.keymax), ctr=_np(state.pool.ctr),
                stct=_np(state.stct), keymin=_np(reg.keymin),
                keymax=_np(reg.keymax), subhead=_np(reg.subhead),
                size=int(_np(reg.size)))


def chain_keys(cfg: DiLiConfig, states: Sequence[ShardState], s: int,
               head_idx: int, include_meta: bool = False, view=None):
    """Walk a chain from a subhead; returns live keys, or (key, idx, value)
    triples with ``include_meta``. Raises on a walk longer than the pool
    (a cyclic or corrupted chain) instead of returning a silent prefix."""
    v = view if view is not None else host_view(states[s])
    nxt, key, vals = v["nxt"], v["key"], v["vals"]
    out = []
    ref = int(nxt[head_idx])
    for _ in range(int(cfg.pool_capacity) + 2):
        idx = refs.ref_idx(ref)
        if idx == refs.NULL_IDX or refs.ref_sid(ref) != s:
            break
        k = int(key[idx])
        if k == ST_KEY:
            break
        if k != SH_KEY and not refs.ref_mark(int(nxt[idx])):
            out.append((k, idx, int(vals[idx])) if include_meta else k)
        ref = int(nxt[idx])
    else:
        raise RuntimeError(
            f"shard {s} chain from head {head_idx} did not terminate "
            f"within pool_capacity={int(cfg.pool_capacity)} steps "
            f"— cyclic or corrupted chain")
    return out


def state_sublists(cfg: DiLiConfig, states: Sequence[ShardState], s: int,
                   view=None):
    """(keymin, keymax, owner, size, head_idx, switched) per entry of
    shard s's registry replica; ``size`` is None for entries owned
    elsewhere."""
    v = view if view is not None else host_view(states[s])
    out = []
    for e in range(v["size"]):
        sh = int(v["subhead"][e])
        sid = refs.ref_sid(sh)
        head_idx = refs.ref_idx(sh)
        size = None
        switched = False
        if sid == s:
            size = len(chain_keys(cfg, states, s, head_idx, view=v))
            switched = int(v["stct"][int(v["ctr"][head_idx])]) < 0
        out.append(dict(keymin=int(v["keymin"][e]),
                        keymax=int(v["keymax"][e]), owner=int(sid),
                        size=size, head_idx=int(head_idx),
                        switched=switched))
    return out


def global_keys(cfg: DiLiConfig, states: Sequence[ShardState],
                views=None) -> List[int]:
    """Global key set: union over every shard's owned, non-switched
    sublists."""
    keys: List[int] = []
    for s in range(len(states)):
        v = views[s] if views is not None else host_view(states[s])
        for e in state_sublists(cfg, states, s, view=v):
            if e["owner"] != s or e["switched"]:
                continue
            keys.extend(chain_keys(cfg, states, s, e["head_idx"], view=v))
    return sorted(keys)


def registry_entries(state: ShardState):
    """One shard's registry replica as (keymin, keymax, owner) triples,
    sorted by keymin."""
    reg = state.registry
    size = int(_np(reg.size))
    kmin = _np(reg.keymin)[:size]
    kmax = _np(reg.keymax)[:size]
    owner = refs.ref_sid(_np(reg.subhead)[:size])
    return [(int(a), int(b), int(o)) for a, b, o in zip(kmin, kmax, owner)]


class Cluster:
    def __init__(self, cfg: DiLiConfig, *, seed: int = 0,
                 delay_prob: float = 0.0,
                 nemesis: Optional[NemesisConfig] = None,
                 retransmit_after: int = 4, net_window: int = 4096,
                 trace: Optional[bool] = None,
                 key_lo: int = KEY_MIN, key_hi: int = KEY_MAX,
                 initial_shards: Optional[int] = None,
                 durability=None, device="cuda", timer=None):
        self.cfg = cfg
        self.n = cfg.num_shards
        self.device = resolve_device(device)
        self.timer = timer
        # elastic membership (DESIGN.md §13): cfg.num_shards is the
        # capacity; every capacity shard is constructed and stepped each
        # round, and which of them are members is a host-side overlay.
        # initial_shards=None means all-active
        self.membership = Membership(self.n, initial_shards)
        self._mb_logged = 0
        # host->shard control rows (MSG_EPOCH broadcasts) staged between
        # rounds; flushed into the routed message stream in step() so they
        # ride the same (partitionable, retransmitted) wire as the rest
        self._ctrl_out: List[Tuple[int, np.ndarray]] = []
        # shard 0 bootstraps the full key range; the others (initially
        # retired slots too) hold registry replicas routing to it
        peers0 = self.membership.mask()
        self.states: List[ShardState] = [
            init_shard(cfg, s, bootstrap=(s == 0), key_lo=key_lo,
                       key_hi=key_hi, peers_mask=peers0, device=self.device)
            for s in range(self.n)
        ]
        for s in range(1, self.n):
            st = self.states[s]
            reg = reg_ops.add_entry(st.registry, key_lo - 1, key_hi,
                                    refs.make_ref(0, 0), refs.make_ref(0, 1),
                                    0, 0)
            self.states[s] = st._replace(registry=reg)
        self.bgs: List[B.BgTable] = [B.init_bg_table(cfg, self.device)
                                     for _ in range(self.n)]
        self.in_cap = max(cfg.mailbox_cap * self.n, cfg.batch_size * 2)
        self.backlog = [np.zeros((0, M.FIELDS), np.int32)
                        for _ in range(self.n)]
        self.results: Dict[int, int] = {}
        self.result_src: Dict[int, int] = {}
        self.last_completions: List[Tuple[int, int, int]] = []
        self._ids = OpIdAllocator()
        self._pending_ops: Dict[int, Tuple[int, int]] = {}
        # RANGE scans in flight (DESIGN.md §16): item rows accumulate in
        # ``_range_parts`` until the terminal result's count says the set
        # is complete
        self._range_ops: set = set()
        self._range_parts: Dict[int, List[Tuple[int, int]]] = {}
        self._range_done: Dict[int, Tuple[int, int]] = {}
        self._views: Dict[int, dict] = {}
        self.round_no = 0
        self.delay_prob = delay_prob
        # one splittable root, as in the reference: independent child
        # streams for channel delays, the nemesis and balancer tie-breaks,
        # so a run (and its round_trace) is a pure function of
        # (seed, config)
        self.seed = seed
        root = np.random.SeedSequence(seed)
        delay_ss, nemesis_ss, balancer_ss = root.spawn(3)
        self.rng = np.random.default_rng(delay_ss)
        self.balancer_rng = np.random.default_rng(balancer_ss)
        self.nemesis_config = nemesis
        self.net: Optional[Transport] = None
        if nemesis is not None:
            if delay_prob > 0.0:
                # the channel-hold knob is replaced wholesale by transport
                # routing; accepting both would silently run weaker fault
                # injection than asked for
                raise ValueError(
                    "delay_prob and nemesis are mutually exclusive — "
                    "use NemesisConfig.delay_prob for delays under the "
                    "reliable transport")
            self.net = Transport(
                self.n, Nemesis(nemesis, np.random.default_rng(nemesis_ss)),
                retransmit_after=retransmit_after, window=net_window)
        # durability (DESIGN.md §14): per-shard WAL + snapshots. Crash
        # plans require it, so a run with crashes and no explicit store
        # gets an ephemeral tempdir. ``durability`` accepts a directory
        # path, a Durability, or None
        self._crash_plans = tuple(nemesis.crashes) if nemesis else ()
        if self._crash_plans:
            validate_crash_plans(self._crash_plans, self.n)
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
            for s in range(self.n):
                self.durability.ensure_genesis(
                    s, self.states[s], self.bgs[s], self.backlog[s],
                    self._lane_image(s))
        # per-round observable-outcome trace, the replay witness: on by
        # default for nemesis runs, off on the clean path
        self.trace_enabled = (nemesis is not None) if trace is None \
            else bool(trace)
        self.round_trace: List[str] = []
        self.stats = {"max_outbox": 0, "max_hops": 0, "rounds": 0,
                      "fast_hits": 0, "mut_hits": 0, "delegated": 0,
                      "move_hits": 0, "blk_hits": 0, "max_bg_active": 0,
                      "rep_hits": 0, "range_hits": 0}
        # per-entry op-rate EWMA (keyed by entry keymax) — the balancer's
        # load signal, fed from every round's RoundOut.ent_hits
        self.op_rate_ewma: Dict[int, float] = {}
        # per-shard EWMA of replica-served FINDs (keyed by shard id): the
        # balancer folds it into shard load so serving replicas do not
        # read as idle
        self.rep_rate_ewma: Dict[int, float] = {}
        # host-authoritative replica map (keymax -> (primary, targets)),
        # kept by replicate/drop_replica; replica_epoch bumps on every
        # change so clients know to refresh their routing
        self._replica_map: Dict[int, Tuple[int, set]] = {}
        self.replica_epoch = 0

    # ------------------------------------------------------------ client API
    def submit(self, shard: int, kinds: Sequence[int], keys: Sequence[int],
               values: Optional[Sequence[int]] = None) -> List[int]:
        """Enqueue fresh client ops at server ``shard``; returns op ids.
        Results appear in ``self.results`` once linearized. With
        durability on, the rows are journaled before the ids are handed
        out."""
        if not self.membership.is_routable(shard):
            raise ValueError(
                f"submit: shard {shard} is "
                f"{self.membership.state_of(shard)} at epoch "
                f"{self.membership.epoch} — route ops to one of "
                f"{self.membership.routable}")
        kinds, keys, values = materialize_ops(kinds, keys, values)
        ids = []
        rows = []
        for kind, key, val in zip(kinds, keys, values):
            slot = self._ids.alloc()
            rows.append(make_op_row(shard, kind, key, val, slot))
            ids.append(slot)
            self._pending_ops[slot] = (kind, key)
        if rows:
            self.backlog[shard] = np.concatenate(
                [self.backlog[shard], np.stack(rows)], axis=0)
            if self.durability is not None:
                self.durability.log_submit(shard, self.round_no,
                                           np.stack(rows))
        return ids

    def submit_range(self, shard: int, lo: int, hi: int, limit: int) -> int:
        """Enqueue a RANGE(lo, hi, limit) scan at server ``shard``
        (DESIGN.md §16): all keys in ``[lo, hi)``, at most ``limit`` of
        them. Returns an op id; the result value is the item count and
        ``take_range_items`` pops the (key, value) pairs — call it
        *before* ``take_result`` recycles the id."""
        if not self.cfg.range_scan:
            raise ValueError(
                "submit_range: cfg.range_scan is off — the RANGE pre-pass "
                "and serial walk are off in shard_round")
        if not self.membership.is_routable(shard):
            raise ValueError(
                f"submit_range: shard {shard} is "
                f"{self.membership.state_of(shard)} at epoch "
                f"{self.membership.epoch} — route ops to one of "
                f"{self.membership.routable}")
        lo, hi, limit = int(lo), int(hi), int(limit)
        if lo < KEY_MIN or hi > KEY_MAX + 1 or limit < 1:
            raise ValueError(
                f"submit_range: span [{lo}, {hi}) / limit {limit} out "
                f"of bounds (keys in [{KEY_MIN}, {KEY_MAX}], limit >= 1)")
        slot = self._ids.alloc()
        row = RS.make_range_row(shard, lo, hi, limit, slot)
        self.backlog[shard] = np.concatenate(
            [self.backlog[shard], row[None]], axis=0)
        if self.durability is not None:
            self.durability.log_submit(shard, self.round_no, row[None])
        self._pending_ops[slot] = (-1, lo)
        self._range_ops.add(slot)
        self._range_parts[slot] = []
        return slot

    def take_range_items(self, op_id: int) -> List[Tuple[int, int]]:
        """Pop a completed RANGE's (key, value) pairs, sorted by key."""
        return sorted(self._range_parts.pop(op_id, []))

    def take_result(self, op_id: int) -> int:
        """Pop a completed op's result and recycle its id (KeyError while
        the op is still pending)."""
        val = self.results.pop(op_id)
        self.result_src.pop(op_id, None)
        # a recycled id must not inherit a stale scan's items
        self._range_parts.pop(op_id, None)
        self._range_ops.discard(op_id)
        self._ids.release(op_id)
        return val

    # ------------------------------------------------- membership (§13)
    def join_shard(self, shard: Optional[int] = None) -> int:
        """Admit a retired capacity slot as a JOINING member (empty — the
        balancer drains sublists onto it; the host promotes it to ACTIVE
        once it owns one). Returns the joined shard id."""
        s = self.membership.begin_join(shard)
        self._broadcast_epoch()
        return s

    def retire_shard(self, shard: int) -> None:
        """Begin draining ``shard``: the balancer evacuates every sublist
        it owns, it keeps executing (delegations in flight must land), and
        the host retires it — resetting its transport lanes — once
        ``_drain_complete`` proves nothing can still reach it."""
        self.membership.begin_drain(shard)
        self._broadcast_epoch()

    def _broadcast_epoch(self) -> None:
        """Stage a MSG_EPOCH announcement to every capacity slot, from the
        lowest *active* shard (never a draining one, whose retirement
        waits on its lanes going idle)."""
        rows = epoch_broadcast(self.membership)
        src = int(min(self.membership.active))
        self._ctrl_out.append((src, np.stack(rows).astype(np.int32)))

    def _drain_complete(self, s: int) -> bool:
        """True when retiring ``s`` can strand nothing: it owns no
        sublist, runs no bg op, no peer's in-flight Move targets it, no
        queued/staged row can still be delivered to it, and every
        transport lane touching it is idle (incl. nemesis-held frames)."""
        if owned_entry_count(self.cfg, self.states, s) != 0:
            return False
        if B.any_active(self.bgs[s]):
            return False
        if moves_targeting(self.bgs, s) != 0:
            return False
        if self.backlog[s].shape[0]:
            return False
        if self._ctrl_out:
            return False
        if self.net is not None and not self.net.shard_idle(s):
            return False
        return True

    def _membership_maintenance(self) -> None:
        """Host-driven lifecycle advance, once per round (a pure function
        of post-round state): promotes joining shards that own their first
        sublist; retires draining shards whose drain is complete,
        resetting their lanes before announcing."""
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

    # ------------------------------------------------- crash-restart (§14)
    def _lane_image(self, s: int) -> Dict[str, np.ndarray]:
        return (self.net.export_shard_lanes(s)
                if self.net is not None else {})

    def _down(self):
        return self.net.down if self.net is not None else ()

    def _apply_crash_plans(self) -> None:
        """Execute due CrashPlans at the top of the round. Restarts run
        before crashes so a plan pair sharing a round boundary recovers
        one shard while killing another deterministically."""
        for c in self._crash_plans:
            if c.restart_round == self.round_no and c.shard in self._down():
                self._restart_shard(c.shard)
        for c in self._crash_plans:
            if c.crash_round == self.round_no:
                self._crash_shard(c.shard)

    def _crash_shard(self, s: int) -> None:
        """kill -9: the shard's state, BgTable, host backlog and its
        halves of every transport lane vanish. Durable WAL + snapshots
        (and everything client-side) survive."""
        self.membership.crash(s)
        if not self.membership.active:
            raise RuntimeError(
                f"crash of shard {s} leaves no active shard — the "
                f"coordinator for epoch broadcasts must survive")
        self._broadcast_epoch()
        self.states[s] = init_shard(self.cfg, s, peers_mask=0,
                                    device=self.device)
        self.bgs[s] = B.init_bg_table(self.cfg, self.device)
        self.backlog[s] = np.zeros((0, M.FIELDS), np.int32)
        self.net.crash_shard(s)

    def _restart_shard(self, s: int) -> None:
        """Recovery: snapshot + WAL replay rebuilds the shard on the
        cluster's device at its last durable round; the lane image re-arms
        its retransmit rings and receiver cursors. The shard re-enters as
        JOINING-with-state, and host maintenance promotes it back."""
        rec = self.durability.recover(s, in_cap=self.in_cap,
                                      device=self.device)
        self.states[s] = rec.state
        self.bgs[s] = rec.bg
        self.backlog[s] = rec.backlog
        self.net.restart_shard(s, rec.lanes)
        self.membership.restart(s)
        self._broadcast_epoch()
        # fresh durable base: the replayed suffix is now redundant
        self.durability.snapshot_now(s, self.round_no - 1, self.states[s],
                                     self.bgs[s], self.backlog[s],
                                     self._lane_image(s))

    # ------------------------------------------------------------- execution
    def step(self) -> int:
        """One synchronized round across all shards. Returns #completed.
        The order is the reference's: crash plans, the feed, the shard
        rounds, harvest, control rows, routing, membership maintenance,
        the WAL and snapshots, the trace."""
        cfg = self.cfg
        self._views.clear()
        self._apply_crash_plans()
        down = self._down()
        outs = []
        for s in range(self.n):
            if s in down:
                outs.append(None)
                continue
            # feed: backlog first (FIFO), bounded by in_cap
            feed = self.backlog[s][:self.in_cap]
            self.backlog[s] = self.backlog[s][self.in_cap:]
            inbox = np.zeros((self.in_cap, M.FIELDS), np.int32)
            inbox[:feed.shape[0]] = feed
            outs.append(shard_round(self.states[s], self.bgs[s], s, inbox,
                                    _NO_ROWS, cfg, timer=self.timer))

        with timing.tracer(self.timer)("host_routing"):
            ndone = self._harvest(outs, down)
        self.round_no += 1
        self.stats["rounds"] += 1
        return ndone

    def _harvest(self, outs, down) -> int:
        cfg = self.cfg
        ndone = 0
        self.last_completions = []
        new_msgs: List[Tuple[int, np.ndarray]] = []
        out_counts: List[int] = []
        comp_by_shard: List[np.ndarray] = []
        ent_rates: Dict[int, int] = {}
        rep_served: Dict[int, int] = {}
        for s, out in enumerate(outs):
            if out is None:                      # crashed: emitted nothing
                out_counts.append(0)
                comp_by_shard.append(np.zeros((0, 4), np.int32))
                continue
            self.states[s] = out.state
            self.bgs[s] = out.bg
            self.stats["fast_hits"] += int(out.fast_hits)
            self.stats["mut_hits"] += int(out.mut_hits)
            self.stats["move_hits"] += int(out.move_hits)
            self.stats["blk_hits"] += int(out.blk_hits)
            rh = int(out.rep_hits)
            self.stats["rep_hits"] += rh
            if rh:
                rep_served[s] = rep_served.get(s, 0) + rh
            self.stats["range_hits"] += int(out.range_hits)
            self.stats["max_bg_active"] = max(self.stats["max_bg_active"],
                                              int(out.bg_active))
            hits = _np(out.ent_hits)
            nz = np.nonzero(hits)[0]
            if nz.size:
                kmax = _np(out.state.registry.keymax)
                for e in nz:
                    k = int(kmax[e])
                    if k != ST_KEY:
                        ent_rates[k] = ent_rates.get(k, 0) + int(hits[e])
            cnt = int(out.out_count)
            out_counts.append(cnt)
            self.stats["max_outbox"] = max(self.stats["max_outbox"], cnt)
            if cnt > cfg.mailbox_cap:
                raise OutboxOverflow(
                    f"shard {s} emitted {cnt} messages in round "
                    f"{self.round_no}, mailbox_cap={cfg.mailbox_cap}: "
                    f"{cnt - cfg.mailbox_cap} rows dropped — raise "
                    f"mailbox_cap or reduce the per-round feed")
            ob = _np(out.outbox)[:cnt]
            if ob.size:
                new_msgs.append((s, ob))
                hops = ob[ob[:, M.F_KIND] == M.MSG_OP, M.F_X2]
                if hops.size:
                    self.stats["max_hops"] = max(self.stats["max_hops"],
                                                 int(hops.max()))
                    self.stats["delegated"] += int(hops.size)
            comp = completions_array(out)
            comp_by_shard.append(comp)
            for slot, val, src, key in comp.tolist():
                if key != SH_KEY:
                    # one RANGE item — accumulate; publication waits for
                    # the terminal count
                    self._range_parts.setdefault(slot, []).append(
                        (key, val))
                    continue
                if slot in self._range_ops:
                    # terminal scan result: F_A is the total item count
                    self._range_done[slot] = (val, src)
                    continue
                self.results[slot] = val
                self.result_src[slot] = src
                self.last_completions.append((slot, val, src))
                self._pending_ops.pop(slot, None)
                ndone += 1
        ndone += self._publish_ranges()

        # per-entry op-rate EWMA update (once per round)
        alpha = 0.3
        nxt_rates: Dict[int, float] = {}
        for k, v in self.op_rate_ewma.items():
            d = v * (1.0 - alpha)
            if d > 1e-3:
                nxt_rates[k] = d
        for k, h in ent_rates.items():
            nxt_rates[k] = nxt_rates.get(k, 0.0) + alpha * h
        self.op_rate_ewma = nxt_rates
        # per-shard replica-service EWMA: FINDs served from replicas are
        # real load the entry rates (keyed on the primary) do not see
        nxt_rep: Dict[int, float] = {}
        for s2, v in self.rep_rate_ewma.items():
            d = v * (1.0 - alpha)
            if d > 1e-3:
                nxt_rep[s2] = d
        for s2, h in rep_served.items():
            nxt_rep[s2] = nxt_rep.get(s2, 0.0) + alpha * h
        self.rep_rate_ewma = nxt_rep

        # host->shard membership announcements join the routed stream
        # after the shard outboxes, so they are partitioned and
        # retransmitted like any protocol message
        if self._ctrl_out:
            new_msgs.extend(self._ctrl_out)
            self._ctrl_out = []

        # ------------------------------------------------ route (FIFO/pair)
        pre_lens = [b.shape[0] for b in self.backlog]
        if self.net is not None:
            # reliable transport over the (possibly nemesis-perturbed)
            # wire; runs on quiet rounds too so retransmit timers, acks
            # and delayed frames keep moving
            self.net.route_round(self.backlog, new_msgs, self.round_no)
        elif new_msgs:
            allm = np.concatenate([ob for _, ob in new_msgs], axis=0)
            for d in range(self.n):
                mine = allm[allm[:, M.F_DST] == d]
                if self.delay_prob > 0.0 and mine.size:
                    # hold back whole (src,dst) channels — preserves pair
                    # FIFO while exercising cross-pair reordering
                    srcs = np.unique(mine[:, M.F_SRC])
                    held = srcs[self.rng.random(srcs.shape) < self.delay_prob]
                    hold_mask = np.isin(mine[:, M.F_SRC], held)
                    later, now = mine[hold_mask], mine[~hold_mask]
                    self.backlog[d] = np.concatenate(
                        [self.backlog[d], now, later], axis=0)
                else:
                    self.backlog[d] = np.concatenate(
                        [self.backlog[d], mine], axis=0)
        self._membership_maintenance()
        if self.durability is not None:
            # journal the round per live shard: the inputs consumed, the
            # completions produced (replay audit) and the post-routing
            # lane image, synced before the next round's acks (§14)
            for s in range(self.n):
                if s in down:
                    continue
                self.durability.log_round(
                    s, self.round_no,
                    appends=self.backlog[s][pre_lens[s]:],
                    client=_NO_ROWS, comp=comp_by_shard[s],
                    bg_phases=B.slot_phases(self.bgs[s]),
                    epoch=int(self.states[s].epoch),
                    lanes=self._lane_image(s))
                self.durability.maybe_snapshot(
                    s, self.round_no, self.states[s], self.bgs[s],
                    self.backlog[s], self._lane_image(s))
        if self.trace_enabled:
            # membership transitions are part of the replay witness
            for ep, ev, sh in self.membership.log[self._mb_logged:]:
                self.round_trace.append(
                    f"r{self.round_no} mb {ev} s{sh} e{ep}")
            self._mb_logged = len(self.membership.log)
            self.round_trace.append(trace_entry(
                self.round_no, self.last_completions, out_counts,
                extra=sum(b.shape[0] for b in self.backlog)
                + (self.net.in_flight() if self.net is not None else 0)))
        return ndone

    def _publish_ranges(self) -> int:
        """Publish RANGE completions whose item parts have all arrived.
        The terminal count, not arrival order, gates publication; a
        negative count is an error result (e.g. RES_OVERFLOW) and
        publishes at once."""
        n = 0
        for slot, (total, src) in list(self._range_done.items()):
            if total >= 0 and len(self._range_parts.get(slot, ())) < total:
                continue
            self.results[slot] = total
            self.result_src[slot] = src
            self.last_completions.append((slot, total, src))
            self._pending_ops.pop(slot, None)
            del self._range_done[slot]
            n += 1
        return n

    def run(self, rounds: int) -> None:
        for _ in range(rounds):
            self.step()

    def run_until_quiet(self, max_rounds: int = 200) -> None:
        """Step until no messages are in flight, all bg ops are idle and
        no shard is down."""
        for _ in range(max_rounds):
            self.step()
            busy = any(b.shape[0] for b in self.backlog)
            busy = busy or any(B.any_active(bg) for bg in self.bgs)
            busy = busy or bool(self._pending_ops)
            busy = busy or bool(self._ctrl_out)
            busy = busy or (self.net is not None and not self.net.idle())
            # a crashed shard is not quiet: keep stepping toward its
            # scheduled restart
            busy = busy or bool(self.membership.crashed)
            if not busy:
                return
        raise RuntimeError(
            f"cluster did not quiesce: backlog="
            f"{[b.shape[0] for b in self.backlog]} "
            f"bg={[B.slot_phases(bg).tolist() for bg in self.bgs]} "
            f"pending={len(self._pending_ops)} "
            f"net={self.net.in_flight() if self.net is not None else 0}")

    # ----------------------------------------------------------- inspection
    def _view(self, s: int) -> dict:
        """Host copy of shard s's walker columns, reused until the next
        round changes the state."""
        if s not in self._views:
            self._views[s] = host_view(self.states[s])
        return self._views[s]

    def shard_chain(self, s: int, head_idx: int, include_meta=False):
        return chain_keys(self.cfg, self.states, s, head_idx, include_meta,
                          view=self._view(s))

    def all_keys(self) -> List[int]:
        return global_keys(self.cfg, self.states,
                           views=[self._view(s) for s in range(self.n)])

    def sublists(self, s: int):
        return state_sublists(self.cfg, self.states, s, view=self._view(s))

    def registry_entries(self, s: int = 0):
        return registry_entries(self.states[s])

    # ---------------------------------------------------------- bg commands
    # Each returns True if a slot accepted the command, False if it was
    # dropped; with durability on it is journaled (wal.KIND_COMMAND),
    # since it edits the BgTable outside the inbox.
    def split(self, s: int, entry_keymax: int, sitem_idx: int) -> bool:
        self.bgs[s], ok = B.queue_split(self.bgs[s], entry_keymax, sitem_idx)
        self._log_command(s, wal.CMD_SPLIT, (entry_keymax, sitem_idx), ok)
        return bool(ok)

    def move(self, s: int, entry_keymax: int, target: int) -> bool:
        self.bgs[s], ok = B.queue_move(self.bgs[s], entry_keymax, target)
        self._log_command(s, wal.CMD_MOVE, (entry_keymax, target), ok)
        return bool(ok)

    def merge(self, s: int, left_keymax: int, right_keymax: int) -> bool:
        self.bgs[s], ok = B.queue_merge(self.bgs[s], left_keymax,
                                        right_keymax)
        self._log_command(s, wal.CMD_MERGE, (left_keymax, right_keymax), ok)
        return bool(ok)

    def _log_command(self, s: int, cmd: int, args, ok) -> None:
        if self.durability is not None:
            self.durability.log_command(s, self.round_no, cmd, args,
                                        bool(ok))

    def replicate(self, s: int, entry_keymax: int, target: int) -> bool:
        """Start (or widen) read replication of the entry ``s`` owns with
        upper bound ``entry_keymax`` onto shard ``target`` (§15): a host
        edit of the shard's sessions, journaled (``CMD_REPLICATE``) so
        recovery replays it."""
        if not self.cfg.replication:
            raise ValueError(
                "replicate: cfg.replication is off — replica serve and "
                "publication do not run in shard_round")
        self.states[s], ok = R.queue_replicate(
            self.states[s], self.cfg, entry_keymax, target)
        self._log_command(s, wal.CMD_REPLICATE, (entry_keymax, target), ok)
        if ok:
            _, tg = self._replica_map.get(entry_keymax, (s, set()))
            self._replica_map[int(entry_keymax)] = (s, set(tg) | {int(target)})
            self.replica_epoch += 1
        return ok

    def drop_replica(self, s: int, entry_keymax: int,
                     target: int = -1) -> bool:
        """Retire replicas of ``entry_keymax`` on ``target`` (-1 = all)."""
        if not self.cfg.replication:
            raise ValueError("drop_replica: cfg.replication is off")
        self.states[s], ok = R.queue_drop_replica(
            self.states[s], self.cfg, entry_keymax, target)
        self._log_command(s, wal.CMD_DROP_REPLICA,
                          (entry_keymax, target), ok)
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
        """Live replica routing view for clients: ``{keymax: (keymin,
        primary, [replica shards])}``. Entries whose primary no longer
        owns a matching registry entry are pruned (ownership moved; the
        session's self-audit drops those replicas anyway)."""
        out = {}
        stale = []
        for kmax, (prim, tg) in self._replica_map.items():
            reg = self.states[prim].registry
            kmaxes = _np(reg.keymax)[:int(reg.size)]
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

    def middle_item(self, s: int, head_idx: int) -> Optional[int]:
        """Pool idx of the middle live item of a sublist (split point)."""
        items = self.shard_chain(s, head_idx, include_meta=True)
        if len(items) < 2:
            return None
        return items[len(items) // 2][1]
