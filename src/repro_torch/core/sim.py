"""Cluster simulator: N shards, reliable FIFO routing, round-based execution.

The single-host execution backend of the port. Each round every shard runs
``shard.shard_round`` on its inbox (state on the cluster's device), then
outboxes are routed host-side into next-round inboxes (per-(src,dst) FIFO
preserved; overflow is backlogged, never dropped). With ``delay_prob > 0``
whole (src,dst) channels are held back for a round, deterministically
under ``seed``: every random stream is spawned from one root
``SeedSequence`` exactly as in the reference, so a run draws the same
numbers draw for draw.

RANGE scans (DESIGN.md §16) complete here: item rows accumulate until the
terminal count says the set is whole. Background Split, Move and Merge
are host commands that claim a slot of a shard's table (``split``,
``move``, ``merge``). This slice routes directly. The reliable transport
and nemesis, WAL durability (and with it the log of background commands),
elastic membership changes and read replication raise
``NotImplementedError`` until their slices land.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import bg as B
from . import messages as M
from . import range_scan as RS
from . import refs
from . import registry as reg_ops
from .membership import Membership
from .net.digest import trace_entry
from .shard import shard_round
from .types import (DiLiConfig, KEY_MAX, KEY_MIN, SH_KEY, ST_KEY,
                    ShardState, init_shard, resolve_device)

LATER_SLICE = "a later slice of the port (ROADMAP Queue 1)"


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

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


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
                 delay_prob: float = 0.0, nemesis=None,
                 trace: Optional[bool] = None,
                 key_lo: int = KEY_MIN, key_hi: int = KEY_MAX,
                 initial_shards: Optional[int] = None,
                 durability=None, device="cuda", timer=None):
        for name, val in (("nemesis", nemesis), ("durability", durability),
                          ("initial_shards", initial_shards)):
            if val is not None:
                raise NotImplementedError(
                    f"Cluster({name}=...) comes with {LATER_SLICE}")
        self.cfg = cfg
        self.n = cfg.num_shards
        self.device = resolve_device(device)
        self.timer = timer
        self.membership = Membership(self.n, None)
        peers0 = self.membership.mask()
        # shard 0 bootstraps the full key range; the others hold registry
        # replicas routing to it
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
        # streams for channel delays, the nemesis and balancer tie-breaks
        self.seed = seed
        root = np.random.SeedSequence(seed)
        delay_ss, _nemesis_ss, balancer_ss = root.spawn(3)
        self.rng = np.random.default_rng(delay_ss)
        self.balancer_rng = np.random.default_rng(balancer_ss)
        self.net = None
        self.trace_enabled = bool(trace)
        self.round_trace: List[str] = []
        self.stats = {"max_outbox": 0, "max_hops": 0, "rounds": 0,
                      "fast_hits": 0, "mut_hits": 0, "delegated": 0,
                      "move_hits": 0, "blk_hits": 0, "max_bg_active": 0,
                      "rep_hits": 0, "range_hits": 0}
        # per-entry op-rate EWMA (keyed by entry keymax) — the balancer's
        # load signal, fed from every round's RoundOut.ent_hits
        self.op_rate_ewma: Dict[int, float] = {}
        self.rep_rate_ewma: Dict[int, float] = {}
        self.replica_epoch = 0

    # ------------------------------------------------------------ client API
    def submit(self, shard: int, kinds: Sequence[int], keys: Sequence[int],
               values: Optional[Sequence[int]] = None) -> List[int]:
        """Enqueue fresh client ops at server ``shard``; returns op ids.
        Results appear in ``self.results`` once linearized."""
        if not self.membership.is_routable(shard):
            raise ValueError(f"submit: shard {shard} is not routable")
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
            raise ValueError(f"submit_range: shard {shard} is not routable")
        lo, hi, limit = int(lo), int(hi), int(limit)
        if lo < KEY_MIN or hi > KEY_MAX + 1 or limit < 1:
            raise ValueError(
                f"submit_range: span [{lo}, {hi}) / limit {limit} out "
                f"of bounds (keys in [{KEY_MIN}, {KEY_MAX}], limit >= 1)")
        slot = self._ids.alloc()
        row = RS.make_range_row(shard, lo, hi, limit, slot)
        self.backlog[shard] = np.concatenate(
            [self.backlog[shard], row[None]], axis=0)
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

    def join_shard(self, shard: Optional[int] = None) -> int:
        raise NotImplementedError(f"join_shard comes with {LATER_SLICE}")

    def retire_shard(self, shard: int) -> None:
        raise NotImplementedError(f"retire_shard comes with {LATER_SLICE}")

    # ------------------------------------------------------------- execution
    def step(self) -> int:
        """One synchronized round across all shards. Returns #completed."""
        cfg = self.cfg
        self._views.clear()
        outs = []
        for s in range(self.n):
            # feed: backlog first (FIFO), bounded by in_cap
            feed = self.backlog[s][:self.in_cap]
            self.backlog[s] = self.backlog[s][self.in_cap:]
            inbox = np.zeros((self.in_cap, M.FIELDS), np.int32)
            inbox[:feed.shape[0]] = feed
            outs.append(shard_round(self.states[s], self.bgs[s], s, inbox,
                                    np.zeros((0, M.FIELDS), np.int32), cfg,
                                    timer=self.timer))

        timer = self.timer or (lambda name: contextlib.nullcontext())
        with timer("host_routing"):
            ndone = self._harvest(outs)
        self.round_no += 1
        self.stats["rounds"] += 1
        return ndone

    def _harvest(self, outs) -> int:
        cfg = self.cfg
        ndone = 0
        self.last_completions = []
        new_msgs: List[Tuple[int, np.ndarray]] = []
        out_counts: List[int] = []
        ent_rates: Dict[int, int] = {}
        for s, out in enumerate(outs):
            self.states[s] = out.state
            self.bgs[s] = out.bg
            self.stats["fast_hits"] += int(out.fast_hits)
            self.stats["mut_hits"] += int(out.mut_hits)
            self.stats["move_hits"] += int(out.move_hits)
            self.stats["blk_hits"] += int(out.blk_hits)
            self.stats["rep_hits"] += int(out.rep_hits)
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
            cs, cv, cr, ck = (_np(out.comp_slot), _np(out.comp_val),
                              _np(out.comp_src), _np(out.comp_key))
            done = cs >= 0
            for slot, val, src, key in zip(cs[done], cv[done], cr[done],
                                           ck[done]):
                slot = int(slot)
                if int(key) != SH_KEY:
                    # one RANGE item — accumulate; publication waits for
                    # the terminal count
                    self._range_parts.setdefault(slot, []).append(
                        (int(key), int(val)))
                    continue
                if slot in self._range_ops:
                    # terminal scan result: F_A is the total item count
                    self._range_done[slot] = (int(val), int(src))
                    continue
                self.results[slot] = int(val)
                self.result_src[slot] = int(src)
                self.last_completions.append((slot, int(val), int(src)))
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

        # ------------------------------------------------ route (FIFO/pair)
        if new_msgs:
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
        if self.trace_enabled:
            self.round_trace.append(trace_entry(
                self.round_no, self.last_completions, out_counts,
                extra=sum(b.shape[0] for b in self.backlog)))
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
        """Step until no messages are in flight and all bg ops are idle."""
        for _ in range(max_rounds):
            self.step()
            busy = any(b.shape[0] for b in self.backlog)
            busy = busy or any(B.any_active(bg) for bg in self.bgs)
            busy = busy or bool(self._pending_ops)
            if not busy:
                return
        raise RuntimeError(
            f"cluster did not quiesce: backlog="
            f"{[b.shape[0] for b in self.backlog]} "
            f"bg={[B.slot_phases(bg).tolist() for bg in self.bgs]} "
            f"pending={len(self._pending_ops)}")

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
    def split(self, s: int, entry_keymax: int, sitem_idx: int) -> bool:
        self.bgs[s], ok = B.queue_split(self.bgs[s], entry_keymax, sitem_idx)
        return bool(ok)

    def move(self, s: int, entry_keymax: int, target: int) -> bool:
        self.bgs[s], ok = B.queue_move(self.bgs[s], entry_keymax, target)
        return bool(ok)

    def merge(self, s: int, left_keymax: int, right_keymax: int) -> bool:
        self.bgs[s], ok = B.queue_merge(self.bgs[s], left_keymax,
                                        right_keymax)
        return bool(ok)

    def replicate(self, s: int, entry_keymax: int, target: int) -> bool:
        raise NotImplementedError(f"replication comes with {LATER_SLICE}")

    def drop_replica(self, s: int, entry_keymax: int,
                     target: int = -1) -> bool:
        raise NotImplementedError(f"replication comes with {LATER_SLICE}")

    def replica_sets(self):
        """No replicas exist on this slice."""
        return {}

    def middle_item(self, s: int, head_idx: int) -> Optional[int]:
        """Pool idx of the middle live item of a sublist (split point)."""
        items = self.shard_chain(s, head_idx, include_meta=True)
        if len(items) < 2:
            return None
        return items[len(items) // 2][1]
