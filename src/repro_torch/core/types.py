"""State containers for DiLi (Algorithm 1 of the paper, array-of-structs form).

Every container is a NamedTuple of torch tensors with the reference's field
names, order and shapes, so a state digest lines up field by field with the
JAX package. Ref columns (``nxt``, ``newloc``, ``subhead``, ``subtail``)
hold int32 bit patterns (see ``refs``) where the reference holds uint32.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from . import refs

# Sentinel keys. Real keys must lie strictly between them.
SH_KEY = -(2**31)          # SubHead
ST_KEY = 2**31 - 1         # SubTail
KEY_MIN = SH_KEY + 1
KEY_MAX = ST_KEY - 1
NEG_INF_CT = np.int32(-(2**31))  # the paper's stCt := -infinity

# Op kinds (client ops §5.2)
OP_NOP = 0
OP_FIND = 1
OP_INSERT = 2
OP_REMOVE = 3

# Result codes
RES_FALSE = 0
RES_TRUE = 1
RES_PENDING = -1      # not yet applied (e.g. delegated to another shard)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere;
    asking for it on a machine without a card raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch sees no CUDA device — pass "
            f"device='cpu' to run the port on the CPU")
    return dev


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device inside the block, so work that
    does not follow its tensors' device (a raw kernel launch, a bare
    ``"cuda"`` allocation, ``torch.cuda.synchronize()``) lands on it; a
    no-op for any other device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class DiLiConfig(NamedTuple):
    """Static capacities — all shapes derive from these."""
    num_shards: int = 1
    pool_capacity: int = 4096        # nodes per shard
    max_sublists: int = 256          # registry entries (global)
    max_ctrs: int = 256              # counter-slot pairs per shard
    max_scan: int = 512              # traversal bound (>= split_threshold + slack)
    batch_size: int = 64             # client ops per shard per round
    mailbox_cap: int = 64            # delegation/replicate slots per shard-pair round
    split_threshold: int = 125       # the paper's load-balancer threshold (§7.1)
    move_batch: int = 8              # MoveItems packed per round per slot (K)
    bg_slots: int = 2                # concurrent background ops per shard
    move_fastpath: bool = True       # vectorized target-side replay of moves
    quarantine_rounds: int = 4       # rounds before a switched chain is freed
    max_retries: int = 64            # replay requeue bound
    find_fastpath: bool = True       # batched FIND pre-pass (DESIGN.md §4)
    fast_scan_bound: int = 192       # fast-path walk bound
    fast_min_batch: int = 4          # min local finds to run the pre-pass
    mut_fastpath: bool = True        # batched INSERT/REMOVE pre-pass (§4b)
    mut_min_batch: int = 4           # min eligible mutations to run it
    mut_alloc_headroom: int = 32     # pool-room margin for the mutation batch
    block_probe: bool = False        # packed-block stage-2 probe through the
                                     # hybrid-search kernel (DESIGN.md §12)
    block_cap: int = 160             # keys per packed block
    replication: bool = False        # hot-sublist read replication (§15)
    replica_sessions: int = 2
    replica_slots: int = 4
    replica_batch: int = 8
    replica_refresh_rounds: int = 8
    replica_staleness_rounds: int = 32
    range_scan: bool = False         # RANGE scans (§16)
    range_lanes: int = 4
    range_batch: int = 32


class Pool(NamedTuple):
    """Per-shard node pool — the paper's ``struct Item`` fields, columnar.
    ``nxt`` carries the deletion mark of the *owning* node in its sign bit."""
    key: torch.Tensor      # int32[N]
    nxt: torch.Tensor      # int32[N] packed Ref (mark|sid|idx)
    ts: torch.Tensor       # int32[N] logical timestamp at creation
    sid: torch.Tensor      # int32[N] origin server id
    ctr: torch.Tensor      # int32[N] counter-slot this node charges
    newloc: torch.Tensor   # int32[N] Ref of the moved copy (NULL unless moving)
    keymax: torch.Tensor   # int32[N] subtail keyMax; item payload otherwise


class Registry(NamedTuple):
    """The lazily-replicated sorted index (§5.1 / Algorithm 6)."""
    keymin: torch.Tensor   # int32[M]
    keymax: torch.Tensor   # int32[M]
    subhead: torch.Tensor  # int32[M] packed Ref (owner shard in sid bits)
    subtail: torch.Tensor  # int32[M]
    ctr: torch.Tensor      # int32[M] counter slot on the owner shard
    offset: torch.Tensor   # int32[M] the paper's sublist offset (§5.3)
    size: torch.Tensor     # int32[] live entry count


class Blocks(NamedTuple):
    """Packed-block mirror of the owned sublists (DESIGN.md §12): a cache
    whose ``valid`` bit proves row e mirrors entry e's chain at round
    start."""
    keys: torch.Tensor    # int32[M, C] sorted live keys, padding = ST_KEY
    idx: torch.Tensor     # int32[M, C] pool slot of each key
    valid: torch.Tensor   # bool[M]


class RepSessions(NamedTuple):
    """Primary-side replication sessions (DESIGN.md §15): one row per
    entry this shard publishes read replicas of, keyed by the entry's
    keymax (stable under unrelated splits and merges). ``keys`` is the
    image last committed to (or streaming to) the replicas; ``diff`` marks
    the positions of the publication still to stream."""
    keymax: torch.Tensor   # int32[S]; SH_KEY = free session
    targets: torch.Tensor  # int32[S] live replica bitmask (bit t = shard t)
    drops: torch.Tensor    # int32[S] bitmask of targets owed a DROP row
    version: torch.Tensor  # int32[S] publication version counter
    cursor: torch.Tensor   # int32[S] stream position; -1 = idle/committed
    age: torch.Tensor      # int32[S] rounds since the last commit
    keys: torch.Tensor     # int32[S, C] published image, padding = ST_KEY
    diff: torch.Tensor     # bool[S, C] positions still to stream


class ReplicaSlots(NamedTuple):
    """Replica-side read-only images (DESIGN.md §15): a slot serves FINDs
    in (keymin, keymax] while committed (version >= 0) and leased
    (ttl > 0)."""
    keymax: torch.Tensor   # int32[R]; SH_KEY = free slot
    keymin: torch.Tensor   # int32[R]
    src: torch.Tensor      # int32[R] the primary that installed it
    version: torch.Tensor  # int32[R] committed version; -1 = streaming
    ttl: torch.Tensor      # int32[R] staleness lease, rounds left
    keys: torch.Tensor     # int32[R, C] image, padding = ST_KEY


class ShardState(NamedTuple):
    """Everything one 'server' owns."""
    pool: Pool
    stct: torch.Tensor       # int32[C] start counters
    endct: torch.Tensor      # int32[C] end counters
    alloc_top: torch.Tensor  # int32[] bump allocator head for pool
    free_list: torch.Tensor  # int32[N] stack of freed node slots
    free_top: torch.Tensor   # int32[] stack height
    ctr_top: torch.Tensor    # int32[] bump allocator for counter slots
    ts_clock: torch.Tensor   # int32[] logical clock
    registry: Registry
    blk: Blocks
    epoch: torch.Tensor      # int32[] last membership epoch seen
    peers: torch.Tensor      # int32[] live-peer bitmask at that epoch
    rep: RepSessions
    rslots: ReplicaSlots


def _full(shape, val, device, dtype=torch.int32):
    return torch.full(shape, val, dtype=dtype, device=device)


def empty_registry(cfg: DiLiConfig, device) -> Registry:
    m = cfg.max_sublists
    return Registry(
        keymin=_full((m,), ST_KEY, device),
        keymax=_full((m,), ST_KEY, device),
        subhead=_full((m,), refs.NULL_REF, device),
        subtail=_full((m,), refs.NULL_REF, device),
        ctr=_full((m,), 0, device),
        offset=_full((m,), 0, device),
        size=_full((), 0, device),
    )


def empty_pool(cfg: DiLiConfig, device) -> Pool:
    n = cfg.pool_capacity
    if n >= refs.POOL_LIMIT:
        raise ValueError("pool exceeds 22-bit index space")
    return Pool(
        key=_full((n,), 0, device),
        nxt=_full((n,), refs.NULL_REF, device),
        ts=_full((n,), 0, device),
        sid=_full((n,), 0, device),
        ctr=_full((n,), 0, device),
        newloc=_full((n,), refs.NULL_REF, device),
        keymax=_full((n,), 0, device),
    )


def empty_blocks(cfg: DiLiConfig, device) -> Blocks:
    m, c = cfg.max_sublists, cfg.block_cap
    return Blocks(
        keys=_full((m, c), ST_KEY, device),
        idx=_full((m, c), 0, device),
        valid=_full((m,), False, device, torch.bool),
    )


def empty_rep_sessions(cfg: DiLiConfig, device) -> RepSessions:
    s, c = cfg.replica_sessions, cfg.block_cap
    return RepSessions(
        keymax=_full((s,), SH_KEY, device),
        targets=_full((s,), 0, device),
        drops=_full((s,), 0, device),
        version=_full((s,), 0, device),
        cursor=_full((s,), -1, device),
        age=_full((s,), 0, device),
        keys=_full((s, c), ST_KEY, device),
        diff=_full((s, c), False, device, torch.bool),
    )


def empty_replica_slots(cfg: DiLiConfig, device) -> ReplicaSlots:
    r, c = cfg.replica_slots, cfg.block_cap
    return ReplicaSlots(
        keymax=_full((r,), SH_KEY, device),
        keymin=_full((r,), SH_KEY, device),
        src=_full((r,), -1, device),
        version=_full((r,), -1, device),
        ttl=_full((r,), 0, device),
        keys=_full((r, c), ST_KEY, device),
    )


def full_peer_mask(num_shards: int) -> int:
    """All-capacity live-peer bitmask; -1 once the count exceeds the lane."""
    return -1 if num_shards >= 31 else (1 << num_shards) - 1


def init_shard(cfg: DiLiConfig, sid: int, *, bootstrap: bool = False,
               key_lo: int = KEY_MIN, key_hi: int = KEY_MAX,
               peers_mask: int | None = None,
               device="cuda") -> ShardState:
    """Fresh shard. If ``bootstrap``, seed one sublist (key_lo-1, key_hi]
    here: node 0 = SubHead, node 1 = SubTail, counter slot 0."""
    device = resolve_device(device)
    pool = empty_pool(cfg, device)
    reg = empty_registry(cfg, device)
    alloc_top = _full((), 0, device)
    ctr_top = _full((), 0, device)

    if bootstrap:
        sh_ref = refs.make_ref(sid, 0)
        st_ref = refs.make_ref(sid, 1)
        pool.key[0], pool.key[1] = SH_KEY, ST_KEY
        pool.nxt[0] = st_ref
        pool.keymax[1] = key_hi
        pool.ts[1] = 1
        pool.sid[0], pool.sid[1] = sid, sid
        reg.keymin[0] = key_lo - 1
        reg.keymax[0] = key_hi
        reg.subhead[0] = sh_ref
        reg.subtail[0] = st_ref
        reg.size.fill_(1)
        alloc_top.fill_(2)
        ctr_top.fill_(1)

    return ShardState(
        pool=pool,
        stct=_full((cfg.max_ctrs,), 0, device),
        endct=_full((cfg.max_ctrs,), 0, device),
        alloc_top=alloc_top,
        free_list=_full((cfg.pool_capacity,), -1, device),
        free_top=_full((), 0, device),
        ctr_top=ctr_top,
        ts_clock=_full((), 2, device),
        registry=reg,
        blk=empty_blocks(cfg, device),
        epoch=_full((), 0, device),
        peers=_full((), full_peer_mask(cfg.num_shards)
                    if peers_mask is None else peers_mask, device),
        rep=empty_rep_sessions(cfg, device),
        rslots=empty_replica_slots(cfg, device),
    )


def tree_leaves(tree):
    """Tensor leaves of a nested NamedTuple, in field order."""
    if isinstance(tree, tuple):
        out = []
        for x in tree:
            out.extend(tree_leaves(x))
        return out
    return [tree]


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of a nested NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    return fn(tree)


def clone_state(state: ShardState) -> ShardState:
    """A private copy of every leaf: rounds update their copy in place, so
    a caller's state is never written (the reference's functional
    contract)."""
    return tree_map(torch.clone, state)
