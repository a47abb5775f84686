"""SPMD backend of the port: the DiLi round over S shards with one
all-to-all exchange per round.

A round is, for every shard (DiLi "server"):

  1. ``shard_round`` on its inbox and client feed (the same round as the
     simulator's, so every pre-pass and the serial pass behave alike),
  2. ``bucket_by_dst``: the outbox scattered into per-destination
     buckets of ``cap_pair`` rows,
  3. one all-to-all exchange of the buckets: the paper's RPC fabric. At
     most 2 hops per client op (3 during a Switch) is Theorem 4's
     delegation bound.

The exchange has two implementations:

  * **Local** (``group=None``, the default): one process holds all S
    shards stacked on one device, and the exchange is a transpose of the
    ``[S_src, S_dst, cap_pair, F]`` buckets. This is the one-card
    deployment: NCCL will not put two ranks on one GPU.
  * **Group**: with a ``torch.distributed`` process group of world size
    S, each rank runs its own shard (arguments and results carry a
    leading shard dimension of 1) and the exchange is
    ``dist.all_to_all_single`` of its flattened buckets: gloo on the
    CPU, NCCL across the cards of one host.

Either way the routed inbox is laid out as ``jax.lax.all_to_all(...,
split_axis=0, concat_axis=0)`` lays out the reference's: ``inbox[d]``
is the concatenation, in source order, of every source's bucket for
``d``. ``make_dili_round_hostroute`` skips the exchange and returns the
raw outboxes, for the host-routed path (the reliable transport under a
nemesis). ``stack_states``/``unstack_states`` move between per-shard
states and the stacked layout the rounds take; ``service_input_specs``
gives that layout's shapes on meta for the dry-run
(``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from . import bg as B
from . import messages as M
from .shard import shard_round
from .types import DiLiConfig, ShardState


class SpmdOut(NamedTuple):
    """One SPMD round's results, each stacked over the shards the
    process runs. ``inbox`` is the routed next-round inbox
    (``make_dili_round``) or the raw outbox ``[S, mailbox_cap, F]``
    (``make_dili_round_hostroute``); ``stats`` is ``int32[S, 9]`` or
    ``int32[S, 8]`` in each builder's lane order. The completion lanes
    and ``stats`` are host tensors (``shard_round`` builds the lanes
    there)."""
    states: ShardState
    bgs: B.BgTable
    inbox: torch.Tensor
    comp_slot: torch.Tensor
    comp_val: torch.Tensor
    comp_src: torch.Tensor
    comp_key: torch.Tensor
    stats: torch.Tensor
    ent_hits: torch.Tensor


# ------------------------------------------------------------ state layout

def _stack(trees):
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([getattr(t, f) for t in trees])
                             for f in first._fields))
    return torch.stack(trees)


def shard_slice(tree, i):
    """Shard ``i``'s view of a stacked state or table (``i`` may be a
    slice, which keeps the shard dimension)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_slice(x, i) for x in tree))
    return tree[i]


def stack_states(states: Sequence[ShardState], bgs: Sequence[B.BgTable]):
    """Per-shard states and background tables → one ``ShardState`` and
    one ``BgTable`` whose leaves carry a leading shard dimension."""
    return _stack(list(states)), _stack(list(bgs))


def unstack_states(states: ShardState, bgs: B.BgTable):
    """The inverse of ``stack_states``: lists of per-shard views."""
    n = states.pool.key.shape[0]
    return ([shard_slice(states, i) for i in range(n)],
            [shard_slice(bgs, i) for i in range(n)])


# --------------------------------------------------------------- bucketing

def _bucket_many(outbox: torch.Tensor, count: torch.Tensor,
                 num_shards: int, cap_pair: int):
    """``bucket_by_dst`` of ``n`` outboxes at once: ``outbox [n, cap, F]``
    and ``count [n]`` → ``(buckets [n, S, cap_pair, F], counts [n, S])``.
    A row's slot is the number of live rows before it with the same
    destination, clipped to ``cap_pair - 1``; of the rows that clip onto
    the last slot only the latest is written (the reference's sequential
    scatter leaves that one), so every write has its own slot."""
    n, cap, fields = outbox.shape
    dev = outbox.device
    i32 = torch.int32
    row = torch.arange(cap, device=dev)
    live = (outbox[..., M.F_KIND] != M.MSG_NONE) & (row < count[:, None])
    d = outbox[..., M.F_DST].clamp(0, num_shards - 1).long()
    hot = ((d[..., None] == torch.arange(num_shards, device=dev))
           & live[..., None]).to(i32)                       # [n, cap, S]
    before = hot.cumsum(1, dtype=i32) - hot                  # exclusive
    rank = before.gather(2, d[..., None]).squeeze(2)         # [n, cap]
    counts = hot.sum(1, dtype=i32)                           # [n, S]
    last = counts.gather(1, d) - 1
    keep = live & ((rank < cap_pair - 1) | (rank == last))
    pos = rank.clamp(0, cap_pair - 1).long()
    src = torch.arange(n, device=dev)[:, None]
    flat = (src * num_shards + d) * cap_pair + pos
    dump = n * num_shards * cap_pair             # one slot for dropped rows
    flat = torch.where(keep, flat, torch.full_like(flat, dump))
    out = torch.zeros((dump + 1, fields), dtype=outbox.dtype, device=dev)
    out.index_copy_(0, flat.reshape(-1), outbox.reshape(-1, fields))
    return out[:dump].reshape(n, num_shards, cap_pair, fields), counts


def bucket_by_dst(outbox, count, num_shards: int, cap_pair: int):
    """Scatter one outbox's rows into per-destination buckets
    ``[S, cap_pair, F]``; returns ``(buckets, counts int32[S])``.

    A row is live when its index is below ``count`` and its kind is not
    ``MSG_NONE``; its destination is ``F_DST`` clipped to ``[0, S-1]``.
    Rows past ``cap_pair`` for one destination overwrite the last slot
    (the later row wins) and ``counts`` keeps counting them, exactly as
    the reference's ``fori_loop``. Runs on the outbox's device."""
    outbox = torch.as_tensor(outbox)
    count = torch.as_tensor(count, device=outbox.device).reshape(1)
    buckets, counts = _bucket_many(outbox[None], count, num_shards,
                                   cap_pair)
    return buckets[0], counts[0]


# ---------------------------------------------------------------- exchange

def _exchange(buckets: torch.Tensor, group) -> torch.Tensor:
    """Route ``[n, S, cap_pair, F]`` buckets: ``out[d]`` is every
    source's bucket for ``d``, in source order."""
    n, num, cap_pair, fields = buckets.shape
    if group is None:
        return buckets.transpose(0, 1).reshape(num, num * cap_pair, fields)
    import torch.distributed as dist
    send = buckets[0].reshape(num * cap_pair, fields).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.reshape(1, num * cap_pair, fields)


def _local_shards(cfg: DiLiConfig, group) -> List[int]:
    """The shard ids this process runs: all of them, or its rank's."""
    if group is None:
        return list(range(cfg.num_shards))
    import torch.distributed as dist
    world = dist.get_world_size(group)
    if world != cfg.num_shards:
        raise ValueError(
            f"group of {world} ranks for {cfg.num_shards} shards: the "
            f"Group exchange runs one shard per rank")
    return [dist.get_rank(group)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x, np.int32)


def _run_shards(states, bgs, inbox, client, shards, cfg, timer):
    """``shard_round`` of every local shard. The inbox and the client feed
    cross to the host once for all shards (the serial pass reads them
    there)."""
    inbox_h, client_h = _host(inbox), _host(client)
    return [shard_round(shard_slice(states, i), shard_slice(bgs, i), me,
                        inbox_h[i], client_h[i], cfg, timer=timer)
            for i, me in enumerate(shards)]


def _scalars(outs, names) -> torch.Tensor:
    return torch.tensor([[int(getattr(o, k)) for k in names] for o in outs],
                        dtype=torch.int32)


def _common(outs):
    """The stacked state, table, completion lanes and ``ent_hits``."""
    states, bgs = stack_states([o.state for o in outs], [o.bg for o in outs])
    lanes = [torch.stack([getattr(o, k) for o in outs])
             for k in ("comp_slot", "comp_val", "comp_src", "comp_key")]
    return states, bgs, lanes, torch.stack([o.ent_hits for o in outs])


def _span(timer):
    return timer if timer is not None else (
        lambda name: contextlib.nullcontext())


def make_dili_round(cfg: DiLiConfig, cap_pair: int = 8, *, group=None,
                    timer=None):
    """Build the SPMD round: ``(states, bgs, inbox [S, S*cap_pair, F],
    client [S, batch, F]) -> SpmdOut`` with the routed next-round inbox.

    ``stats`` is ``int32[S, 9]`` per shard, the reference's lanes:

      0  out_count: attempted outbox pushes (detects bucket overflow)
      1  live rows routed to this shard (the quiescence signal)
      2  delegated MSG_OP rows routed to this shard
      3  the largest delegation-hop count among those rows
      4  background slots still busy after the round
      5  MoveItems replayed by the batched splice
      6  fast-path lanes answered by the packed-block kernel probe
      7  FINDs answered from a replica slot
      8  RANGE segments served by the packed-block gather pre-pass

    ``ent_hits`` is ``int32[S, M]``, per-entry op attribution. The routed
    inbox and ``ent_hits`` stay on the states' device; the three wire
    lanes of ``stats`` are counted there and cross to the host in one
    copy, so the host never pulls the routed inbox. With a
    ``group`` every argument and result holds this rank's shard only.
    ``timer`` (a ``timing.PhaseTimer``) gets ``shard_round``'s phases and
    the ``bucket`` and ``exchange`` spans."""
    num = cfg.num_shards
    cap_pair = int(cap_pair)
    t = _span(timer)

    def rnd(states, bgs, inbox, client) -> SpmdOut:
        shards = _local_shards(cfg, group)
        dev = states.pool.key.device
        outs = _run_shards(states, bgs, inbox, client, shards, cfg, timer)
        st, bg, lanes, ent_hits = _common(outs)
        with t("bucket"):
            ob = torch.stack([o.outbox for o in outs]).to(dev)
            cnt = torch.stack([o.out_count for o in outs]).to(dev)
            buckets, _ = _bucket_many(ob, cnt, num, cap_pair)
        with t("exchange"):
            routed = _exchange(buckets, group)
        kind = routed[..., M.F_KIND]
        is_op = kind == M.MSG_OP
        hops = torch.where(is_op, routed[..., M.F_X2],
                           torch.zeros_like(routed[..., M.F_X2]))
        wire = torch.stack([(kind != M.MSG_NONE).sum(1), is_op.sum(1),
                            hops.max(1).values], 1).to(torch.int32).cpu()
        own = _scalars(outs, ("out_count",))
        rest = _scalars(outs, ("bg_active", "move_hits", "blk_hits",
                               "rep_hits", "range_hits"))
        stats = torch.cat([own, wire, rest], 1)
        return SpmdOut(st, bg, routed, *lanes, stats, ent_hits)

    return rnd


def make_dili_round_hostroute(cfg: DiLiConfig, *, timer=None):
    """The SPMD round without the exchange: ``(states, bgs, inbox
    [S, in_cap, F], client [S, batch, F]) -> SpmdOut`` whose ``inbox`` is
    the raw outbox ``[S, mailbox_cap, F]``, for the host to route through
    ``core.net.Transport`` (the nemesis lives on the wire between outboxes
    and inboxes, so routing crosses the host). ``stats`` is
    ``int32[S, 8]``: out_count, bg_active, move_hits, fast_hits,
    mut_hits, blk_hits, rep_hits, range_hits. Delegation hops are counted
    by the host from the outbox rows."""

    def rnd(states, bgs, inbox, client) -> SpmdOut:
        outs = _run_shards(states, bgs, inbox, client,
                           range(cfg.num_shards), cfg, timer)
        st, bg, lanes, ent_hits = _common(outs)
        stats = _scalars(outs, ("out_count", "bg_active", "move_hits",
                                "fast_hits", "mut_hits", "blk_hits",
                                "rep_hits", "range_hits"))
        return SpmdOut(st, bg, torch.stack([o.outbox for o in outs]),
                       *lanes, stats, ent_hits)

    return rnd


def service_input_specs(cfg: DiLiConfig, num_shards: int, in_cap: int):
    """Meta-tensor stand-ins of an SPMD round's arguments for the dry-run
    (no allocation): the states and background tables stacked over
    ``num_shards``, the inbox ``[S, in_cap, FIELDS]`` and the client feed
    ``[S, batch_size, FIELDS]``, int32."""
    from .types import init_shard
    proto_state = init_shard(cfg, 0, device="meta")
    proto_bg = B.init_bg_table(cfg, device="meta")

    def stackit(tree):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(stackit(x) for x in tree))
        return tree.new_empty((num_shards,) + tuple(tree.shape))

    meta = torch.device("meta")
    inbox = torch.empty((num_shards, in_cap, M.FIELDS), dtype=torch.int32,
                        device=meta)
    client = torch.empty((num_shards, cfg.batch_size, M.FIELDS),
                         dtype=torch.int32, device=meta)
    return stackit(proto_state), stackit(proto_bg), inbox, client
