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
    shards, each on the device ``placement`` gives it, as the
    reference's ``shard_map`` mesh holds one shard per device. Shard
    ``s`` runs and buckets on its device, and the exchange copies each
    bucket to its destination's device (peer copies between cards, none
    between shards that share one). With fewer cards than shards the
    shards fold onto the cards in turn; on one card all of them share it.
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
nemesis). Both factories take the placed layout (per-shard lists,
``placed=True``, what ``ShardMapBackend`` holds) or trees stacked over
the shards on one device; ``stack_states``/``unstack_states`` move
between the two, and ``service_input_specs`` gives the stacked layout's
shapes on meta for the dry-run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import timing
from . import bg as B
from . import messages as M
from .host import to_cpu, to_numpy
from .shard import shard_round
from .types import DiLiConfig, ShardState, on_device, resolve_device


class SpmdOut(NamedTuple):
    """One SPMD round's results over the shards the process runs.
    ``states``, ``bgs`` and a routed ``inbox`` are per-shard lists in the
    placed layout and stacked trees otherwise; ``inbox`` is the routed
    next-round inbox (``make_dili_round``) or the raw outbox
    ``[S, mailbox_cap, F]`` on the host (``make_dili_round_hostroute``);
    ``stats`` is ``int32[S, 9]`` or ``int32[S, 8]`` in each factory's lane
    order. The completion lanes and ``stats`` are host tensors
    (``shard_round`` builds the lanes there)."""
    states: ShardState
    bgs: B.BgTable
    inbox: torch.Tensor
    comp_slot: torch.Tensor
    comp_val: torch.Tensor
    comp_src: torch.Tensor
    comp_key: torch.Tensor
    stats: torch.Tensor
    ent_hits: torch.Tensor


# ------------------------------------------------------------- placement

def placement(cfg: DiLiConfig, device="cuda",
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """The device of each of ``cfg.num_shards`` shards.

    ``devices`` lists them one per shard (repeats allowed; any other
    length raises). Otherwise ``device="cuda"`` with no index puts shard
    ``s`` on ``cuda:{s % torch.cuda.device_count()}``: with fewer cards
    than shards the shards fold onto the cards in turn, where the
    reference's mesh raises. ``"cuda:N"`` or ``"cpu"`` puts every shard
    there. ``resolve_device`` gates each: asking for CUDA without a card
    raises. A CUDA device always carries its index."""
    num = cfg.num_shards
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != num:
            raise ValueError(f"devices= lists {len(devs)} devices for "
                             f"{num} shards: give one per shard")
        return [torch.device("cuda", torch.cuda.current_device())
                if d.type == "cuda" and d.index is None else d
                for d in devs]
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        cards = torch.cuda.device_count()
        return [torch.device("cuda", s % cards) for s in range(num)]
    return [dev] * num


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
    """Per-shard states and background tables on one device → one
    ``ShardState`` and one ``BgTable`` whose leaves carry a leading shard
    dimension."""
    return _stack(list(states)), _stack(list(bgs))


def unstack_states(states: ShardState, bgs: B.BgTable):
    """The inverse of ``stack_states``: lists of per-shard views."""
    n = states.pool.key.shape[0]
    return ([shard_slice(states, i) for i in range(n)],
            [shard_slice(bgs, i) for i in range(n)])


def gather_host(tensors: Sequence[torch.Tensor], devices) -> torch.Tensor:
    """``torch.stack(tensors)`` on the host, with one device-to-host copy
    per device: the shards that share a device are stacked there and
    cross together. ``devices[i]`` is where ``tensors[i]`` lies."""
    groups = _by_device(devices)
    if len(groups) == 1:
        return to_cpu(torch.stack(list(tensors)))
    out = [None] * len(tensors)
    for idx in groups.values():
        host = to_cpu(torch.stack([tensors[i] for i in idx]))
        for j, i in enumerate(idx):
            out[i] = host[j]
    return torch.stack(out)


def _by_device(devices) -> Dict[torch.device, List[int]]:
    """Shard positions grouped by device, in first-seen order."""
    groups: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)
    return groups


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


def _bucket_placed(outs, devices, num_shards: int, cap_pair: int):
    """Every source's buckets ``[S, cap_pair, F]`` on its own device: the
    host outboxes of the shards on one device cross to it together and
    are bucketed in one call."""
    buckets = [None] * len(outs)
    for dev, idx in _by_device(devices).items():
        ob = torch.stack([outs[i].outbox for i in idx]).to(dev)
        cnt = torch.stack([outs[i].out_count for i in idx]).to(dev)
        b, _ = _bucket_many(ob, cnt, num_shards, cap_pair)
        for j, i in enumerate(idx):
            buckets[i] = b[j]
    return buckets


# ---------------------------------------------------------------- exchange

def _exchange(buckets, devices, group) -> List[torch.Tensor]:
    """Route every source's ``[S, cap_pair, F]`` buckets: ``out[d]``, on
    ``devices[d]``, is every source's bucket for ``d`` in source order.
    A bucket crosses to another card as an asynchronous peer copy, which
    PyTorch orders against both cards' current streams; between shards
    on one device nothing is copied but the concatenation."""
    if group is None:
        return [torch.cat([b[d].to(dev, non_blocking=True) for b in buckets])
                for d, dev in enumerate(devices)]
    import torch.distributed as dist
    send = buckets[0].reshape(-1, buckets[0].shape[-1]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return [recv]


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


# ------------------------------------------------------------------ rounds

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x, np.int32)


def _devices(states) -> List[torch.device]:
    return [st.pool.key.device for st in states]


def _run_shards(states, bgs, inbox_h, client, shards, cfg, timer):
    """``shard_round`` of every local shard, each with its own device
    current. ``inbox_h`` and the client feed are read on the host (the
    serial pass reads them there)."""
    client_h = _host(client)
    outs = []
    for i, me in enumerate(shards):
        with on_device(states[i].pool.key.device):
            outs.append(shard_round(states[i], bgs[i], me, inbox_h[i],
                                    client_h[i], cfg, timer=timer))
    return outs


def _scalars(outs, names) -> torch.Tensor:
    return torch.tensor([[int(getattr(o, k)) for k in names] for o in outs],
                        dtype=torch.int32)


def _lanes(outs):
    return [torch.stack([getattr(o, k) for o in outs])
            for k in ("comp_slot", "comp_val", "comp_src", "comp_key")]


def _wire(routed: torch.Tensor) -> torch.Tensor:
    """One destination's three wire lanes (live rows, delegated MSG_OP
    rows, their largest hop count), counted on its device."""
    kind = routed[:, M.F_KIND]
    is_op = kind == M.MSG_OP
    hops = torch.where(is_op, routed[:, M.F_X2],
                       torch.zeros_like(routed[:, M.F_X2]))
    return torch.stack([(kind != M.MSG_NONE).sum(), is_op.sum(),
                        hops.max()]).to(torch.int32)


def _stacked(rnd, routed: bool):
    """The placed round ``rnd`` over trees stacked on one device: unstack,
    run with every shard on that device, restack."""
    def stacked(states, bgs, inbox, client) -> SpmdOut:
        dev = states.pool.key.device
        sts, bgl = unstack_states(states, bgs)
        out = rnd(sts, bgl, list(torch.as_tensor(inbox)) if routed
                  else inbox, client)
        st, bg = stack_states(out.states, out.bgs)
        return out._replace(
            states=st, bgs=bg, ent_hits=out.ent_hits.to(dev),
            inbox=torch.stack(out.inbox) if routed else out.inbox)
    return stacked


def make_dili_round(cfg: DiLiConfig, cap_pair: int = 8, *, group=None,
                    timer=None, placed: bool = False):
    """Build the SPMD round: ``(states, bgs, inbox [S, S*cap_pair, F],
    client [S, batch, F]) -> SpmdOut`` with the routed next-round inbox.

    With ``placed=True`` the round takes and returns the placed layout:
    ``states``, ``bgs`` and ``inbox`` are lists with one entry per shard,
    each on the device of that shard's state (``placement``). Shard
    ``s``'s ``shard_round`` and bucketing run on its device, and
    ``inbox[d]`` comes back on shard ``d``'s. Without it they are trees
    stacked over the shards on one device, which the round unstacks and
    restacks around the same code.

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

    ``ent_hits`` is ``int32[S, M]``, per-entry op attribution. The three
    wire lanes of ``stats`` are counted on each destination's device and
    cross to the host with ``ent_hits``, one copy per device, so the host
    never pulls the routed inbox; the placed round returns ``ent_hits`` on
    the host, the stacked one on the states' device. With a ``group``
    every argument and result holds this rank's shard only. ``timer`` (a
    ``timing.PhaseTimer``) gets ``shard_round``'s phases and the
    ``bucket`` and ``exchange`` spans."""
    num = cfg.num_shards
    cap_pair = int(cap_pair)
    t = timing.tracer(timer)

    def rnd(states, bgs, inbox, client) -> SpmdOut:
        shards = _local_shards(cfg, group)
        devs = _devices(states)
        outs = _run_shards(states, bgs, _host(gather_host(inbox, devs)),
                           client, shards, cfg, timer)
        with t("bucket"):
            buckets = _bucket_placed(outs, devs, num, cap_pair)
        with t("exchange"):
            routed = _exchange(buckets, devs, group)
        host = gather_host([torch.cat([_wire(r), o.ent_hits])
                            for r, o in zip(routed, outs)], devs)
        own = _scalars(outs, ("out_count",))
        rest = _scalars(outs, ("bg_active", "move_hits", "blk_hits",
                               "rep_hits", "range_hits"))
        stats = torch.cat([own, host[:, :3], rest], 1)
        return SpmdOut([o.state for o in outs], [o.bg for o in outs], routed,
                       *_lanes(outs), stats, host[:, 3:])

    return rnd if placed else _stacked(rnd, routed=True)


def make_dili_round_hostroute(cfg: DiLiConfig, *, timer=None,
                              placed: bool = False):
    """The SPMD round without the exchange: ``(states, bgs, inbox
    [S, in_cap, F], client [S, batch, F]) -> SpmdOut`` whose ``inbox`` is
    the raw outbox ``[S, mailbox_cap, F]`` on the host, for the host to
    route through ``core.net.Transport`` (the nemesis lives on the wire
    between outboxes and inboxes, so routing crosses the host). The inbox
    argument is a host array in both layouts; ``placed`` takes per-shard
    states and tables as in ``make_dili_round``. ``stats`` is
    ``int32[S, 8]``: out_count, bg_active, move_hits, fast_hits,
    mut_hits, blk_hits, rep_hits, range_hits. Delegation hops are counted
    by the host from the outbox rows."""

    def rnd(states, bgs, inbox, client) -> SpmdOut:
        outs = _run_shards(states, bgs, _host(inbox), client,
                           range(cfg.num_shards), cfg, timer)
        stats = _scalars(outs, ("out_count", "bg_active", "move_hits",
                                "fast_hits", "mut_hits", "blk_hits",
                                "rep_hits", "range_hits"))
        ent_hits = gather_host([o.ent_hits for o in outs], _devices(states))
        return SpmdOut([o.state for o in outs], [o.bg for o in outs],
                       torch.stack([o.outbox for o in outs]),
                       *_lanes(outs), stats, ent_hits)

    return rnd if placed else _stacked(rnd, routed=False)


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
