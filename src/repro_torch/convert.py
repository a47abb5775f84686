"""Carry DiLi state between the reference package and the port.

DiLi has no weights; its counterpart of carrying parameters across is a
shard's state. ``*_to_numpy`` turns a state — the port's tensors, or the
reference's arrays — into nested dicts of numpy arrays keyed by field
name; ``shard_state_from_numpy`` / ``bg_table_from_numpy`` build the
port's tensors on a device from such dicts. The reference's uint32 ref
columns (``pool.nxt``, ``pool.newloc``, ``registry.subhead``,
``registry.subtail``, ``BgTable.sh_star``/``st_star``) become their int32
bit patterns (``.view(np.int32)``); every other leaf keeps its dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bg.fsm import BgState
from .core.types import (Blocks, Pool, Registry, ReplicaSlots, RepSessions,
                         ShardState, resolve_device)

_NESTED = {"pool": Pool, "registry": Registry, "blk": Blocks,
           "rep": RepSessions, "rslots": ReplicaSlots}


def to_numpy(tree):
    """A nested NamedTuple of arrays or tensors as nested dicts of numpy
    arrays (uint32 leaves as their int32 bit patterns)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_numpy(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    arr = np.array(tree)
    return arr.view(np.int32) if arr.dtype == np.uint32 else arr


shard_state_to_numpy = to_numpy
bg_table_to_numpy = to_numpy


def _leaf(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype not in (np.int32, np.bool_):
        raise TypeError(f"unexpected leaf dtype {arr.dtype}")
    # np.array keeps 0-d leaves 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _build(cls, d, device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(*(_build(_NESTED[f], d[f], device) if f in _NESTED
                 and cls is ShardState else _leaf(d[f], device)
                 for f in cls._fields))


def shard_state_from_numpy(d: dict, device="cuda") -> ShardState:
    """A port ``ShardState`` on ``device`` from nested numpy dicts."""
    return _build(ShardState, d, resolve_device(device))


def bg_table_from_numpy(d: dict, device="cuda") -> BgState:
    """A port ``BgTable`` on ``device`` from a dict of numpy arrays."""
    return _build(BgState, d, resolve_device(device))
