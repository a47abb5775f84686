"""Carry state and weights between the reference package and the port.

``params_from_numpy`` builds the port's ``DenseLM`` from the reference's
parameter tree (``models.transformer.init_params``) as numpy arrays, with
its layer-stacked ``blocks``, so both packages compute with the same
weights.

The DiLi protocol's counterpart of carrying weights across is a shard's
state. ``*_to_numpy`` turns a state — the port's tensors, or the
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
from .models.config import ArchConfig
from .models.transformer import DenseLM
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


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: ArchConfig, *, dtype=None,
                      device="cuda") -> DenseLM:
    """A port ``DenseLM`` on ``device`` from the reference's parameter tree
    as nested dicts of numpy arrays: ``embed`` [V, D], ``final_norm``,
    optional ``lm_head``, and ``blocks`` with a leading layer axis
    (``ln1``, ``ln2``, ``attn.{wq,wk,wv,wo,bq,bk,bv}``,
    ``mlp.{w_gate,w_up,w_down}``). ``dtype`` defaults to the tree's."""
    if dtype is None:
        dtype = torch.from_numpy(
            np.zeros((0,), np.asarray(tree["embed"]).dtype)).dtype
    model = DenseLM(cfg, dtype=dtype, device=device)

    def put(param, arr):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"params_from_numpy: shape {arr.shape} vs "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.array(arr, order="C")))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    stacked = tree["blocks"]
    for i, blk in enumerate(model.blocks):
        put(blk.ln1, stacked["ln1"][i])
        put(blk.ln2, stacked["ln2"][i])
        for name, _ in blk.attn.named_parameters():
            put(getattr(blk.attn, name), stacked["attn"][name][i])
        for name, _ in blk.mlp.named_parameters():
            put(getattr(blk.mlp, name), stacked["mlp"][name][i])
    return model
