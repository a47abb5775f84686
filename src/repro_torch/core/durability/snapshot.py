"""Periodic full-state shard snapshots through ``CheckpointManager``.

A snapshot is the durable base recovery replays from: the shard's full
``ShardState`` (pool arrays, registry replica, epoch/peers row), its
``BgTable``, the host backlog at the end of the snapshot round, and the
shard-owned halves of its transport lanes (sender rings + receiver
cursors, the ``Transport.export_shard_lanes`` image). Written through
``CheckpointManager`` so it inherits the atomic tmp+rename discipline and
step retention, synchronously: the WAL may only be truncated once the
snapshot is durably on disk.

The file is the reference's, key for key and dtype for dtype: the ref
columns the reference keeps as ``uint32`` (``_REF_LEAVES``) are written as
``uint32`` views of the port's int32 bit patterns, so either package
loads the other's snapshots. Steps are ``round + 1`` so the genesis
snapshot (pre-round-0 state, written at attach time) lands on step 0.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ...checkpoint.ckpt import CheckpointManager, flatten, restore_pytree
from .. import bg as B
from ..types import DiLiConfig, ShardState, init_shard

_LANES = "lanes/"

# leaves the reference stores as uint32 (packed refs)
_REF_LEAVES = frozenset((
    "state/pool/nxt", "state/pool/newloc", "state/registry/subhead",
    "state/registry/subtail", "bg/sh_star", "bg/st_star"))


def snapshot_arrays(round_no: int, state: ShardState, bg: B.BgTable,
                    backlog: np.ndarray,
                    lanes: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The snapshot's ``{key: array}`` image, as the reference writes it."""
    arrs = flatten({"round": np.int64(round_no), "state": state, "bg": bg,
                    "backlog": np.asarray(backlog, np.int32),
                    "lanes": dict(lanes)})
    for k in _REF_LEAVES:
        arrs[k] = arrs[k].view(np.uint32)
    return arrs


class ShardSnapshots:
    """Snapshot store for one shard slot."""

    def __init__(self, directory: str, shard: int, *, keep: int = 2):
        self.shard = int(shard)
        self.mgr = CheckpointManager(
            os.path.join(directory, f"shard_{self.shard:02d}"), keep=keep,
            async_write=False)

    def latest_round(self) -> Optional[int]:
        step = self.mgr.latest_step()
        return None if step is None else step - 1

    def save(self, round_no: int, state: ShardState, bg: B.BgTable,
             backlog: np.ndarray,
             lanes: Dict[str, np.ndarray]) -> None:
        self.mgr.save(round_no + 1,
                      snapshot_arrays(round_no, state, bg, backlog, lanes))

    def load_latest(self, cfg: DiLiConfig, device="cuda") -> Optional[dict]:
        """Latest snapshot as ``{round, state, bg, backlog, lanes}`` with
        ``state`` and ``bg`` on ``device``, or None when no snapshot
        exists (a slot that never attached)."""
        step = self.mgr.latest_step()
        if step is None:
            return None
        path = self.mgr._path(step)
        # state/bg restore through the shape-checked template path; the
        # variable-length members (backlog, lane image) read directly
        template = {"state": init_shard(cfg, self.shard, peers_mask=0,
                                        device=device),
                    "bg": B.init_bg_table(cfg, device)}
        tree = restore_pytree(template, path)
        with np.load(path) as data:
            lanes = {k[len(_LANES):]: data[k]
                     for k in data.files if k.startswith(_LANES)}
            return dict(round=int(data["round"]),
                        state=tree["state"], bg=tree["bg"],
                        backlog=np.asarray(data["backlog"], np.int32),
                        lanes=lanes)
