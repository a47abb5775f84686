"""Target-side replay of batched MoveItem runs (DESIGN.md §10) — ported as
its gate. A round without ``MSG_MOVE_ITEMS`` rows (every round of this
slice: one shard never moves a sublist) handles nothing. A round with such
rows raises: the vectorized splice comes with the Move slice, and skipping
the rows silently would drop a migration."""
from __future__ import annotations

import numpy as np

from .. import messages as M
from ..types import DiLiConfig
from .engine import LATER_SLICE


def replay_prepass(rows: np.ndarray, cfg: DiLiConfig) -> np.ndarray:
    """``handled`` mask of the round's host rows (all False here)."""
    handled = np.zeros((rows.shape[0],), bool)
    if cfg.move_fastpath and (rows[:, M.F_KIND] == M.MSG_MOVE_ITEMS).any():
        raise NotImplementedError(
            f"MSG_MOVE_ITEMS rows reached replay_prepass: batched move "
            f"replay comes with {LATER_SLICE}")
    return handled
