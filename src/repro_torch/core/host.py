"""Host working copies of a shard's state for the round's serial pass.

The reference runs its serial row loop and background phases as
``lax.while_loop``/``lax.switch`` on the device. The port runs them as
Python loops over numpy copies of the columns they touch: a column is
copied to the host on first use, every write goes through ``put`` (which
records the row) or ``replace`` (whole column), and ``commit`` writes only
the touched rows back to the device. On a CPU device the numpy arrays share
memory with the tensors, so nothing is copied either way. ``to_cpu`` and
``to_numpy`` are the round's way to the host: a read of a card's tensor
is counted there (``timing.crossed``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import timing
from .types import Registry, ShardState

# host name -> (path into ShardState)
_COLS = {
    "key": ("pool", "key"), "nxt": ("pool", "nxt"), "ts": ("pool", "ts"),
    "sid": ("pool", "sid"), "ctr": ("pool", "ctr"),
    "newloc": ("pool", "newloc"), "keymax": ("pool", "keymax"),
    "stct": ("stct",), "endct": ("endct",), "free_list": ("free_list",),
    "r_keymin": ("registry", "keymin"), "r_keymax": ("registry", "keymax"),
    "r_subhead": ("registry", "subhead"),
    "r_subtail": ("registry", "subtail"), "r_ctr": ("registry", "ctr"),
    "r_offset": ("registry", "offset"), "blk_valid": ("blk", "valid"),
    "rs_keymax": ("rslots", "keymax"), "rs_keymin": ("rslots", "keymin"),
    "rs_src": ("rslots", "src"), "rs_version": ("rslots", "version"),
    "rs_ttl": ("rslots", "ttl"), "rs_keys": ("rslots", "keys"),
}
_SCALARS = {
    "alloc_top": ("alloc_top",), "free_top": ("free_top",),
    "ctr_top": ("ctr_top",), "ts_clock": ("ts_clock",),
    "epoch": ("epoch",), "peers": ("peers",), "size": ("registry", "size"),
}


def _get(state, path):
    x = state
    for p in path:
        x = getattr(x, p)
    return x


def to_cpu(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a tensor on a card is copied and the read
    counted (``timing.crossed``); a CPU tensor is returned as it is."""
    timing.crossed(t)
    return t.detach().cpu()


def to_numpy(t) -> np.ndarray:
    """``t`` as a numpy array on the host (``to_cpu``); anything but a
    tensor goes through ``np.asarray``."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    return to_cpu(t).numpy()


class HostShard:
    """Lazy host view of one ShardState (see module docstring).

    Columns are attributes (``h.nxt[i]``), scalars are Python ints
    (``h.ts_clock``); writes use ``put``/``replace`` for columns and plain
    assignment for scalars.
    """

    def __init__(self, state: ShardState):
        self.state = state
        self.n = state.pool.key.shape[0]          # pool capacity
        self.n_ctrs = state.stct.shape[0]
        self.m = state.registry.keymin.shape[0]
        self._cpu = state.pool.key.device.type == "cpu"
        self._dirty = {}          # column name -> set of rows, or None = all
        self._scalars0 = None

    def __getattr__(self, name):
        # only reached for attributes not loaded yet
        if name in _COLS:
            t = _get(self.state, _COLS[name])
            arr = t.numpy() if self._cpu else to_numpy(t)
            self.__dict__[name] = arr
            return arr
        if name in _SCALARS:
            self._load_scalars()
            return self.__dict__[name]
        raise AttributeError(name)

    def _load_scalars(self):
        vals = torch.stack([_get(self.state, p) for p in _SCALARS.values()])
        vals = [int(v) for v in to_numpy(vals)]
        self._scalars0 = dict(zip(_SCALARS, vals))
        self.__dict__.update(self._scalars0)

    # ------------------------------------------------------------- writes
    def put(self, name: str, i: int, v) -> None:
        getattr(self, name)[i] = v
        rows = self._dirty.setdefault(name, set())
        if rows is not None:
            rows.add(int(i))

    def replace(self, name: str, arr) -> None:
        getattr(self, name)[...] = arr
        self._dirty[name] = None

    def registry(self) -> Registry:
        """The registry columns as CPU tensors (sharing the host arrays)."""
        return Registry(
            keymin=torch.from_numpy(self.r_keymin),
            keymax=torch.from_numpy(self.r_keymax),
            subhead=torch.from_numpy(self.r_subhead),
            subtail=torch.from_numpy(self.r_subtail),
            ctr=torch.from_numpy(self.r_ctr),
            offset=torch.from_numpy(self.r_offset),
            size=torch.tensor(self.size, dtype=torch.int32))

    def set_registry(self, reg: Registry) -> None:
        for name in ("keymin", "keymax", "subhead", "subtail", "ctr",
                     "offset"):
            self.replace("r_" + name, getattr(reg, name).numpy())
        self.size = int(reg.size)

    # ------------------------------------------------------------- commit
    def commit(self) -> ShardState:
        """Write touched rows and changed scalars back to the device; the
        state's tensors are updated in place and returned."""
        if not self._cpu:
            for name, rows in self._dirty.items():
                t = _get(self.state, _COLS[name])
                arr = self.__dict__[name]
                if rows is None:
                    t.copy_(torch.from_numpy(arr))
                elif rows:
                    idx = np.fromiter(rows, np.int64, len(rows))
                    t[torch.from_numpy(idx).to(t.device)] = \
                        torch.from_numpy(arr[idx]).to(t.device)
        if self._scalars0 is not None:
            for name, v0 in self._scalars0.items():
                v = self.__dict__[name]
                if v != v0:
                    _get(self.state, _SCALARS[name]).fill_(v)
        return self.state
