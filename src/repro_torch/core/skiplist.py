"""Lock-free-style skip list baseline (Fraser [11]), the port of the
reference's ``core/skiplist.py``.

The paper benchmarks DiLi against a lock-free skip list (Fig. 3a); this is
that comparator under the same batched-linearization execution model as
the DiLi core: a batch of ops applied one after another, every op seeing
the state its predecessor left.

Where it runs. The reference's ``apply_batch`` is one sequential
``lax.scan``: every op depends on the one before it. The port runs such
loops as the round's serial pass does (``core/host.py``): the
``SkipList`` tensors live on the device; ``apply_batch`` copies the
columns a batch touches to the host once, runs the ops in order in Python
over those copies, writes the touched entries back once, and returns the
results as a device tensor. On a CPU device the host copies share memory
with the tensors, so nothing is copied. On the card, then, the device
only stores the state and every op is host work, while a DiLi round
also does device work and launches kernels every round: fig3a's
``dili_over_skip`` ratio on the card compares a host-Python skip list
with DiLi's host-and-device round, not the reference's comparison of two
structures under one per-op dispatch.

Every write is the reference's, stale entries included: ``remove``
unsplices only the levels whose predecessor points at the node, resets
its key to ``-(2**31)`` and pushes it on the free list, and leaves its
``nxt`` row and ``height`` as they were; ``insert`` pops the free list
(LIFO) before it bumps ``alloc_top``, and changes nothing when both are
exhausted. The state stays bit for bit the reference's after every batch.

Deterministic tower heights come from a hash of the key (the standard
p=1/2 geometric distribution in expectation), computed in uint32
arithmetic on Python ints (``_key_height``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .types import OP_INSERT, OP_REMOVE, resolve_device

HEAD = 0          # sentinel node index (key = -inf)
NIL = -1          # end-of-level
KEY_NONE = -(2 ** 31)
_U32 = 0xFFFFFFFF


class SkipList(NamedTuple):
    key: torch.Tensor        # int32[N]
    nxt: torch.Tensor        # int32[L, N]  next pointers per level
    live: torch.Tensor       # bool[N]
    height: torch.Tensor     # int32[N]
    alloc_top: torch.Tensor  # int32 scalar
    free_list: torch.Tensor  # int32[N]
    free_top: torch.Tensor   # int32 scalar


def _key_height(key: int, max_level: int) -> int:
    """Deterministic geometric(1/2) height from a key hash: the
    reference's uint32 hash (``uint32(key)`` wraps a negative int32, the
    multiplies are mod 2**32), then one plus the trailing ones, capped at
    ``max_level``."""
    h = ((int(key) & _U32) * 0x9E3779B9) & _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    lvl = 1
    for i in range(max_level - 1):
        if lvl == i + 1 and (h >> i) & 1:
            lvl += 1
    return min(max(lvl, 1), max_level)


def init(capacity: int, max_level: int, device="cuda") -> SkipList:
    dev = resolve_device(device)
    live = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    live[HEAD] = True
    height = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    height[HEAD] = max_level
    return SkipList(
        key=torch.full((capacity,), KEY_NONE, dtype=torch.int32, device=dev),
        nxt=torch.full((max_level, capacity), NIL, dtype=torch.int32,
                       device=dev),
        live=live, height=height,
        alloc_top=torch.tensor(1, dtype=torch.int32, device=dev),
        free_list=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        free_top=torch.tensor(0, dtype=torch.int32, device=dev))


class _Host:
    """Host working copy of a ``SkipList`` for one batch: columns load on
    first use, writes record their entries, ``commit`` writes only those
    back (in place) — the pattern of ``core.host.HostShard``."""

    _COLS = ("key", "nxt", "live", "height", "free_list")

    def __init__(self, sl: SkipList):
        self.sl = sl
        self.n = sl.key.shape[0]
        self._cpu = sl.key.device.type == "cpu"
        self._dirty = {}
        tops = torch.stack([sl.alloc_top, sl.free_top]).cpu().tolist()
        self.alloc_top, self.free_top = tops
        self._tops0 = tuple(tops)

    def __getattr__(self, name):
        # only reached for a column not loaded yet
        if name not in self._COLS:
            raise AttributeError(name)
        t = getattr(self.sl, name)
        arr = t.numpy() if self._cpu else t.cpu().numpy()
        self.__dict__[name] = arr
        return arr

    def put(self, name: str, i: int, v) -> None:
        getattr(self, name)[i] = v
        self._dirty.setdefault(name, set()).add(i)

    def put_nxt(self, lvl: int, i: int, v: int) -> None:
        self.nxt[lvl, i] = v
        self._dirty.setdefault("nxt", set()).add(lvl * self.n + i)

    def commit(self) -> SkipList:
        sl = self.sl
        if not self._cpu:
            for name, entries in self._dirty.items():
                flat = getattr(sl, name).view(-1)
                idx = np.fromiter(sorted(entries), np.int64, len(entries))
                vals = self.__dict__[name].reshape(-1)[idx]
                flat[torch.from_numpy(idx).to(flat.device)] = \
                    torch.from_numpy(vals).to(flat.device)
        if (self.alloc_top, self.free_top) != self._tops0:
            sl.alloc_top.fill_(self.alloc_top)
            sl.free_top.fill_(self.free_top)
        return sl


def _clip(i: int, n: int) -> int:
    return min(max(i, 0), n - 1)


def _find_preds(h: _Host, key: int, max_level: int, max_steps: int):
    """Descend the towers; returns preds[L] (level 0 first) and the
    level-0 successor. The step budget is shared by all levels."""
    nxt, keys, n = h.nxt, h.key, h.n
    node, steps = HEAD, 0
    preds = [0] * max_level
    for lvl in range(max_level - 1, -1, -1):
        row = nxt[lvl]
        while steps < max_steps:
            nx = int(row[node])
            if nx == NIL or not keys[_clip(nx, n)] < key:
                break
            node = nx
            steps += 1
        preds[lvl] = node
    return preds, int(nxt[0, node])


def _present(h: _Host, succ: int, key: int) -> bool:
    return succ != NIL and int(h.key[_clip(succ, h.n)]) == key


def _find(h: _Host, key: int, max_level: int, max_steps: int) -> bool:
    _, succ = _find_preds(h, key, max_level, max_steps)
    return _present(h, succ, key)


def _insert(h: _Host, key: int, max_level: int, max_steps: int) -> bool:
    preds, succ = _find_preds(h, key, max_level, max_steps)
    if _present(h, succ, key):
        return False
    n = h.n
    has_free = h.free_top > 0
    if not has_free and h.alloc_top >= n:
        return False                      # pool exhausted: nothing changes
    idx = int(h.free_list[_clip(h.free_top - 1, n)]) if has_free \
        else h.alloc_top
    hgt = _key_height(key, max_level)
    nxt = h.nxt
    pred_next = [int(nxt[lvl, preds[lvl]]) for lvl in range(hgt)]
    for lvl in range(hgt):
        h.put_nxt(lvl, idx, pred_next[lvl])
    for lvl in range(hgt):
        h.put_nxt(lvl, preds[lvl], idx)
    h.put("key", idx, key)
    h.put("live", idx, True)
    h.put("height", idx, hgt)
    if has_free:
        h.free_top -= 1
    else:
        h.alloc_top += 1
    return True


def _remove(h: _Host, key: int, max_level: int, max_steps: int) -> bool:
    preds, succ = _find_preds(h, key, max_level, max_steps)
    if not _present(h, succ, key):
        return False
    n = h.n
    idx = _clip(succ, n)
    hgt = int(h.height[idx])
    nxt = h.nxt
    # unsplice every level where pred points at idx (all reads first)
    tgt = [(lvl, int(nxt[lvl, idx])) for lvl in range(min(hgt, max_level))
           if int(nxt[lvl, preds[lvl]]) == idx]
    for lvl, t in tgt:
        h.put_nxt(lvl, preds[lvl], t)
    h.put("live", idx, False)
    h.put("key", idx, KEY_NONE)
    h.put("free_list", _clip(h.free_top, n), idx)
    h.free_top += 1
    return True


def apply_batch(sl: SkipList, kinds, keys, max_level: int):
    """Sequentially linearized batch, mirroring the DiLi round model.

    Returns ``(sl, results)``: the state updated in place and an int32
    result per op on the state's device. A kind other than
    FIND/INSERT/REMOVE leaves the state as it is and answers what
    ``remove`` would (whether the key is present), as the reference's
    select does."""
    # int32 as the reference's jnp.asarray(..., jnp.int32): wider keys wrap
    kinds, keys = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                   .astype(np.int32).reshape(-1) for x in (kinds, keys))
    h = _Host(sl)
    max_steps = 1 << 30
    out = np.zeros(len(kinds), np.int32)
    for i, (kind, key) in enumerate(zip(kinds.tolist(), keys.tolist())):
        if kind == OP_INSERT:
            r = _insert(h, key, max_level, max_steps)
        elif kind == OP_REMOVE:
            r = _remove(h, key, max_level, max_steps)
        else:
            r = _find(h, key, max_level, max_steps)
        out[i] = r
    sl = h.commit()
    return sl, torch.from_numpy(out).to(sl.key.device)


def find(sl: SkipList, key: int, max_level: int,
         max_steps: int = 1 << 30) -> bool:
    return _find(_Host(sl), int(key), max_level, max_steps)


def insert(sl: SkipList, key: int, max_level: int,
           max_steps: int = 1 << 30):
    h = _Host(sl)
    ok = _insert(h, int(key), max_level, max_steps)
    return h.commit(), ok


def remove(sl: SkipList, key: int, max_level: int,
           max_steps: int = 1 << 30):
    h = _Host(sl)
    present = _remove(h, int(key), max_level, max_steps)
    return h.commit(), present
