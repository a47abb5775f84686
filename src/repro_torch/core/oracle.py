"""Sequential oracle for DiLi client semantics.

A linearizable sorted set: applying the same linearized op sequence to the
oracle and to DiLi (in DiLi's linearization order) must give identical
results and identical final key sets — regardless of any interleaved
Split/Move/Switch/Merge background operations (which are invisible to
clients). This is the property every system test asserts.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from .types import OP_FIND, OP_INSERT, OP_NOP, OP_REMOVE


class OracleList:
    """Plain sorted-set semantics of find/insert/remove."""

    def __init__(self, keys: Iterable[int] = ()):  # noqa: D107
        self._keys = set(int(k) for k in keys)

    def find(self, key: int) -> bool:
        return int(key) in self._keys

    def insert(self, key: int) -> bool:
        key = int(key)
        if key in self._keys:
            return False
        self._keys.add(key)
        return True

    def remove(self, key: int) -> bool:
        key = int(key)
        if key not in self._keys:
            return False
        self._keys.remove(key)
        return True

    def apply(self, kind: int, key: int) -> bool:
        if kind == OP_FIND:
            return self.find(key)
        if kind == OP_INSERT:
            return self.insert(key)
        if kind == OP_REMOVE:
            return self.remove(key)
        if kind == OP_NOP:
            return False
        raise ValueError(f"unknown op kind {kind}")

    def apply_batch(self, kinds: Sequence[int], keys: Sequence[int]) -> List[bool]:
        return [self.apply(int(k), int(x)) for k, x in zip(kinds, keys)]

    def snapshot(self) -> Tuple[int, ...]:
        return tuple(sorted(self._keys))

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._keys
