"""Futures for the DiLi client API (DESIGN.md §9).

A ``DiLiClient`` call returns immediately with an ``OpFuture``; the op is
admitted, routed, executed and its result harvested by the client's
``pump()``/``drain()`` driver loop. Batched calls return a ``BatchResult``
wrapping one future per op in submission order.

Futures deliberately carry routing metadata (``shard`` = the predicted
owner at admission, ``src`` = the shard that actually executed the op) —
the mismatch between the two is the wrong-route signal the client's
registry cache refreshes on.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.types import OP_FIND, OP_INSERT, OP_REMOVE


class OpFuture:
    """One pending DiLi operation."""

    __slots__ = ("kind", "key", "value", "shard", "src", "op_id",
                 "via_replica", "_client", "_result")

    def __init__(self, client, kind: int, key: int, value: int = 0):
        self._client = client
        self.kind = int(kind)
        self.key = int(key)
        self.value = int(value)
        self.shard: Optional[int] = None    # predicted owner at admission
        self.src: Optional[int] = None      # shard that executed the op
        self.op_id: Optional[int] = None    # backend op id while in flight
        self.via_replica = False            # FIND aimed at a read replica
        self._result: Optional[int] = None

    # ------------------------------------------------------------- protocol
    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self, wait: bool = True) -> bool:
        """The op's linearized boolean result.

        If the op is still pending and ``wait`` is true, drives the owning
        client's ``drain()`` loop until it resolves; with ``wait=False`` a
        pending future raises ``RuntimeError`` instead.
        """
        if self._result is None:
            if not wait:
                raise RuntimeError(
                    f"op {self._opname()} key={self.key} still pending — "
                    f"pump()/drain() the client first")
            self._client.drain()
            if self._result is None:    # pragma: no cover - drain raises
                raise RuntimeError("drain() returned with op unresolved")
        return bool(self._result)

    def raw(self) -> int:
        """The raw RES_* code (result(wait=False) without bool coercion)."""
        if self._result is None:
            raise RuntimeError("op still pending")
        return int(self._result)

    def _resolve(self, value: int, src: int) -> None:
        self._result = int(value)
        self.src = int(src)

    def _opname(self) -> str:
        return {OP_FIND: "find", OP_INSERT: "insert",
                OP_REMOVE: "remove"}.get(self.kind, str(self.kind))

    def __repr__(self) -> str:
        state = (f"done result={bool(self._result)}" if self.done
                 else "pending")
        return f"<OpFuture {self._opname()}({self.key}) {state}>"


class BatchResult:
    """Futures of one batched submission, in submission order."""

    __slots__ = ("futures",)

    def __init__(self, futures: Sequence[OpFuture]):
        self.futures = list(futures)

    @property
    def done(self) -> bool:
        return all(f.done for f in self.futures)

    def results(self, wait: bool = True) -> List[bool]:
        return [f.result(wait=wait) for f in self.futures]

    def __iter__(self):
        return iter(self.futures)

    def __len__(self) -> int:
        return len(self.futures)

    def __getitem__(self, i):
        return self.futures[i]

    def __repr__(self) -> str:
        ndone = sum(f.done for f in self.futures)
        return f"<BatchResult {ndone}/{len(self.futures)} done>"


class RangeResult:
    """One pending RANGE(lo, hi, limit) scan (DESIGN.md §16).

    Resolves to the scan's sorted ``(key, value)`` items plus the item
    count the terminal result reported. A negative count is a protocol
    error code (e.g. ``RES_OVERFLOW`` when the scan exhausted its hop
    budget before emitting anything); ``items()``/``count()`` raise on
    it, ``raw()`` exposes it.
    """

    __slots__ = ("lo", "hi", "limit", "shard", "src", "op_id",
                 "_client", "_count", "_items")

    def __init__(self, client, lo: int, hi: int, limit: int):
        self._client = client
        self.lo = int(lo)
        self.hi = int(hi)
        self.limit = int(limit)
        self.shard: Optional[int] = None    # predicted owner of ``lo``
        self.src: Optional[int] = None      # shard that sent the terminal
        self.op_id: Optional[int] = None
        self._count: Optional[int] = None
        self._items: Optional[List[Tuple[int, int]]] = None

    @property
    def done(self) -> bool:
        return self._count is not None

    def _wait(self, wait: bool) -> None:
        if self._count is None:
            if not wait:
                raise RuntimeError(
                    f"range [{self.lo}, {self.hi}) still pending — "
                    f"pump()/drain() the client first")
            self._client.drain()

    def items(self, wait: bool = True) -> List[Tuple[int, int]]:
        """The scanned ``(key, value)`` pairs, sorted by key."""
        self._wait(wait)
        if self._count < 0:
            raise RuntimeError(
                f"range [{self.lo}, {self.hi}) failed with code "
                f"{self._count}")
        return list(self._items)

    def keys(self, wait: bool = True) -> List[int]:
        return [k for k, _ in self.items(wait)]

    def count(self, wait: bool = True) -> int:
        self._wait(wait)
        if self._count < 0:
            raise RuntimeError(
                f"range [{self.lo}, {self.hi}) failed with code "
                f"{self._count}")
        return int(self._count)

    def raw(self) -> int:
        """The raw terminal count / error code (no wait)."""
        if self._count is None:
            raise RuntimeError("range still pending")
        return int(self._count)

    def _resolve(self, count: int, src: int,
                 items: List[Tuple[int, int]]) -> None:
        self._count = int(count)
        self.src = int(src)
        self._items = items

    def __repr__(self) -> str:
        state = (f"done count={self._count}" if self.done else "pending")
        return f"<RangeResult [{self.lo}, {self.hi}) {state}>"


class BatchResult:
    """Futures of one batched submission, in submission order."""

    __slots__ = ("futures",)

    def __init__(self, futures: Sequence[OpFuture]):
        self.futures = list(futures)

    @property
    def done(self) -> bool:
        return all(f.done for f in self.futures)

    def results(self, wait: bool = True) -> List[bool]:
        return [f.result(wait=wait) for f in self.futures]

    def __iter__(self):
        return iter(self.futures)

    def __len__(self) -> int:
        return len(self.futures)

    def __getitem__(self, i):
        return self.futures[i]

    def __repr__(self) -> str:
        ndone = sum(f.done for f in self.futures)
        return f"<BatchResult {ndone}/{len(self.futures)} done>"
