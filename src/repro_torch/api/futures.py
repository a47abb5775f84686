"""Futures for the DiLi client API (DESIGN.md §9).

A ``DiLiClient`` call returns immediately with an ``OpFuture``; the op is
admitted, routed, executed and its result harvested by the client's
``pump()``/``drain()`` driver loop. (RANGE futures come with the RANGE
slice of the port.) Batched calls return a ``BatchResult``
wrapping one future per op in submission order.

Futures deliberately carry routing metadata (``shard`` = the predicted
owner at admission, ``src`` = the shard that actually executed the op) —
the mismatch between the two is the wrong-route signal the client's
registry cache refreshes on.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
