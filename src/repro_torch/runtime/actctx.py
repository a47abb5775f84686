"""Activation-sharding context (the reference's ``runtime/actctx.py``):
model code asks for a layout by *role*, the launcher binds roles to a
mesh's placements before it runs a step.

Keeps model code mesh-agnostic while letting the dry-run and the trainer
pin the layouts that matter (sequence-parallel hidden states between
layers, the MoE dispatch buffers). A bound role is ``(mesh, placements)``;
``constrain`` redistributes a DTensor, and its gradient, onto it (as
``jax.lax.with_sharding_constraint`` does) and returns anything else
(a plain tensor, or a DTensor under an unbound role) as it is, so on one
card with no role bound it changes nothing.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch

_CTX: Dict[str, Optional[object]] = {}
_ACTIVE: list = []      # the roles whose redistribution is running


def active() -> str:
    """The role whose redistribution issues the current op, or ""."""
    return _ACTIVE[-1] if _ACTIVE else ""


@contextmanager
def _tag(role: str):
    _ACTIVE.append(role)
    try:
        yield
    finally:
        _ACTIVE.pop()


def set_roles(**roles) -> None:
    _CTX.clear()
    _CTX.update(roles)


@contextmanager
def roles(**kw):
    old = dict(_CTX)
    _CTX.update(kw)
    try:
        yield
    finally:
        _CTX.clear()
        _CTX.update(old)


class _Constrain(torch.autograd.Function):
    """Redistribute onto a layout, and the gradient onto a layout: by
    default the same one, as the transpose of XLA's sharding constraint is
    the same constraint on the cotangent (DTensor would otherwise leave the
    gradient wherever the op before it produced it)."""

    @staticmethod
    def forward(ctx, x, role, mesh, placements, grad_placements):
        ctx.role, ctx.layout = role, (mesh, grad_placements)
        with _tag(role):
            # (a non-contiguous local shard can fail DTensor's views)
            return x.contiguous().redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        with _tag(ctx.role):
            g = g.contiguous().redistribute(*ctx.layout)
        return g, None, None, None, None


def constrain(x, role: str):
    """``x`` on ``role``'s layout. A role is bound to ``(mesh,
    placements)``, or to ``(mesh, placements, grad_placements)`` where
    the gradient takes another layout (sequence parallelism's gather
    forward, reduce-scatter backward)."""
    s = _CTX.get(role)
    if s is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, placements, *grad = s
    return _Constrain.apply(x, role, mesh, tuple(placements),
                            tuple(grad[0] if grad else placements))


def local_rows(fn, role: str, rows, shared=()):
    """``fn(*rows, *shared)`` row by row: for ops DTensor has no sharding
    rule for (``argsort``, ``searchsorted``, the SSM scans' step loop).
    Under a bound role whose layout shards the leading (batch) dim alone,
    every ``rows`` tensor (or None) moves onto that layout, every
    ``shared`` tensor is replicated, ``fn`` runs on the local shards, and
    its outputs (each batch-leading) come back as DTensors on the
    layout; otherwise (no role, or no DTensor among ``rows``) it is
    ``fn(*rows, *shared)``."""
    s = _CTX.get(role)
    from torch.distributed.tensor import DTensor, Replicate
    if s is None or not any(isinstance(x, DTensor) for x in rows):
        return fn(*rows, *shared)
    mesh, layout = s[:2]
    rep = [Replicate()] * mesh.ndim

    def local(x, pl):
        if x is None:
            return None
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, rep, run_check=False)
        return x.redistribute(mesh, pl).to_local()

    with _tag(role):
        rows = [local(x, layout) for x in rows]
        shared = [local(x, rep) for x in shared]
    out = fn(*rows, *shared)
    from torch.utils._pytree import tree_map_only
    return tree_map_only(torch.Tensor, lambda y: DTensor.from_local(
        y, mesh, layout, run_check=False), out)
