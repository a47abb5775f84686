"""Checkpoints as the reference writes them: one ``.npz`` per step.

A tree (nested dicts, NamedTuples, lists and tuples of tensors, numpy
arrays or scalars) is stored leaf by leaf under the key the reference's
``checkpoint/ckpt.py`` gives it: the path of dict keys, NamedTuple field
names and sequence indices joined with ``/`` (``state/pool/key``), which is
how ``jax.tree_util`` key paths print once their brackets, dots and quotes
are stripped. Dict keys are visited in sorted order, as jax visits them.
So a file written by either package loads in the other.

Writes go to ``<step>.tmp.npz`` and are atomically renamed, so a failure
mid-write never corrupts the latest checkpoint. ``CheckpointManager``
writes synchronously (an error surfaces at the call site) and keeps the
newest ``keep`` steps.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of an inner node in the reference's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _paths(tree, prefix=""):
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            yield prefix, tree
        return
    for k, child in kids:
        yield from _paths(child, f"{prefix}/{k}" if prefix else k)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten(tree) -> dict:
    """``{path: numpy array}`` for every leaf of ``tree``."""
    return {k: _host(v) for k, v in _paths(tree)}


def _restore(tmpl, data, prefix):
    kids = _children(tmpl)
    if kids is None:
        arr = data[prefix]
        shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) \
            else np.shape(tmpl)
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {prefix}: shape {arr.shape} "
                             f"vs template {shape}")
        if isinstance(tmpl, torch.Tensor):
            # astype wraps the reference's uint32 refs onto the same int32
            # bit patterns
            want = torch.empty((), dtype=tmpl.dtype).numpy().dtype
            return torch.from_numpy(
                np.array(arr.astype(want), order="C")).to(tmpl.device)
        return arr.astype(np.asarray(tmpl).dtype)
    vals = [_restore(child, data, f"{prefix}/{k}" if prefix else k)
            for k, child in kids]
    if isinstance(tmpl, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if _is_namedtuple(tmpl):
        return type(tmpl)(*vals)
    return type(tmpl)(vals)


def restore_pytree(template, path: str):
    """Restore into ``template``'s structure: each leaf takes the
    template leaf's dtype (and, for a tensor, its device)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return _restore(template, data, "")


class CheckpointManager:
    """Step-numbered checkpoints in one directory, newest ``keep`` kept."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.npz")

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := re.fullmatch(r"step_(\d+)\.npz", f)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        path = self._path(step)
        tmp = path[:-4] + ".tmp"          # np.savez appends ".npz"
        np.savez(tmp, **flatten(tree))
        os.replace(tmp + ".npz", path)
        for s in self._steps()[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
