"""Checkpoints as the reference writes them: one ``.npz`` per step.

A tree (nested dicts, NamedTuples, lists and tuples of tensors, numpy
arrays or scalars) is stored leaf by leaf under the key the reference's
``checkpoint/ckpt.py`` gives it: the path of dict keys, NamedTuple field
names and sequence indices joined with ``/`` (``state/pool/key``), which is
how ``jax.tree_util`` key paths print once their brackets, dots and quotes
are stripped. Dict keys are visited in sorted order, as jax visits them.
So a file written by either package loads in the other.

Leaves are copied to the host when ``save`` is called (a bf16 leaf as f32,
a lossless upcast, as the reference does), so the caller may go on
updating its tensors in place. Writes go to ``<step>.tmp.npz`` and are
atomically renamed, so a failure mid-write never corrupts the latest
checkpoint. ``CheckpointManager`` keeps the newest ``keep`` steps and
writes on a background thread (``async_write=True``, the training loop's
mode: one write in flight, its error raised by the next ``wait``, ``save``
or ``restore_latest``) or at the call site (``async_write=False``, the
snapshots' mode).
"""
from __future__ import annotations

import os
import re
import threading
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
    """A copy of ``leaf`` on the host that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.array(leaf)


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
        if isinstance(tmpl, torch.Tensor) and tmpl.dtype == torch.bfloat16:
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=tmpl.device, dtype=tmpl.dtype)
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


def _write(arrs: dict, path: str) -> None:
    tmp = path[:-4] + ".tmp"          # np.savez appends ".npz"
    np.savez(tmp, **arrs)
    os.replace(tmp + ".npz", path)


def save_pytree(tree, path: str) -> None:
    if not path.endswith(".npz"):
        path = path + ".npz"
    _write(flatten(tree), path)


def restore_pytree(template, path: str, shardings=None):
    """Restore into ``template``'s structure: each leaf takes the
    template leaf's dtype (and, for a tensor, its device). ``shardings``
    (nested dicts as the template's, whose leaves are ``(mesh,
    placements)``) lays every restored tensor out on a mesh with
    ``distribute_tensor``: the elastic re-layout, onto whatever mesh the
    run now has."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        tree = _restore(template, data, "")
    return tree if shardings is None else _distribute(tree, shardings)


def _distribute(tree, shardings):
    if isinstance(tree, dict):
        return {k: _distribute(v, shardings[k]) for k, v in tree.items()}
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tree, *shardings)


class CheckpointManager:
    """Step-numbered checkpoints in one directory, newest ``keep`` kept."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}.npz")

    def _steps(self):
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := re.fullmatch(r"step_(\d+)\.npz", f)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def wait(self) -> None:
        """Join the write in flight; raise the error of a failed one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def save(self, step: int, tree: Any) -> None:
        self.wait()                       # one write in flight at a time
        arrs = flatten(tree)              # host copies before returning
        path = self._path(step)

        def write():
            try:
                _write(arrs, path)
                self._gc()
            except Exception as e:  # raised by the next wait()/save()
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_pending()

    def restore_latest(self, template):
        """(step, tree) of the newest checkpoint restored into
        ``template``'s structure, or (None, None) when there is none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_pytree(template, self._path(step))

    def _gc(self) -> None:
        for s in self._steps()[:-self.keep]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass
