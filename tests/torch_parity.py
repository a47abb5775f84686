"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

One workload goes through the JAX reference (``repro``) and the PyTorch
port (``repro_torch``, on the CPU); the integer protocol must agree bit
for bit. States are compared over *canonical* int32 views: the
reference keeps refs as ``uint32``, the port as the same bits in
``int32``, so a uint32 leaf is viewed as int32 before comparing or
hashing. (The reference's own ``core.net.digest.state_digest`` hashes
``str(dtype)`` and can never match across the two packages.)
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

# The port's CPU rounds are many small tensor ops. At torch's default of
# one intra-op thread per core, test processes side by side (pytest-xdist
# workers) oversubscribe the cores and a file runs several times slower
# than alone (on an 8-core CPU, three zipf files at once took ~250 s each
# against 38-61 s alone); one thread per process keeps each near its
# solo time. Every worker imports this module when it collects the
# port's tests.
torch.set_num_threads(1)


def canonical(leaf) -> np.ndarray:
    """A tensor or array leaf as numpy, uint32 viewed as int32."""
    if hasattr(leaf, "detach"):
        leaf = leaf.detach().cpu().numpy()
    arr = np.array(leaf, order="C")   # keeps 0-d leaves 0-d
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return arr


def named_leaves(tree, path=""):
    """(path, leaf) pairs of a nested NamedTuple/list, in field order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from named_leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from named_leaves(x, f"{path}[{i}]")
    else:
        yield path, tree


def digest(*trees) -> str:
    """SHA-256 over every leaf's shape, canonical dtype and bytes."""
    h = hashlib.sha256()
    for tree in trees:
        for _, leaf in named_leaves(tree):
            arr = canonical(leaf)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def assert_trees_equal(ref, port, what="state"):
    """Field-by-field bit equality, naming the first field that differs."""
    a = list(named_leaves(ref))
    b = list(named_leaves(port))
    assert [p for p, _ in a] == [p for p, _ in b], f"{what}: field layout"
    for (path, x), (_, y) in zip(a, b):
        x, y = canonical(x), canonical(y)
        assert x.dtype == y.dtype and x.shape == y.shape, \
            f"{what}{path}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
        if not np.array_equal(x, y):
            bad = np.argwhere(x != y)[:5].tolist()
            raise AssertionError(f"{what}{path} differs at {bad}")

