"""Int8 gradient compression with error feedback (the reference's
``optim/compress.py``).

Per tensor: quantize to int8 with one f32 scale before the reduction,
keep the quantization residual locally and fold it into the next step's
gradient (error feedback), which keeps SGD unbiased in expectation.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch


def int8_compress(x, residual=None):
    """Returns (q_int8, scale, new_residual)."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    amax = xf.abs().max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, xf - deq


def int8_decompress(q, scale):
    return q.float() * scale


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest`` shaped alike)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def compress_tree(grads, residuals=None):
    """(q, scales, residuals), each shaped as ``grads``."""
    out = _map(int8_compress, grads) if residuals is None else \
        _map(int8_compress, grads, residuals)
    return tuple(_map(lambda t: t[i], out) for i in range(3))


def decompress_tree(q, s):
    return _map(int8_decompress, q, s)
