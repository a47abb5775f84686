"""Launch the Hopper ``refresh_walk`` kernel (``csrc/refresh_walk.cu``).

Built at first use by ``kernels/build.py`` (``nvcc`` for ``sm_90a`` into a
plain-C library under ``build/kernels/``, loaded with ``ctypes``), as
``hybrid_search`` is; nothing here runs at import. The launch goes to the
inputs' device, made current around the ctypes call, so a shard on
``cuda:1`` refreshes there while ``cuda:0`` is current. Nothing is read
back: the outputs stay on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

NAME = "refresh_walk"
_SYMBOLS = {"refresh_walk_launch": (
    [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    ctypes.c_int)}

_launch_fn = None


def build(verbose: bool = False):
    """Compile the kernel library if needed; returns its path."""
    return B.build(NAME, verbose)


def _fn():
    global _launch_fn
    if _launch_fn is None:
        _launch_fn = B.load(NAME, _SYMBOLS).refresh_walk_launch
    return _launch_fn


def launch(key, nxt, ctr, newloc, stct, subhead, subtail, reg_ctr, size,
           keys, idx, valid, me: int, max_scan: int):
    """Launch on the inputs' device and its current CUDA stream. Inputs
    are validated by the public wrapper (``kernels/ops.py``); the outputs
    (new ``keys``, ``idx``, ``valid`` and each row's ``steps``) are fresh
    buffers allocated here."""
    m, c = keys.shape
    dev = key.device
    out_keys = torch.empty_like(keys)
    out_idx = torch.empty_like(idx)
    out_valid = torch.empty_like(valid)
    steps = torch.empty((m,), dtype=torch.int32, device=dev)
    ins = (key, nxt, ctr, newloc, stct, subhead, subtail, reg_ctr, size,
           keys, idx, valid, out_keys, out_idx, out_valid, steps)
    with torch.cuda.device(dev):
        err = _fn()(*(t.data_ptr() for t in ins), m, c, key.shape[0],
                    stct.shape[0], me, max_scan,
                    torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"refresh_walk launch failed: cudaError {err}")
    return out_keys, out_idx, out_valid, steps
