"""Launch the Hopper ``hybrid_search`` kernel (``csrc/hybrid_search.cu``).

The source is built at first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` into a plain-C library under ``build/kernels/``, loaded with
``ctypes``). Nothing here runs at import: the CPU tests import this module
on machines without ``nvcc`` or a card.

A call is mostly host time (the kernel takes a few microseconds), so the
launch path is kept short: the ctypes function is looked up once per
process, both outputs come from one allocation, and the current stream is
read as a raw handle.

A ``<<<>>>`` launch behind the C interface goes to the calling thread's
current device, whatever stream it is handed, so the launch runs with the
inputs' device made current: a shard on ``cuda:1`` launches there even
while ``cuda:0`` is current.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

NAME = "hybrid_search"
_SYMBOLS = {"hybrid_search_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    ctypes.c_int)}

_launch_fn = None


def build(verbose: bool = False):
    """Compile the kernel library if needed; returns its path."""
    return B.build(NAME, verbose)


def _fn():
    global _launch_fn
    if _launch_fn is None:
        _launch_fn = B.load(NAME, _SYMBOLS).hybrid_search_launch
    return _launch_fn


def launch(keymin: torch.Tensor, blocks: torch.Tensor,
           queries: torch.Tensor):
    """Launch on the inputs' device and its current CUDA stream. Inputs
    are validated by the public wrapper (``kernels/ops.py``); the outputs
    are allocated here, as one buffer: ``slot`` int32[B] in its first 4*B
    bytes, ``found`` bool[B] in the last B."""
    m, c = blocks.shape
    b = queries.shape[0]
    dev = queries.device
    out = torch.empty((5 * b,), dtype=torch.uint8, device=dev)
    slot = out[:4 * b].view(torch.int32)
    found = out[4 * b:].view(torch.bool)
    with torch.cuda.device(dev):
        err = _fn()(keymin.data_ptr(), blocks.data_ptr(),
                    queries.data_ptr(), out.data_ptr(),
                    out.data_ptr() + 4 * b, m, c, b,
                    torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"hybrid_search launch failed: cudaError {err}")
    return slot, found
