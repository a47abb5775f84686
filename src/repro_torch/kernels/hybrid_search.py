"""Launch the Hopper ``hybrid_search`` kernel (``csrc/hybrid_search.cu``).

The source is built at first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` into a plain-C library under ``build/kernels/``, loaded with
``ctypes``). Nothing here runs at import: the CPU tests import this module
on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build as B

NAME = "hybrid_search"
_SYMBOLS = {"hybrid_search_launch": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    ctypes.c_int)}


def build(verbose: bool = False):
    """Compile the kernel library if needed; returns its path."""
    return B.build(NAME, verbose)


def levels(m: int) -> int:
    """Binary-search steps over M registry entries (as the TPU kernel)."""
    return max(1, math.ceil(math.log2(max(m, 2))))


def launch(keymin: torch.Tensor, blocks: torch.Tensor,
           queries: torch.Tensor):
    """Launch on the current CUDA stream. Inputs are validated by the
    public wrapper (``kernels/ops.py``); outputs are allocated here."""
    lib = B.load(NAME, _SYMBOLS)
    m, c = blocks.shape
    b = queries.shape[0]
    slot = torch.empty((b,), dtype=torch.int32, device=queries.device)
    found = torch.empty((b,), dtype=torch.bool, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.hybrid_search_launch(
        keymin.data_ptr(), blocks.data_ptr(), queries.data_ptr(),
        slot.data_ptr(), found.data_ptr(), m, c, b, levels(m), stream)
    if err != 0:
        raise RuntimeError(f"hybrid_search launch failed: cudaError {err}")
    return slot, found
