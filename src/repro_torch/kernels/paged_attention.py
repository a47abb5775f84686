"""Launch the Hopper ``paged_attention`` kernel (``csrc/paged_attention.cu``).

The source is built at first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` into a plain-C library under ``build/kernels/``, loaded with
``ctypes``). Nothing here runs at import: the CPU tests import this module
on machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

NAME = "paged_attention"
_SYMBOLS = {"paged_attention_launch": (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build(verbose: bool = False):
    """Compile the kernel library if needed; returns its path."""
    return B.build(NAME, verbose)


def launch(q, k_pages, v_pages, page_table, seq_lens) -> torch.Tensor:
    """Launch on the current CUDA stream. Inputs are validated by the
    public wrapper (``kernels/ops.py``); the output is allocated here."""
    lib = B.load(NAME, _SYMBOLS)
    b, h, d = q.shape
    n_pages, s, kh, _ = k_pages.shape
    pp = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        b, h, kh, d, n_pages, s, pp, float(d ** -0.5), _DTYPES[q.dtype],
        stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    return out
