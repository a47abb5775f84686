"""Launch the Hopper ``paged_attention`` kernel (``csrc/paged_attention.cu``).

The source is built at first use by ``kernels/build.py`` (``nvcc`` for
``sm_90a`` into a plain-C library under ``build/kernels/``, loaded with
``ctypes``). Nothing here runs at import: the CPU tests import this module
on machines without ``nvcc`` or a card.

The kernel splits each sequence's pages across blocks (``split_pages``)
and merges the splits in the same launch. The merge's per-unit counters
are an int32 tensor cached per device and reset by the kernel itself, so
launches that share them must run in order on one stream.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as B

NAME = "paged_attention"
_SYMBOLS = {"paged_attention_launch": (
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# pages one split may hold: its page ids sit in shared memory (4 KB)
MAX_SPLIT_PAGES = 1024
# query heads one block computes, one warp each (the kernel's kMaxHeads)
MAX_BLOCK_HEADS = 8
# blocks per SM the page splits aim for
BLOCKS_PER_SM = 2

_sm_count: dict = {}
_counters: dict = {}


def block_heads(groups: int) -> int:
    """Query heads per block: the largest divisor of ``groups`` (H/KH)
    that is at most ``MAX_BLOCK_HEADS``. The G heads of a KV head go to
    G / this blocks, each reading the KV head's pages."""
    return max(n for n in range(1, MAX_BLOCK_HEADS + 1) if groups % n == 0)


def split_pages(pp: int, units: int, sms: int) -> tuple[int, int]:
    """(splits, pages per split) for ``pp`` pages of each of ``units``
    (sequence, KV head, head block) units on a card of ``sms`` SMs: about
    two blocks per SM (a block walks its pages one dependent step at a
    time, so shorter splits finish sooner, while each split adds a partial
    to merge), a single split when the units alone fill the card, at most
    ``MAX_SPLIT_PAGES`` pages in a split. Every split holds at least one
    page (the last may hold fewer than the others)."""
    if pp <= 0:
        return 1, 1
    want = 1 if units >= sms else -(-BLOCKS_PER_SM * sms // max(units, 1))
    per = min(-(-pp // min(want, pp)), MAX_SPLIT_PAGES)
    return -(-pp // per), per


def plan(b: int, h: int, kh: int, pp: int, sms: int) -> tuple[int, int, int]:
    """(query heads per block, splits, pages per split) of a launch."""
    gb = block_heads(h // kh)
    return (gb, *split_pages(pp, b * (h // gb), sms))


def sm_count(device) -> int:
    """The card's SM count, read once per device."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    n = _sm_count.get(idx)
    if n is None:
        n = _sm_count[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def _unit_counters(device, units: int) -> torch.Tensor:
    """Zeroed int32 counters, one per unit, cached per device; the kernel
    leaves them zero after each launch."""
    idx = device.index
    c = _counters.get(idx)
    if c is None or c.numel() < units:
        c = _counters[idx] = torch.zeros(units, dtype=torch.int32,
                                         device=device)
    return c


def build(verbose: bool = False):
    """Compile the kernel library if needed; returns its path."""
    return B.build(NAME, verbose)


def launch(q, k_pages, v_pages, page_table, seq_lens, *,
           splits: tuple[int, int] | None = None) -> torch.Tensor:
    """Launch on the current CUDA stream. Inputs are validated by the
    public wrapper (``kernels/ops.py``); the output and the split
    workspace are allocated here. ``splits`` = (splits, pages per split)
    overrides ``split_pages`` (for measurement; their product must cover
    the table's pages)."""
    lib = B.load(NAME, _SYMBOLS)
    b, h, d = q.shape
    n_pages, s, kh, _ = k_pages.shape
    pp = page_table.shape[1]
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: k_pages/v_pages must start on a "
                         "16-byte boundary (the kernel copies 16-byte "
                         "chunks)")
    gb, n_split, per = plan(b, h, kh, pp, sm_count(q.device))
    if splits is not None:
        n_split, per = splits
        if n_split < 1 or per < 1 or n_split * per < pp \
                or per > MAX_SPLIT_PAGES:
            raise ValueError(f"paged_attention: {n_split} splits of {per} "
                             f"pages do not cover {pp} pages")
    units = b * (h // gb)
    out = torch.empty_like(q)
    ws = counters = None
    if n_split > 1:
        ws = torch.empty(units * n_split * gb * (d + 2),
                         dtype=torch.float32, device=q.device)
        counters = _unit_counters(q.device, units)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(),
        b, h, kh, d, n_pages, s, pp, n_split, per, gb, float(d ** -0.5),
        _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {err}")
    return out
