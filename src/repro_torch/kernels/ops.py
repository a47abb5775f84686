"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written Hopper kernel; a CPU tensor goes to
the plain PyTorch version in ``ref.py``. There is no fallback between the
two: a CUDA launch that fails raises. Each wrapper counts the launches of
its kernel in a plain integer attribute (``hybrid_search.launches``), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import ref as ref_ops

_INT32_MAX = torch.iinfo(torch.int32).max


def _check(keymin, blocks, queries) -> None:
    for name, t, dim in (("keymin", keymin, 1), ("blocks", blocks, 2),
                         ("queries", queries, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"hybrid_search: {name} must be a tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"hybrid_search: {name} must be int32, "
                            f"got {t.dtype}")
        if t.dim() != dim:
            raise ValueError(f"hybrid_search: {name} must be {dim}-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"hybrid_search: {name} must be contiguous")
        if t.device != queries.device:
            raise ValueError("hybrid_search: inputs on different devices "
                             f"({t.device} vs {queries.device})")
    if keymin.shape[0] != blocks.shape[0] or keymin.shape[0] == 0:
        raise ValueError(f"hybrid_search: keymin {tuple(keymin.shape)} does "
                         f"not match blocks {tuple(blocks.shape)}")


def hybrid_search(keymin, blocks, queries):
    """Batched DiLi lookup (registry binary search + block sweep).

    ``keymin`` int32[M] sorted (INT32_MAX-padded), ``blocks`` int32[M, C]
    sorted rows (INT32_MAX-padded), ``queries`` int32[B] → ``slot``
    int32[B] (entry*C + pos, pos == C past a full block) and ``found``
    bool[B]. A query of ``INT32_MAX`` equals every pad cell, so its
    ``found`` is masked to False, as in the reference's public wrapper.
    """
    _check(keymin, blocks, queries)
    if queries.device.type == "cuda":
        from . import hybrid_search as kernel
        slot, found = kernel.launch(keymin, blocks, queries)
        hybrid_search.launches += 1
    elif queries.device.type == "cpu":
        slot, found = ref_ops.hybrid_search_ref(keymin, blocks, queries)
    else:
        raise ValueError(f"hybrid_search: no kernel for device "
                         f"{queries.device}")
    return slot, found & (queries != _INT32_MAX)


hybrid_search.launches = 0


def hybrid_search_ref(keymin, blocks, queries):
    """Plain twin of ``hybrid_search`` with the same sentinel masking, on
    any device."""
    slot, found = ref_ops.hybrid_search_ref(keymin, blocks, queries)
    return slot, found & (queries != _INT32_MAX)
