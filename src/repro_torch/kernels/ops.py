"""Public entry points of the port's kernels.

A CUDA tensor goes to the hand-written Hopper kernel; a CPU tensor goes to
the plain PyTorch version in ``ref.py``. There is no fallback between the
two: a CUDA launch that fails raises. Each wrapper counts the launches of
its kernel in a plain integer attribute (``hybrid_search.launches``,
``refresh_walk.launches``, ``paged_attention.launches``), so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from . import ref as ref_ops

_INT32_MAX = torch.iinfo(torch.int32).max
_I32 = torch.int32


def _check(keymin, blocks, queries) -> None:
    args = (("keymin", keymin, 1), ("blocks", blocks, 2),
            ("queries", queries, 1))
    for name, t, _ in args:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"hybrid_search: {name} must be a tensor")
    dev = queries.device
    for name, t, dim in args:
        if t.dtype is not _I32:
            raise TypeError(f"hybrid_search: {name} must be int32, "
                            f"got {t.dtype}")
        if t.ndim != dim:
            raise ValueError(f"hybrid_search: {name} must be {dim}-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"hybrid_search: {name} must be contiguous")
        if t.device != dev:
            raise ValueError("hybrid_search: inputs on different devices "
                             f"({t.device} vs {dev})")
    m, c = blocks.shape
    if keymin.shape[0] != m or m == 0 or c == 0:
        raise ValueError(f"hybrid_search: keymin {tuple(keymin.shape)} does "
                         f"not match blocks {tuple(blocks.shape)}, or one "
                         f"is empty")


def hybrid_search(keymin, blocks, queries):
    """Batched DiLi lookup (registry search + block sweep).

    ``keymin`` int32[M] sorted (INT32_MAX-padded), ``blocks`` int32[M, C]
    sorted rows (INT32_MAX-padded), ``queries`` int32[B] → ``slot``
    int32[B] (entry*C + pos, pos == C past a full block) and ``found``
    bool[B]. A query of ``INT32_MAX`` equals every pad cell, so its
    ``found`` is masked to False, as in the reference's public wrapper:
    by the kernel itself on the card, here on the CPU.
    """
    _check(keymin, blocks, queries)
    dev_type = queries.device.type
    if dev_type == "cuda":
        from . import hybrid_search as kernel
        out = kernel.launch(keymin, blocks, queries)
        hybrid_search.launches += 1
        return out
    if dev_type == "cpu":
        return hybrid_search_ref(keymin, blocks, queries)
    raise ValueError(f"hybrid_search: no kernel for device {queries.device}")


hybrid_search.launches = 0


def hybrid_search_ref(keymin, blocks, queries):
    """Plain twin of ``hybrid_search`` with the same sentinel masking, on
    any device."""
    slot, found = ref_ops.hybrid_search_ref(keymin, blocks, queries)
    return slot, found & (queries != _INT32_MAX)


# ---------------------------------------------------------- refresh walk

_INT32_RANGE = range(-2**31, 2**31)


def _check_refresh(tensors: dict, me, max_scan) -> None:
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"refresh_walk: {name} must be a tensor")
    dev = tensors["key"].device
    for name, t in tensors.items():
        want = torch.bool if name == "valid" else _I32
        if t.dtype is not want:
            raise TypeError(f"refresh_walk: {name} must be {want}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"refresh_walk: {name} must be contiguous")
        if t.device != dev:
            raise ValueError("refresh_walk: inputs on different devices "
                             f"({t.device} vs {dev})")
    keys, key = tensors["keys"], tensors["key"]
    if keys.ndim != 2 or 0 in keys.shape:
        raise ValueError(f"refresh_walk: keys must be a non-empty [M, C], "
                         f"got shape {tuple(keys.shape)}")
    if key.ndim != 1 or tensors["stct"].ndim != 1 or key.numel() == 0 \
            or tensors["stct"].numel() == 0:
        raise ValueError("refresh_walk: key and stct must be non-empty 1-D")
    m, c = keys.shape
    n = tuple(key.shape)
    shapes = dict(nxt=n, ctr=n, newloc=n, subhead=(m,), subtail=(m,),
                  reg_ctr=(m,), size=(), idx=(m, c), valid=(m,))
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"refresh_walk: {name} has shape "
                             f"{tuple(tensors[name].shape)}, not {shape}")
    for name, v in (("me", me), ("max_scan", max_scan)):
        if not isinstance(v, int) or v not in _INT32_RANGE:
            raise ValueError(f"refresh_walk: {name} must be an int32 "
                             f"integer, got {v!r}")


def refresh_walk(key, nxt, ctr, newloc, stct, subhead, subtail, reg_ctr,
                 size, keys, idx, valid, me: int, max_scan: int):
    """Rebuild the packed-block mirror's dirty rows
    (``core/blocks.py::refresh_blocks``).

    Pool columns ``key``, ``nxt``, ``ctr``, ``newloc`` int32[N]; ``stct``
    int32[NC]; registry columns ``subhead``, ``subtail``, ``reg_ctr``
    int32[M] and ``size`` int32[]; the blocks ``keys``, ``idx`` int32[M, C]
    and ``valid`` bool[M]; ``me`` the shard, ``max_scan`` the walk's bound
    in steps. Every live row that is not valid walks its chain from its
    SubHead; the rest keep their rows. Returns fresh ``keys``, ``idx``,
    ``valid`` and ``steps`` int32[M], the steps each row walked (0 where
    it did not), so ``steps.max()`` is the longest walk. The inputs are
    not written. On the card: one launch, nothing read by the host.
    """
    args = dict(key=key, nxt=nxt, ctr=ctr, newloc=newloc, stct=stct,
                subhead=subhead, subtail=subtail, reg_ctr=reg_ctr, size=size,
                keys=keys, idx=idx, valid=valid)
    _check_refresh(args, me, max_scan)
    dev_type = key.device.type
    if dev_type == "cuda":
        from . import refresh_walk as kernel
        out = kernel.launch(**args, me=me, max_scan=max_scan)
        refresh_walk.launches += 1
        return out
    if dev_type == "cpu":
        return refresh_walk_ref(**args, me=me, max_scan=max_scan)
    raise ValueError(f"refresh_walk: no kernel for device {key.device}")


refresh_walk.launches = 0
refresh_walk_ref = ref_ops.refresh_walk_ref


# ------------------------------------------------------- paged attention

_PA_DTYPES = (torch.float32, torch.bfloat16)


def _check_paged(q, k_pages, v_pages, page_table, seq_lens,
                 page_size: int) -> None:
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("seq_lens", seq_lens)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"paged_attention: {name} must be a tensor")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
        if t.device != q.device:
            raise ValueError("paged_attention: inputs on different devices "
                             f"({t.device} vs {q.device})")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} must be "
                         f"[B,H,D] and k_pages {tuple(k_pages.shape)} "
                         f"[P,S,KH,D]")
    if q.dtype not in _PA_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q/k_pages/v_pages must share one "
                        f"of {_PA_DTYPES}, got {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and seq_lens must be "
                        "int32")
    b, h, d = q.shape
    n_pages, s, kh, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d or n_pages == 0:
        raise ValueError(f"paged_attention: k_pages {tuple(k_pages.shape)} "
                         f"/ v_pages {tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match B={b}")
    if s != page_size:
        raise ValueError(f"paged_attention: page_size={page_size} but the "
                         f"pages hold {s} tokens")
    if kh == 0 or h % kh != 0 or not 1 <= h // kh <= 32:
        raise ValueError(f"paged_attention: H={h} query heads over KH={kh} "
                         f"KV heads: the kernel takes 1..32 query heads "
                         f"per KV head")
    if d % 16 != 0 or not 16 <= d <= 256:
        raise ValueError(f"paged_attention: head dim {d} must be a "
                         f"multiple of 16 in [16, 256]")
    if not 1 <= s <= 64:
        raise ValueError(f"paged_attention: page size {s} must be in "
                         f"[1, 64]")


def paged_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                    page_size: int):
    """Decode attention over paged KV (one query token per sequence).

    ``q`` [B, H, D]; ``k_pages``/``v_pages`` [P, S, KH, D] (f32 or bf16,
    S == ``page_size``); ``page_table`` int32[B, PP] (page ids, clamped
    into [0, P-1]; positions at or past ``seq_lens`` are masked, so tail
    entries may name any page); ``seq_lens`` int32[B] → [B, H, D] in
    ``q``'s dtype, with f32 arithmetic throughout.
    """
    _check_paged(q, k_pages, v_pages, page_table, seq_lens, page_size)
    if q.device.type == "cuda":
        from . import paged_attention as kernel
        out = kernel.launch(q, k_pages, v_pages, page_table, seq_lens)
        paged_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return ref_ops.paged_attention_ref(q, k_pages, v_pages, page_table,
                                           seq_lens, page_size=page_size)
    raise ValueError(f"paged_attention: no kernel for device {q.device}")


paged_attention.launches = 0
paged_attention_ref = ref_ops.paged_attention_ref
