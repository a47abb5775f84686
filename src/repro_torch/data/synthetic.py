"""Deterministic sharded synthetic LM data pipeline (the reference's
``data/synthetic.py``).

Content is a pure function of (seed, step, shard): a restart at step N
reproduces the same stream with no loss or duplication (a checkpoint
stores only the step counter), and shards are disjoint across
data-parallel ranks. The numbers come from numpy exactly as the
reference draws them, so tokens and embeddings are bitwise the
reference's; the batch's tensors go on ``device`` (CUDA unless the caller
asks for the CPU).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.types import resolve_device
from ..models.config import ArchConfig, ShapeCell


def _tokens(seed: int, step: int, shard: int, shape, vocab: int):
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard, 0xD171]))
    return rng.integers(0, vocab, size=shape, dtype=np.int32)


def _normal(seed_words, shape) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence(seed_words))
    return rng.standard_normal(shape).astype(np.float32)


def _put(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return t if dtype is None else t.to(dtype)


def make_train_batch(cfg: ArchConfig, cell: ShapeCell, *, seed: int = 0,
                     step: int = 0, shard: int = 0, num_shards: int = 1,
                     dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """One data-parallel shard's batch for a training step: int32
    ``tokens``/``targets`` [b, s] (and ``frame_embeds`` or
    ``patch_embeds`` in ``dtype`` for the stub modalities)."""
    if cell.global_batch % num_shards:
        raise ValueError(f"global batch {cell.global_batch} does not split "
                         f"over {num_shards} shards")
    dev = resolve_device(device)
    b = cell.global_batch // num_shards
    s = cell.seq_len
    base = _tokens(seed, step, shard, (b, s + 1), cfg.vocab)
    tokens, targets = base[:, :-1], base[:, 1:]
    if cfg.modality == "audio_stub":
        emb = _normal([seed, step, shard, 1], (b, s, cfg.d_model))
        return {"frame_embeds": _put(emb, dev, dtype),
                "targets": _put(targets, dev)}
    if cfg.modality == "vision_stub":
        li = min(s // 2, 2048)           # anyres patch budget
        lt = s - li
        patches = _normal([seed, step, shard, 2], (b, li, cfg.d_model))
        return {"patch_embeds": _put(patches, dev, dtype),
                "tokens": _put(tokens[:, :lt], dev),
                "targets": _put(targets, dev)}
    return {"tokens": _put(tokens, dev), "targets": _put(targets, dev)}


def make_serve_batch(cfg: ArchConfig, cell: ShapeCell, *, decode: bool,
                     seed: int = 0, shard: int = 0, num_shards: int = 1,
                     dtype=torch.bfloat16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Request batch for prefill (full prompt) or decode (one token)."""
    if cell.global_batch % num_shards:
        raise ValueError(f"global batch {cell.global_batch} does not split "
                         f"over {num_shards} shards")
    dev = resolve_device(device)
    b = cell.global_batch // num_shards
    t = 1 if decode else cell.seq_len
    tokens = _tokens(seed, 0, shard, (b, t), cfg.vocab)
    if cfg.modality == "audio_stub":
        emb = _normal([seed, shard, 3], (b, t, cfg.d_model))
        return {"frame_embeds": _put(emb, dev, dtype)}
    if cfg.modality == "vision_stub" and not decode:
        li = min(t // 2, 2048)
        patches = _normal([seed, shard, 4], (b, li, cfg.d_model))
        return {"patch_embeds": _put(patches, dev, dtype),
                "tokens": _put(tokens[:, :t - li], dev)}
    return {"tokens": _put(tokens, dev)}
