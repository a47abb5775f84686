"""Shared neural building blocks, as functions over tensors (the
reference's ``models/layers.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy (cast to f32 at use), as the
    reference computes them: a float32 power drifts from it."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [..., S] int."""
    d = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(d, theta).astype(np.float32)).to(
        x.device)
    ang = positions[..., None].float() * freqs              # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def init_dense(shape, *, generator: torch.Generator, scale=None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal(0, 1) * scale (default 1/sqrt(fan_in)), drawn in f32 from
    ``generator`` on ``device`` and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def cross_entropy(logits, targets, *, z_loss: float = 1e-4):
    """Token CE with optional z-loss; logits [..., V] (taken in f32),
    targets int [...]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse.square()
    return loss
