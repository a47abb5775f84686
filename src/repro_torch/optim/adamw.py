"""AdamW with decoupled weight decay, cosine schedule and global-norm
clipping (the reference's ``optim/adamw.py``), as plain functions on
tensors.

Parameters are an ``nn.Module`` (or a ``{name: tensor}`` dict); gradients
and the moments are ``{name: tensor}`` dicts under the module's parameter
names (``convert.py`` carries them to the reference's tree and back). The
moments are f32 whatever the parameters' dtype, decay applies to every
parameter, and ``adamw_update`` writes parameters and moments in place
under ``torch.no_grad()`` — the reference returns new arrays — with no
host sync: the step, the learning rate and the clip scale stay tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    accum_steps: int = 1


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``; f32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    if isinstance(tensors, Mapping):
        tensors = tensors.values()
    return torch.sqrt(sum(x.float().square().sum() for x in tensors))


def adamw_init(params) -> Dict[str, object]:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in _named(params).items()}
    dev = next(iter(zeros.values())).device
    return {"mu": zeros,
            "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: Mapping[str, torch.Tensor],
                 state):
    """One optimizer step, in place. Gradients are expected pre-averaged
    over data-parallel ranks. Returns (params, state, metrics)."""
    named = _named(params)
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads[n] for n in named)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.float()
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for n, p in named.items():
        g = grads[n].float() * scale
        mu, nu = state["mu"][n], state["nu"][n]
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        decay = cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * (delta + decay)).to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
