"""Top-level model of the port: the dense family, training and serving.

    dense : [RMSNorm -> GQA attn] + [RMSNorm -> SwiGLU], per layer

A model is a ``DenseLM`` module: ``embed``, ``blocks`` (an
``nn.ModuleList`` of ``DenseBlock``: ``ln1``, ``attn``, ``ln2``, ``mlp``),
``final_norm`` and, without tied embeddings, ``lm_head``. Weights keep the
reference's layout (``x @ w``, w is [in, out]), so ``convert.py`` carries
the reference's parameter tree across unchanged. The layers run one after
another in Python (the reference's ``lax.scan`` over stacked layers is a
compile-time device PyTorch has no need for), and the reference's
``runtime.actctx.constrain`` sharding hint is the identity on one card.
``forward_train`` keeps ``cfg.remat``: each layer runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward pass
recomputes the layer instead of holding its activations.

The families ``moe``, ``ssm`` and ``hybrid`` and the non-text modalities
come with later slices of the port and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from .attention import attention_block
from .config import ArchConfig
from .layers import cross_entropy, init_dense, rms_norm, swiglu

LATER = "a later slice of the port (ROADMAP Queue 1 item 14)"


def check_supported(cfg: ArchConfig) -> None:
    """Raise unless the port runs ``cfg``: the dense, text-only family."""
    if cfg.family != "dense" or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / modality "
            f"{cfg.modality!r} comes with {LATER}; this slice runs the "
            f"dense text family")
    if cfg.kv_quant:
        raise NotImplementedError(f"the int8 KV cache comes with {LATER}")


def _weight(shape, dtype, device, fill=None) -> nn.Parameter:
    t = (torch.empty(shape, dtype=dtype, device=device) if fill is None
         else torch.full(shape, fill, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        hd, h, kh, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
        self.wq = _weight((d, h * hd), dtype, device)
        self.wk = _weight((d, kh * hd), dtype, device)
        self.wv = _weight((d, kh * hd), dtype, device)
        self.wo = _weight((h * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _weight((h * hd,), dtype, device, 0.0)
            self.bk = _weight((kh * hd,), dtype, device, 0.0)
            self.bv = _weight((kh * hd,), dtype, device, 0.0)


class MLP(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _weight((d, f), dtype, device)
        self.w_up = _weight((d, f), dtype, device)
        self.w_down = _weight((f, d), dtype, device)

    def forward(self, x):
        return swiglu(x, self.w_gate, self.w_up, self.w_down)


class DenseBlock(nn.Module):
    """[RMSNorm -> GQA attn] + [RMSNorm -> SwiGLU]."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device, 1.0)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _weight((cfg.d_model,), dtype, device, 1.0)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, h, cfg: ArchConfig, positions, kv=None, cache_len=None,
                decode=False):
        x, new_kv = attention_block(
            self.attn, rms_norm(h, self.ln1, cfg.norm_eps), cfg,
            positions=positions, kv_cache=kv, cache_len=cache_len,
            decode=decode)
        h = h + x
        return h + self.mlp(rms_norm(h, self.ln2, cfg.norm_eps)), new_kv


class DenseLM(nn.Module):
    """A dense decoder with uninitialized weights (norm scales 1, biases
    0); ``init_params`` draws them, ``convert`` copies them in."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.embed = _weight((cfg.vocab, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight((cfg.d_model,), dtype, device, 1.0)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab), dtype, device)

    def head(self, cfg: ArchConfig):
        return self.embed.T if cfg.tie_embeddings else self.lm_head


@torch.no_grad()
def init_params(cfg: ArchConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> DenseLM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``:
    each matrix Normal(0, 1/fan_in), the embedding Normal(0, 1/d_model)
    (keeps tied-head logits O(1) at init), norm scales 1, biases 0 — the
    reference's distribution, not its draws."""
    model = DenseLM(cfg, dtype=dtype, device=device)
    dev = model.embed.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(w, scale=None):
        w.copy_(init_dense(tuple(w.shape), generator=gen, scale=scale,
                           dtype=dtype, device=dev))

    draw(model.embed, scale=cfg.d_model ** -0.5)
    for blk in model.blocks:
        for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo,
                  blk.mlp.w_gate, blk.mlp.w_up, blk.mlp.w_down):
            draw(w)
    if not cfg.tie_embeddings:
        draw(model.lm_head)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> dict:
    """Contiguous decode caches: k/v [L, B, max_seq, KH, D] zeros."""
    check_supported(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@torch.no_grad()
def forward_serve(params: DenseLM, cfg: ArchConfig, batch, cache,
                  cache_len, *, decode: bool):
    """Prefill (decode=False) or single-token decode (decode=True).

    ``batch["tokens"]`` [B, T]; ``cache`` from ``init_cache``;
    ``cache_len`` int [B]. Returns (logits of the last position [B, V],
    new_cache)."""
    h = params.embed[batch["tokens"]]
    t = h.shape[1]
    if decode:
        positions = cache_len[:, None]
    else:
        positions = torch.arange(t, device=h.device)[None, :]
    ks, vs = [], []
    for i, blk in enumerate(params.blocks):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}
        h, new_kv = blk(h, cfg, positions, kv=kv, cache_len=cache_len,
                        decode=decode)
        ks.append(new_kv["k"])
        vs.append(new_kv["v"])
    h = rms_norm(h[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (h @ params.head(cfg))[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _embed_input(params: DenseLM, cfg: ArchConfig, batch):
    """Returns (h [B,S,D], targets [B,S], loss_mask [B,S]) — the text
    branch. ``F.embedding`` rather than indexing: its backward on CUDA
    sums the rows of repeated tokens in a fixed order."""
    h = F.embedding(batch["tokens"], params.embed)
    tgt = batch["targets"]
    return h, tgt, torch.ones(tgt.shape, dtype=torch.bool, device=h.device)


def _backbone_train(params: DenseLM, cfg: ArchConfig, h, positions):
    """Run all blocks (training path, no caches)."""
    for blk in params.blocks:
        if cfg.remat:
            h = checkpoint(lambda x, b=blk: b(x, cfg, positions)[0], h,
                           use_reentrant=False)
        else:
            h = blk(h, cfg, positions)[0]
    return h


def _chunked_loss(params: DenseLM, cfg: ArchConfig, h, targets, mask):
    """CE computed over sequence chunks to bound the [.., V] logit tile."""
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        ls = cross_entropy(h[:, sl] @ params.head(cfg), targets[:, sl])
        ms = mask[:, sl].float()
        tot = tot + (ls * ms).sum()
        cnt = cnt + ms.sum()
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params: DenseLM, cfg: ArchConfig, batch):
    """Training forward: returns (loss, metrics). ``batch`` holds int
    ``tokens`` and ``targets`` [B, S]; gradients flow to every parameter
    that requires them."""
    check_supported(cfg)
    h, targets, mask = _embed_input(params, cfg, batch)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h = _backbone_train(params, cfg, h, positions)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    loss = _chunked_loss(params, cfg, h, targets, mask)
    # the dense family has no MoE auxiliary losses; the keys stay the
    # reference's
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    return loss, {"ce_loss": loss, "moe_aux": zero, "moe_z": zero}
