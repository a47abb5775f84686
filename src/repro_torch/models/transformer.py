"""Top-level model of the port: every family the reference composes, for
training and serving (the reference's ``models/transformer.py``).

  dense / vlm / audio : [RMSNorm -> GQA attn] + [RMSNorm -> SwiGLU]
  moe                 : [RMSNorm -> GQA attn] + [RMSNorm -> MoE FFN]
  ssm                 : [RMSNorm -> Mamba1]
  hybrid (zamba2)     : groups of ``hybrid_period`` Mamba2 blocks, each
                        followed by one *shared* attention+MLP block (one
                        parameter set reused per application, as in
                        Zamba), then the trailing Mamba2 blocks

A model is an ``LM`` module: ``embed``, ``blocks`` (an ``nn.ModuleList``
of ``DenseBlock`` — ``ln1``, ``attn``, ``ln2`` and ``mlp`` or ``moe`` —
or of ``SSMBlock`` — ``ln1``, ``mamba``), ``final_norm``, ``lm_head``
without tied embeddings and, for the hybrid family, ``shared`` (a
``DenseBlock``). Attribute names are the reference's parameter names and
weights keep its layout (``x @ w``, w is [in, out]), so ``convert.py``
carries the reference's parameter tree across unchanged. The layers run
one after another in Python (the reference's ``lax.scan`` over stacked
layers is a compile-time device PyTorch has no need for). The
``runtime.actctx.constrain`` hints sit where the reference's do (the
hidden state after the embedding and after each layer or hybrid group);
they redistribute DTensors under a bound role and are the identity on one
card. ``forward_train`` keeps ``cfg.remat``: each layer (each group
for the hybrid family) runs under ``torch.utils.checkpoint``
(non-reentrant), so the backward pass recomputes it instead of holding
its activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.types import resolve_device
from ..runtime.actctx import constrain
from .attention import attention_block
from .config import ArchConfig
from .layers import cross_entropy, init_dense, rms_norm, swiglu
from .moe import moe_ffn
from .ssm import dt_rank, mamba1_block, mamba2_block

ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")

# the weights init_params draws (Normal(0, 1/fan_in), the embedding
# Normal(0, 1/d_model)); every other parameter keeps the value its module
# was built with, as in the reference
_DRAWN = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate",
                    "w_up", "w_down", "router", "in_proj", "conv_w", "x_bc",
                    "dt_proj", "out_proj"})


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


class MoE(nn.Module):
    """The router (f32) and the experts' SwiGLU weights; ``moe_ffn``."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
        self.router = _weight((d, e), torch.float32, device)
        self.w_gate = _weight((e, d, f), dtype, device)
        self.w_up = _weight((e, d, f), dtype, device)
        self.w_down = _weight((e, f, d), dtype, device)


class Mamba1(nn.Module):
    """``ssm.mamba1_block``'s weights, with the reference's fixed inits:
    ``a_log`` log(1..N) per channel, ``dt_bias`` -4.6 (softplus^-1(0.01)),
    ``d_skip`` 1, ``conv_b`` 0."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        di, r = s.expand * d, dt_rank(cfg)
        self.in_proj = _weight((d, 2 * di), dtype, device)
        self.conv_w = _weight((s.conv_width, di), dtype, device)
        self.conv_b = _weight((di,), dtype, device, 0.0)
        self.x_bc = _weight((di, r + 2 * s.state), dtype, device)
        self.dt_proj = _weight((r, di), dtype, device)
        self.dt_bias = _weight((di,), dtype, device, -4.6)
        a = torch.log(torch.arange(1, s.state + 1, dtype=torch.float32,
                                   device=device))
        self.a_log = nn.Parameter(a.repeat(di, 1),          # [di, N]
                                  requires_grad=False)
        self.d_skip = _weight((di,), torch.float32, device, 1.0)
        self.out_proj = _weight((di, d), dtype, device)


class Mamba2(nn.Module):
    """``ssm.mamba2_block``'s weights, with the reference's fixed inits:
    ``a_log`` log(linspace(1, 16, heads)), ``dt_bias`` -4.6, ``d_skip``
    1, ``conv_b`` 0, ``norm_scale`` 1."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        s, d = cfg.ssm, cfg.d_model
        di = s.expand * d
        nh = di // s.head_dim
        self.in_proj = _weight((d, 2 * di + 2 * s.state + nh), dtype, device)
        self.conv_w = _weight((s.conv_width, di + 2 * s.state), dtype,
                              device)
        self.conv_b = _weight((di + 2 * s.state,), dtype, device, 0.0)
        self.a_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, nh, dtype=torch.float32, device=device)),
            requires_grad=False)
        self.dt_bias = _weight((nh,), torch.float32, device, -4.6)
        self.d_skip = _weight((nh,), torch.float32, device, 1.0)
        self.norm_scale = _weight((di,), dtype, device, 1.0)
        self.out_proj = _weight((di, d), dtype, device)


def _norm(h, scale, cfg: ArchConfig):
    """RMSNorm of a sub-layer's input, then the ``layer_in`` layout (a
    sequence-parallel hidden state is gathered over the sequence before
    the projections: DTensor will not flatten a sharded sequence into a
    matmul's rows); a sub-layer's output goes back through
    ``layer_out``."""
    return constrain(rms_norm(h, scale, cfg.norm_eps), "layer_in")


class DenseBlock(nn.Module):
    """[RMSNorm -> GQA attn] + [RMSNorm -> SwiGLU, or the MoE FFN for the
    moe family]."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device, 1.0)
        self.attn = Attention(cfg, dtype, device)
        self.ln2 = _weight((cfg.d_model,), dtype, device, 1.0)
        if cfg.family == "moe":
            self.moe = MoE(cfg, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)

    def forward(self, h, cfg: ArchConfig, positions, kv=None, cache_len=None,
                decode=False):
        """-> (h, new_kv, aux): ``aux`` holds the MoE losses, or is
        empty."""
        x, new_kv = attention_block(
            self.attn, _norm(h, self.ln1, cfg), cfg,
            positions=positions, kv_cache=kv, cache_len=cache_len,
            decode=decode)
        h = h + constrain(x, "layer_out")
        hn = _norm(h, self.ln2, cfg)
        if hasattr(self, "moe"):
            x, aux = moe_ffn(self.moe, hn, cfg)
        else:
            x, aux = self.mlp(hn), {}
        return h + constrain(x, "layer_out"), new_kv, aux


class SSMBlock(nn.Module):
    """[RMSNorm -> Mamba1] (ssm) or [RMSNorm -> Mamba2] (hybrid)."""

    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = _weight((cfg.d_model,), dtype, device, 1.0)
        self.mamba = (Mamba1 if cfg.ssm.version == 1 else Mamba2)(
            cfg, dtype, device)

    def forward(self, h, cfg: ArchConfig, state=None, decode=False):
        fn = mamba1_block if cfg.ssm.version == 1 else mamba2_block
        x, new_state = fn(self.mamba, _norm(h, self.ln1, cfg),
                          cfg, state=state, decode=decode)
        return h + constrain(x, "layer_out"), new_state


class LM(nn.Module):
    """A model of ``cfg``'s family with unset weights (norm scales 1,
    biases 0, the SSM blocks' fixed inits); ``init_params`` draws them,
    ``convert`` copies them in."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        block = SSMBlock if cfg.family in ("ssm", "hybrid") else DenseBlock
        self.embed = _weight((cfg.vocab, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(block(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight((cfg.d_model,), dtype, device, 1.0)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab), dtype, device)
        if cfg.family == "hybrid":
            self.shared = DenseBlock(cfg.replace(family="dense"), dtype,
                                     device)

    def head(self, cfg: ArchConfig):
        return self.embed.T if cfg.tie_embeddings else self.lm_head


@torch.no_grad()
def init_params(cfg: ArchConfig, *, seed: int = 0, dtype=torch.float32,
                device="cuda") -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``:
    each matrix Normal(0, 1/fan_in), the embedding Normal(0, 1/d_model)
    (keeps tied-head logits O(1) at init), norm scales 1, biases 0, the
    SSM blocks' fixed inits — the reference's distribution, not its
    draws. On ``device="meta"`` the model comes back with no draw: its
    shapes and dtypes alone, the port's ``jax.eval_shape(init_params)``."""
    model = LM(cfg, dtype=dtype, device=device)
    dev = model.embed.device
    if dev.type == "meta":
        return model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _DRAWN:
            scale = cfg.d_model ** -0.5 if leaf == "embed" else None
            w.copy_(init_dense(tuple(w.shape), generator=gen, scale=scale,
                               dtype=w.dtype, device=dev))
    return model


def n_groups(cfg: ArchConfig) -> int:
    """Hybrid: number of shared-attention applications."""
    return max(1, cfg.n_layers // max(cfg.hybrid_period, 1))


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> dict:
    """Decode caches: KV [L, B, max_seq, KH, D] for the attention
    families (int8 with per-(token, KV head) fp16 scales under
    ``cfg.kv_quant``); conv and SSM states for the SSM layers, and KV per
    shared-attention group for the hybrid family."""
    dev = resolve_device(device)
    kh, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.family in ATTN_FAMILIES:
        if cfg.kv_quant:
            return {"k": zeros(n, batch, max_seq, kh, hd, dt=torch.int8),
                    "v": zeros(n, batch, max_seq, kh, hd, dt=torch.int8),
                    "k_scale": zeros(n, batch, max_seq, kh,
                                     dt=torch.float16),
                    "v_scale": zeros(n, batch, max_seq, kh,
                                     dt=torch.float16)}
        return {"k": zeros(n, batch, max_seq, kh, hd),
                "v": zeros(n, batch, max_seq, kh, hd)}
    s = cfg.ssm
    di = s.expand * cfg.d_model
    if cfg.family == "ssm":
        return {"conv": zeros(n, batch, s.conv_width - 1, di),
                "ssm": zeros(n, batch, di, s.state, dt=torch.float32)}
    nh, g = di // s.head_dim, n_groups(cfg)
    return {"conv": zeros(n, batch, s.conv_width - 1, di + 2 * s.state),
            "ssm": zeros(n, batch, nh, s.head_dim, s.state,
                         dt=torch.float32),
            "k": zeros(g, batch, max_seq, kh, hd),
            "v": zeros(g, batch, max_seq, kh, hd)}


def _stack(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _attn_families_step(params: LM, cfg, h, positions, cache, cache_len,
                        decode):
    outs = []
    for i, blk in enumerate(params.blocks):
        h, kv, _ = blk(h, cfg, positions, kv={k: c[i] for k, c in
                                              cache.items()},
                       cache_len=cache_len, decode=decode)
        outs.append(kv)
    return h, _stack(outs)


def _ssm_families_step(params: LM, cfg, h, cache, decode):
    outs = []
    for i, blk in enumerate(params.blocks):
        h, st = blk(h, cfg, state={"conv": cache["conv"][i],
                                   "ssm": cache["ssm"][i]}, decode=decode)
        outs.append(st)
    return h, _stack(outs)


def _hybrid_step(params: LM, cfg, h, positions, cache, cache_len, decode):
    """The Mamba2 blocks in order, the shared block (with group g's KV
    cache) after the last block of each full group g of
    ``hybrid_period``; the trailing blocks have none."""
    period = max(cfg.hybrid_period, 1)
    states, kvs = [], []
    for i, blk in enumerate(params.blocks):
        h, st = blk(h, cfg, state={"conv": cache["conv"][i],
                                   "ssm": cache["ssm"][i]}, decode=decode)
        states.append(st)
        g = i // period
        if (i + 1) % period == 0 and g < n_groups(cfg):
            h, kv, _ = params.shared(h, cfg, positions,
                                     kv={"k": cache["k"][g],
                                         "v": cache["v"][g]},
                                     cache_len=cache_len, decode=decode)
            kvs.append(kv)
    return h, {**_stack(states), **_stack(kvs)}


@torch.no_grad()
def forward_serve(params: LM, cfg: ArchConfig, batch, cache, cache_len, *,
                  decode: bool):
    """Prefill (decode=False) or single-token decode (decode=True).

    ``batch`` holds int ``tokens`` [B, T] (and ``patch_embeds`` [B, P, D]
    at a vision-stub prefill), or ``frame_embeds`` [B, T, D] for the
    audio stub; ``cache`` from ``init_cache``; ``cache_len`` int [B].
    Returns (logits of the last position [B, V], new_cache)."""
    if cfg.modality == "audio_stub":
        h = batch["frame_embeds"]
    elif cfg.modality == "vision_stub" and not decode:
        tok = constrain(params.embed[batch["tokens"]], "embed")
        h = torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    else:
        h = params.embed[batch["tokens"]]
    if decode:
        positions = cache_len[:, None]
    else:
        positions = torch.arange(h.shape[1], device=h.device)[None, :]

    if cfg.family in ATTN_FAMILIES:
        h, new_cache = _attn_families_step(params, cfg, h, positions, cache,
                                           cache_len, decode)
    elif cfg.family == "ssm":
        h, new_cache = _ssm_families_step(params, cfg, h, cache, decode)
    else:
        h, new_cache = _hybrid_step(params, cfg, h, positions, cache,
                                    cache_len, decode)
    h = rms_norm(constrain(h, "layer_in")[:, -1:], params.final_norm,
                 cfg.norm_eps)
    return (h @ params.head(cfg))[:, 0], new_cache


def _embed_input(params: LM, cfg: ArchConfig, batch):
    """Returns (h [B,S,D], targets [B,S], loss_mask [B,S]). Audio takes
    its frame embeddings as they are; vision puts the patch embeddings
    before the tokens' and masks the loss over them. ``F.embedding``
    rather than indexing: its backward on CUDA sums the rows of repeated
    tokens in a fixed order."""
    tgt = batch["targets"]
    if cfg.modality == "audio_stub":
        h = batch["frame_embeds"]
        return h, tgt, torch.ones(tgt.shape, dtype=torch.bool,
                                  device=h.device)
    h = F.embedding(batch["tokens"], params.embed)
    if cfg.modality == "vision_stub":
        h = constrain(h, "embed")
        patches = batch["patch_embeds"]
        h = torch.cat([patches.to(h.dtype), h], dim=1)
        pos = torch.arange(tgt.shape[1], device=h.device)
        return h, tgt, (pos >= patches.shape[1])[None, :].expand(
            tgt.shape)
    return h, tgt, torch.ones(tgt.shape, dtype=torch.bool, device=h.device)


def _remat(cfg: ArchConfig, fn, *args):
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _backbone_train(params: LM, cfg: ArchConfig, h, positions):
    """Run all blocks (training path, no caches). Returns (h, moe_aux,
    moe_z), the MoE losses summed over the layers."""
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux, z = zero, zero
    if cfg.family in ATTN_FAMILIES:
        def layer(blk, x):
            x, _, a = blk(x, cfg, positions)
            return (constrain(x, "hidden"), a.get("moe_aux", zero),
                    a.get("moe_z", zero))

        for blk in params.blocks:
            h, a, b = _remat(cfg, layer, blk, h)
            aux, z = aux + a, z + b
        return h, aux, z

    if cfg.family == "ssm":
        for blk in params.blocks:
            h = _remat(cfg, lambda b, x: constrain(b(x, cfg)[0], "hidden"),
                       blk, h)
        return h, aux, z

    # hybrid: groups of Mamba2 blocks, each followed by the shared block
    period = max(cfg.hybrid_period, 1)
    used = n_groups(cfg) * period

    def group(g, x):
        for blk in params.blocks[g * period:(g + 1) * period]:
            x = blk(x, cfg)[0]
        return constrain(params.shared(x, cfg, positions)[0], "hidden")

    for g in range(n_groups(cfg)):
        h = _remat(cfg, group, g, h)
    for blk in params.blocks[used:]:          # trailing blocks
        h = blk(h, cfg)[0]
    return h, aux, z


def _chunked_loss(params: LM, cfg: ArchConfig, h, targets, mask):
    """CE computed over sequence chunks to bound the [.., V] logit tile."""
    s = h.shape[1]
    c = min(cfg.loss_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {c}")
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        ls = cross_entropy(constrain(h[:, sl] @ params.head(cfg),
                                     "logits"), targets[:, sl])
        ms = mask[:, sl].float()
        tot = tot + (ls * ms).sum()
        cnt = cnt + ms.sum()
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params: LM, cfg: ArchConfig, batch):
    """Training forward: returns (loss, metrics). ``batch`` is
    ``data.synthetic.make_train_batch``'s: int ``targets`` [B, S] and
    ``tokens`` (plus ``patch_embeds`` for the vision stub) or
    ``frame_embeds`` (audio stub). The loss is the CE plus 0.01 x the
    MoE balance loss plus 1e-3 x its z-loss, summed over the layers;
    gradients flow to every parameter that requires them."""
    h, targets, mask = _embed_input(params, cfg, batch)
    h = constrain(h, "hidden")
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    h, moe_aux, moe_z = _backbone_train(params, cfg, h, positions)
    h = _norm(h, params.final_norm, cfg)
    loss = _chunked_loss(params, cfg, h, targets, mask)
    total = loss + 0.01 * moe_aux + 1e-3 * moe_z
    return total, {"ce_loss": loss, "moe_aux": moe_aux, "moe_z": moe_z}
