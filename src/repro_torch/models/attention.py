"""GQA attention for serving: causal prefill and cached single-token
decode (the reference's ``models/attention.py``).

These stay plain PyTorch: the reference computes them outside any Pallas
kernel. The paged decode path (``serving/paged.py``) calls the
``paged_attention`` kernel instead of ``decode_attention``. A cache that
holds ``k_scale``/``v_scale`` is the int8 KV cache (``cfg.kv_quant``):
codes with per-(token, KV head) fp16 scales, written quantized and read
back dequantized.
"""
from __future__ import annotations

import torch

from ..runtime.actctx import constrain
from .layers import apply_rope

NEG_INF = -1e30


def gqa_scores_ein(q, k):
    """q: [B, T, KH, G, D], k: [B, S, KH, D] -> [B, KH, G, T, S] in f32."""
    return torch.einsum("btkgd,bskd->bkgts", q.float(), k.float())


def causal_attention(q, k, v, q_offset: int = 0, q_chunk: int = 512):
    """Causal GQA attention. q: [B, T, H, D]; k/v: [B, S, KH, D];
    positions of q are q_offset + [0..T). Returns [B, T, H, D].

    Queries go in chunks of ``q_chunk``; the last chunk may be shorter
    (the reference requires T % q_chunk == 0 and cannot prefill a prompt
    longer than ``q_chunk`` that is not a multiple of it — ROADMAP
    Queue 3)."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, t, kh, g, d)
    scale = d ** -0.5
    kpos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, t, q_chunk):
        qc = qg[:, start:start + q_chunk]
        cq = qc.shape[1]
        scores = gqa_scores_ein(qc, k) * scale              # [B,KH,G,Cq,S]
        qpos = q_offset + start + torch.arange(cq, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]               # [Cq, S]
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        w = torch.softmax(scores, dim=-1)
        oc = torch.einsum("bkgts,bskd->btkgd", w.to(v.dtype), v)
        outs.append(oc.reshape(b, cq, h, d))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q [B, 1, H, D]; caches [B, S, KH, D]."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, 1, kh, g, d)
    scores = gqa_scores_ein(qg, k_cache) * (d ** -0.5)    # [B,KH,G,1,S]
    pos = torch.arange(s, device=q.device)
    valid = pos[None] < cache_len[:, None]                 # [B, S]
    scores = torch.where(valid[:, None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


def _quant_kv(x):
    """int8-quantize [B,T,KH,D] with per-(token, head) scales; rounds half
    to even, as the reference."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequant_kv(q, scale, dtype):
    return (q.float() * scale.float()[..., None]).to(dtype)


def qkv_proj(params, x, cfg, positions):
    """The q/k/v projections with bias and RoPE: x [B, T, d_model] ->
    q [B, T, H, D], k and v [B, T, KH, D]. ``params`` has
    ``wq``/``wk``/``wv`` (and ``bq``/``bk``/``bv`` with ``cfg.qkv_bias``)
    as attributes (``models.transformer.Attention``)."""
    b, t, _ = x.shape
    hd, h, kh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = x @ params.wq
    k = x @ params.wk
    v = x @ params.wv
    if cfg.qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    # DTensor cannot view uneven head shards as heads, nor flatten the
    # batch with a sharded head dim in the einsums below: on a mesh this
    # role moves the model sharding off the heads first
    q, k, v = (constrain(q, "attn_heads"), constrain(k, "attn_heads"),
               constrain(v, "attn_heads"))
    q = apply_rope(q.reshape(b, t, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, t, kh, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, t, kh, hd)


def attention_block(params, x, cfg, *, positions, kv_cache=None,
                    cache_len=None, decode=False):
    """Full attention sub-layer: qkv proj + rope + attn + out proj.

    ``params`` as for ``qkv_proj``, plus ``wo``. ``kv_cache`` is None or
    dict(k=[B,S,KH,D], v=[B,S,KH,D]) in f32 or bf16, plus int8 codes'
    ``k_scale``/``v_scale`` [B,S,KH] for the int8 cache; the caches are
    written out of place, as the reference does. Returns
    (out, new_kv_cache).
    """
    b, t, _ = x.shape
    q, k, v = qkv_proj(params, x, cfg, positions)

    if kv_cache is None:
        out, new_cache = causal_attention(q, k, v,
                                          q_chunk=cfg.attn_q_chunk), None
    else:
        new = {"k": k, "v": v}
        if "k_scale" in kv_cache:
            new["k"], new["k_scale"] = _quant_kv(k)
            new["v"], new["v_scale"] = _quant_kv(v)
        if decode:
            # insert the new token at cache_len (per batch row), as the
            # reference's masked select
            pos = torch.arange(kv_cache["k"].shape[1], device=x.device)
            at = pos[None, :] == cache_len[:, None]             # [B, S]
            new_cache = {
                n: torch.where(at.reshape(at.shape + (1,) * (c.dim() - 2)),
                               new[n].to(c.dtype), c)
                for n, c in kv_cache.items()}
            if "k_scale" in kv_cache:
                kf = _dequant_kv(new_cache["k"], new_cache["k_scale"],
                                 x.dtype)
                vf = _dequant_kv(new_cache["v"], new_cache["v_scale"],
                                 x.dtype)
            else:
                kf, vf = new_cache["k"], new_cache["v"]
            out = decode_attention(q, constrain(kf, "attn_heads"),
                                   constrain(vf, "attn_heads"),
                                   cache_len + 1)
        else:  # prefill: write the whole prefix
            new_cache = {}
            for n, c in kv_cache.items():
                c = c.clone()
                c[:, :t] = new[n].to(c.dtype)
                new_cache[n] = c
            out = causal_attention(q, k, v, q_chunk=cfg.attn_q_chunk)

    out = constrain(out.reshape(b, t, -1), "attn_heads") @ params.wo
    return out, new_cache
