"""GQA attention for serving: causal prefill and cached single-token
decode (the reference's ``models/attention.py``).

These stay plain PyTorch: the reference computes them outside any Pallas
kernel. The paged decode path (``serving/paged.py``) calls the
``paged_attention`` kernel instead of ``decode_attention``. The int8 KV
cache (``kv_quant``) comes with a later slice of the port.
"""
from __future__ import annotations

import torch

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
    q = apply_rope(q.reshape(b, t, h, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(b, t, kh, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(b, t, kh, hd)


def attention_block(params, x, cfg, *, positions, kv_cache=None,
                    cache_len=None, decode=False):
    """Full attention sub-layer: qkv proj + rope + attn + out proj.

    ``params`` as for ``qkv_proj``, plus ``wo``. ``kv_cache`` is None or
    dict(k=[B,S,KH,D], v=[B,S,KH,D]) in f32 or bf16; the caches are
    written out of place, as the reference does. Returns
    (out, new_kv_cache).
    """
    if cfg.kv_quant:
        raise NotImplementedError(
            "attention_block: the int8 KV cache (kv_quant) comes with a "
            "later slice of the port")
    b, t, _ = x.shape
    q, k, v = qkv_proj(params, x, cfg, positions)

    if kv_cache is not None:
        if decode:
            # insert the new token at cache_len (per batch row), as the
            # reference's masked select
            pos = torch.arange(kv_cache["k"].shape[1], device=x.device)
            at = (pos[None, :] == cache_len[:, None])[:, :, None, None]
            new_cache = {
                "k": torch.where(at, k.to(kv_cache["k"].dtype),
                                 kv_cache["k"]),
                "v": torch.where(at, v.to(kv_cache["v"].dtype),
                                 kv_cache["v"])}
            out = decode_attention(q, new_cache["k"], new_cache["v"],
                                   cache_len + 1)
        else:  # prefill: write the whole prefix
            new_cache = {}
            for name, new in (("k", k), ("v", v)):
                c = kv_cache[name].clone()
                c[:, :t] = new.to(c.dtype)
                new_cache[name] = c
            out = causal_attention(q, k, v, q_chunk=cfg.attn_q_chunk)
    else:
        out = causal_attention(q, k, v, q_chunk=cfg.attn_q_chunk)
        new_cache = None

    out = out.reshape(b, t, -1) @ params.wo
    return out, new_cache
