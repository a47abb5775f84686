"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(the reference's ``models/moe.py``).

Dispatch is per batch row: each row stably sorts its T·k routed slots by
expert and places them in an [B, E, C, D] buffer, C = max(int(T·k·cf/E),
8); a slot past its expert's capacity is dropped. The expert SwiGLU runs
as einsums over the per-expert weights, and the combine sums each token's
k weighted outputs.

Every scatter writes distinct rows, and the combine sums over k in a
fixed order, so the forward and backward passes are free of
floating-point atomics (the reference *adds* a dropped slot's zero row
into slot E·C-1; here dropped slots go to a spare row E·C that is cut
off, and read their zero output from it). The sharding hints
(``constrain``: ``moe_predispatch`` then ``moe_dispatch`` on the dispatch
buffer, the reverse on the experts' output) sit where the reference's do
and are the identity on one card.

Aux losses: load balancing (Switch) and the router z-loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.actctx import constrain, local_rows


def _take(x, idx):
    """``x`` [B, N, D] at rows ``idx`` [B, M] -> [B, M, D]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _put(rows, idx, n):
    """An [B, n, D] buffer of zeros with ``rows`` [B, M, D] at ``idx``
    [B, M] (distinct within a batch row but for spare ones)."""
    buf = rows.new_zeros((rows.shape[0], n, rows.shape[-1]))
    return buf.scatter(1, idx[..., None].expand(-1, -1, rows.shape[-1]),
                       rows)


def _route(flat_e, e: int, cap: int):
    """Each row's routed slots [B, T·k] stably sorted by expert: (order,
    slot in the [E·C (+1 spare)] buffer, kept)."""
    n = flat_e.shape[1]
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, torch.arange(
        e, device=flat_e.device).expand(flat_e.shape[0], e).contiguous())
    pos_in_e = torch.arange(n, device=flat_e.device)[None, :] - \
        torch.gather(first, 1, sorted_e)
    keep = pos_in_e < cap
    return order, torch.where(keep, sorted_e * cap + pos_in_e, e * cap), keep


def moe_ffn(params, x, cfg):
    """x: [B, T, D] -> (out [B, T, D], aux dict). ``params`` has
    ``router`` [D, E] (f32), ``w_gate``/``w_up`` [E, D, F] and ``w_down``
    [E, F, D] as attributes (``models.transformer.MoE``)."""
    m = cfg.moe
    b, t, d = x.shape
    e, k = m.n_experts, m.top_k

    logits = x.float() @ params.router                      # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)              # [B, T, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- aux losses (global)
    me = probs.mean(dim=(0, 1))                              # [E]
    ce = F.one_hot(top_e, e).float().sum(dim=2).mean(dim=(0, 1))
    aux_loss = e * (me * ce).sum() / k
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()

    # ---- capacity-bounded sort dispatch, per batch row
    cap = max(int(t * k * m.capacity_factor / e), 8)
    order, slot, keep = local_rows(
        lambda fe: _route(fe, e, cap), "moe_route",
        (top_e.reshape(b, t * k),))

    # slot j of the sorted order holds token order[j] // k: repeat each
    # token k times and permute (a gather without repeated rows)
    x_rep = x[:, :, None, :].expand(b, t, k, d).reshape(b, t * k, d)
    gathered = torch.where(keep[..., None], _take(x_rep, order), 0)
    dispatched = _put(gathered.to(x.dtype), slot, e * cap + 1)
    dispatched = dispatched[:, :e * cap].reshape(b, e, cap, d)
    dispatched = constrain(dispatched, "moe_predispatch")
    dispatched = constrain(dispatched, "moe_dispatch")

    # ---- expert FFN (einsum over per-expert weights)
    h = F.silu(torch.einsum("becd,edf->becf", dispatched, params.w_gate))
    h = h * torch.einsum("becd,edf->becf", dispatched, params.w_up)
    # (contiguous: an unevenly sharded DTensor's local views need it)
    out_e = torch.einsum("becf,efd->becd", h.contiguous(), params.w_down)
    out_e = constrain(out_e, "moe_dispatch")
    # back to data-only before the token-order combine gather
    out_e = constrain(out_e, "moe_predispatch")
    out_flat = torch.cat([out_e.reshape(b, e * cap, d),
                          out_e.new_zeros((b, 1, d))], dim=1)

    # ---- combine: weighted gather back to token order, summed over k
    back = _take(out_flat, slot)                             # [B, T*k, D]
    w = torch.gather(top_p.reshape(b, t * k), 1, order)
    back = back * torch.where(keep, w, 0.0)[..., None].to(x.dtype)
    out = _put(back, order, t * k).reshape(b, t, k, d).sum(dim=2)
    return out, {"moe_aux": aux_loss, "moe_z": z_loss}
