"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2/SSD
(zamba2), with chunked scans for training and an O(1) recurrent decode
step (the reference's ``models/ssm.py``).

The training scan goes one chunk of ``cfg.ssm_chunk`` steps at a time;
each chunk runs under ``torch.utils.checkpoint`` when gradients are on
(the reference's ``jax.checkpoint(outer)``), so the backward pass holds
one chunk's states, not the whole sequence's. Inside a chunk the
recurrence is a Python loop over the steps, a few small launches each
(``_mamba1_step`` / ``_mamba2_step``, which the decode step runs once):
``T`` steps per layer. On a mesh, everything between a block's two
projections runs on each rank's batch rows (``actctx.local_rows``):
DTensor has no sharding rules for the step loop. The blocks take their
weights as attributes of ``params`` (``models.transformer.Mamba1`` /
``Mamba2``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..runtime.actctx import local_rows


def dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or int(math.ceil(cfg.d_model / 16))


def _causal_conv(x, w, b, conv_state=None):
    """x: [B, T, C]; w: [W, C] depthwise. Returns (y, new_state[W-1])."""
    width = w.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(width))
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return y + b, new_state


def _chunked(step, h0, xs, chunk: int):
    """Run ``step(h, *xs_t) -> (h, y_t)`` over the time axis (1) of every
    tensor in ``xs``, ``chunk`` steps at a time. Returns (y stacked on
    axis 1, h after the last step)."""
    t = xs[0].shape[1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"sequence {t} is not a multiple of ssm_chunk "
                         f"{chunk}")

    def run(h, *xc):
        ys = []
        for i in range(xc[0].shape[1]):
            h, y = step(h, *(z[:, i] for z in xc))
            ys.append(y)
        return h, torch.stack(ys, dim=1)

    h, ys = h0, []
    for s in range(0, t, chunk):
        xc = [z[:, s:s + chunk] for z in xs]
        if torch.is_grad_enabled():
            h, y = checkpoint(run, h, *xc, use_reentrant=False)
        else:
            h, y = run(h, *xc)
        ys.append(y)
    return torch.cat(ys, dim=1), h


# ------------------------------------------------------------------ Mamba1

def _mamba1_step(a, h, dt_t, b_t, c_t, x_t):
    """One step of the Mamba1 recurrence: h [B,C,N]; dt_t, x_t [B,C];
    b_t, c_t [B,N]. Returns (h, y [B,C])."""
    da = torch.exp(dt_t[..., None] * a)                     # [B,C,N]
    h = h * da + (dt_t * x_t)[..., None] * b_t[:, None, :]
    return h, (h @ c_t[..., None])[..., 0]


def mamba1_scan(dt, a_log, bmat, cmat, x, h0, chunk: int):
    """Selective scan.

    dt: [B,T,C] (softplus'd), bmat/cmat: [B,T,N], x: [B,T,C], h0: [B,C,N].
    Returns (y [B,T,C], hT).
    """
    a = -torch.exp(a_log)                                   # [C, N]
    return _chunked(lambda h, *xs: _mamba1_step(a, h, *xs), h0,
                    (dt, bmat, cmat, x), chunk)


def _mamba1_mix(xz, conv_state, h0, conv_w, conv_b, x_bc, dt_proj,
                dt_bias, a_log, d_skip, *, cfg, decode):
    """Mamba1 between its two projections: xz [B, T, 2·di] -> (gated y
    [B, T, di], new conv state, new SSM state)."""
    s = cfg.ssm
    b = xz.shape[0]
    di = s.expand * cfg.d_model
    r = dt_rank(cfg)

    xs, z = torch.chunk(xz, 2, dim=-1)                      # [B,T,di]
    xs, new_conv = _causal_conv(xs, conv_w, conv_b, conv_state)
    xs = F.silu(xs)

    dt_in, bmat, cmat = torch.split(xs @ x_bc, [r, s.state, s.state],
                                    dim=-1)
    dt = F.softplus(dt_in @ dt_proj + dt_bias).float()
    bmat, cmat, xf = bmat.float(), cmat.float(), xs.float()

    if h0 is None:
        h0 = xz.new_zeros((b, di, s.state), dtype=torch.float32)
    if decode:
        h_t, y = _mamba1_step(-torch.exp(a_log), h0, dt[:, 0],
                              bmat[:, 0], cmat[:, 0], xf[:, 0])
        y = y[:, None]
    else:
        y, h_t = mamba1_scan(dt, a_log, bmat, cmat, xf, h0, cfg.ssm_chunk)
    y = y + d_skip * xf
    return y.to(xz.dtype) * F.silu(z), new_conv, h_t


def _states(state):
    return (None, None) if state is None else (state["conv"], state["ssm"])


def mamba1_block(params, x, cfg, *, state=None, decode=False):
    """x: [B, T, D]. state: dict(conv, ssm) or None. -> (out, new_state).
    The mixer runs row by row on a mesh (``actctx.local_rows``, role
    ``ssm_scan``): DTensor has no sharding rules for its step loop."""
    p = params
    y, new_conv, h_t = local_rows(
        functools.partial(_mamba1_mix, cfg=cfg, decode=decode), "ssm_scan",
        (x @ p.in_proj, *_states(state)),
        (p.conv_w, p.conv_b, p.x_bc, p.dt_proj, p.dt_bias, p.a_log,
         p.d_skip))
    return y @ p.out_proj, {"conv": new_conv, "ssm": h_t}


# ------------------------------------------------------------- Mamba2 / SSD

def _mamba2_step(a, h, dt_t, b_t, c_t, x_t):
    """One step of the SSD recurrence: h [B,H,P,N]; dt_t [B,H]; b_t, c_t
    [B,N]; x_t [B,H,P]. Returns (h, y [B,H,P])."""
    da = torch.exp(dt_t * a)[..., None, None]               # [B,H,1,1]
    upd = (x_t * dt_t[..., None])[..., None] * b_t[:, None, None, :]
    h = h * da + upd
    return h, (h @ c_t[:, None, :, None])[..., 0]


def mamba2_scan(dt, a_log, bmat, cmat, x, h0, chunk: int):
    """SSD recurrence with scalar-per-head decay.

    dt: [B,T,H] softplus'd; bmat/cmat: [B,T,N]; x: [B,T,H,P]; h0: [B,H,P,N].
    """
    a = -torch.exp(a_log)                                   # [H]
    return _chunked(lambda h, *xs: _mamba2_step(a, h, *xs), h0,
                    (dt, bmat, cmat, x), chunk)


def _mamba2_mix(zxd, conv_state, h0, conv_w, conv_b, dt_bias, a_log,
                d_skip, norm_scale, *, cfg, decode):
    """Mamba2 between its two projections: zxd [B, T, 2·di + 2N + H] ->
    (gated, normed y [B, T, di], new conv state, new SSM state)."""
    s = cfg.ssm
    b, t, _ = zxd.shape
    di = s.expand * cfg.d_model
    nh = di // s.head_dim

    z, xbc, dt_in = torch.split(zxd, [di, di + 2 * s.state, nh], dim=-1)
    xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, conv_state)
    xs, bmat, cmat = torch.split(F.silu(xbc), [di, s.state, s.state],
                                 dim=-1)
    dt = F.softplus(dt_in.float() + dt_bias)
    xh = xs.reshape(b, t, nh, s.head_dim).float()
    bmat, cmat = bmat.float(), cmat.float()

    if h0 is None:
        h0 = zxd.new_zeros((b, nh, s.head_dim, s.state),
                           dtype=torch.float32)
    if decode:
        h_t, y = _mamba2_step(-torch.exp(a_log), h0, dt[:, 0],
                              bmat[:, 0], cmat[:, 0], xh[:, 0])
        y = y[:, None]
    else:
        y, h_t = mamba2_scan(dt, a_log, bmat, cmat, xh, h0, cfg.ssm_chunk)
    y = y + d_skip[:, None] * xh
    y = y.reshape(b, t, di).to(zxd.dtype)
    # gated RMSNorm (Mamba2)
    y = (y * F.silu(z)).float()
    y = (y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-6)
         ).to(zxd.dtype) * norm_scale
    return y, new_conv, h_t


def mamba2_block(params, x, cfg, *, state=None, decode=False):
    """As ``mamba1_block``, for the Mamba2 (SSD) mixer."""
    p = params
    y, new_conv, h_t = local_rows(
        functools.partial(_mamba2_mix, cfg=cfg, decode=decode), "ssm_scan",
        (x @ p.in_proj, *_states(state)),
        (p.conv_w, p.conv_b, p.dt_bias, p.a_log, p.d_skip, p.norm_scale))
    return y @ p.out_proj, {"conv": new_conv, "ssm": h_t}
