"""The MoE family (granite-moe-3b-a800m and qwen3-moe-235b-a22b smoke
configs) of the port against the reference on the CPU, f32, with the
tolerances of ``tests/torch_families.py``.

- ``moe_ffn`` alone with the capacity forced low, so that at least half
  the routed slots drop: output, aux losses and every gradient.
- ``forward_train`` (loss, ``ce_loss``, ``moe_aux``, ``moe_z``, every
  gradient), one AdamW step, prefill and 3 decode steps with their
  caches; ``FAMILIES_SMOKE_LOSS`` recomputed.
- The port's teacher-forced decode against its full prefill, at capacity
  factor n_experts / top_k: a full prefill may drop the last token, which
  its decode (one token, capacity 8) never does, so the check needs a
  capacity at which neither drops.
- A granite checkpoint crosses the packages both ways.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as F
from repro.models import moe as JM
from repro_torch.models import moe as TM

ARCHES = ["granite_moe_3b_a800m", "qwen3_moe_235b_a22b"]


def test_moe_ffn_drops_tokens_like_the_reference():
    cfg_j, cfg_t = F.configs("granite_moe_3b_a800m")
    m = dataclasses.replace(cfg_j.moe, capacity_factor=0.25)
    cfg_j, cfg_t = cfg_j.replace(moe=m), cfg_t.replace(moe=m)
    b, t, d, e, f = 2, 64, cfg_j.d_model, m.n_experts, m.d_ff_expert
    cap = max(int(t * m.top_k * m.capacity_factor / e), 8)
    assert t * m.top_k >= 2 * e * cap          # half the slots drop
    rng = np.random.default_rng(0)
    w = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gate": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_up": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)

    def ref(p, xx):
        out, aux = JM.moe_ffn(p, xx, cfg_j)
        return jnp.sum(out * cot) + aux["moe_aux"] + aux["moe_z"], (out, aux)

    (_, (out_j, aux_j)), (gw_j, gx_j) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    wt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t, aux_t = TM.moe_ffn(types.SimpleNamespace(**wt), xt, cfg_t)
    total = (out_t * torch.from_numpy(cot)).sum() + aux_t["moe_aux"] + \
        aux_t["moe_z"]
    grads = torch.autograd.grad(total, [xt, *wt.values()])
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-5)
    for k in ("moe_aux", "moe_z"):
        np.testing.assert_allclose(float(aux_t[k].detach()), float(aux_j[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_j),
                               atol=1e-5, rtol=1e-4)
    for g, k in zip(grads[1:], wt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw_j[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    # dropped tokens: rows whose every slot dropped come out zero
    assert (np.abs(np.asarray(out_j)).sum(-1) == 0).any()


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_train_matches_reference(arch):
    _, met = F.check_train(arch)
    assert met["moe_aux"] > 0 and met["moe_z"] > 0


@pytest.mark.parametrize("arch", ARCHES)
def test_adamw_step_matches_reference(arch):
    F.check_adamw_step(arch)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_match_reference(arch):
    F.check_serve(arch)


def test_decode_matches_prefill_moe():
    cfg = F.configs("granite_moe_3b_a800m")[1]
    m = dataclasses.replace(cfg.moe,
                            capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    F.check_teacher_forced("granite_moe_3b_a800m", moe=m)


@pytest.mark.parametrize("arch", ARCHES)
def test_families_smoke_loss_is_the_references(arch):
    F.check_smoke_loss(arch)


def test_checkpoints_cross_the_packages(tmp_path):
    F.check_checkpoints_cross("granite_moe_3b_a800m", tmp_path)
