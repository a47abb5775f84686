"""The SSM family (falcon-mamba-7b's smoke config, Mamba1) and the scans
of ``models/ssm.py`` (Mamba1 and Mamba2) of the port against the
reference on the CPU, f32, with the tolerances of
``tests/torch_families.py``.

- ``_causal_conv`` with and without a carried state: bitwise-close
  outputs and the new state.
- ``mamba1_scan`` and ``mamba2_scan`` alone over three chunks from a
  nonzero ``h0``: outputs and final state within 1e-5, and every
  gradient (through the port's per-chunk ``torch.utils.checkpoint``)
  within atol 1e-5 / rtol 1e-4; a sequence off the chunk raises
  ``ValueError`` (the reference asserts).
- ``forward_train``, one AdamW step, prefill and 3 decode steps with the
  conv and SSM caches; the port's teacher-forced decode against its full
  prefill (the reference's ``test_decode_matches_prefill_ssm``);
  ``FAMILIES_SMOKE_LOSS`` recomputed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families as F
from repro.models import ssm as JS
from repro_torch.models import ssm as TS

ARCH = "falcon_mamba_7b"


def test_causal_conv_with_and_without_state():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        yj, sj = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), None if state is None
                                 else jnp.asarray(state))
        yt, s_t = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(b), None if state is None
                                  else torch.from_numpy(state))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-6)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))


def _scan_inputs(version, rng, b=2, t=48):
    c, n = 12, 4
    if version == 1:
        x_shape, h_shape, a_shape = (b, t, c), (b, c, n), (c, n)
        dt_shape = (b, t, c)
    else:
        h, p = 3, 4
        x_shape, h_shape, a_shape = (b, t, h, p), (b, h, p, n), (h,)
        dt_shape = (b, t, h)
    f = np.float32
    return dict(dt=np.log1p(np.exp(rng.standard_normal(dt_shape))).astype(f),
                a_log=(0.5 * rng.standard_normal(a_shape)).astype(f),
                bmat=rng.standard_normal((b, t, n)).astype(f),
                cmat=rng.standard_normal((b, t, n)).astype(f),
                x=rng.standard_normal(x_shape).astype(f),
                h0=rng.standard_normal(h_shape).astype(f))


@pytest.mark.parametrize("version", [1, 2])
def test_scan_matches_reference_over_chunks(version):
    rng = np.random.default_rng(version)
    inp = _scan_inputs(version, rng)
    jfn = JS.mamba1_scan if version == 1 else JS.mamba2_scan
    tfn = TS.mamba1_scan if version == 1 else TS.mamba2_scan
    cot_y = rng.standard_normal(inp["x"].shape).astype(np.float32)
    cot_h = rng.standard_normal(inp["h0"].shape).astype(np.float32)

    def ref(*args):
        y, h = jfn(*args, 16)
        return jnp.sum(y * cot_y) + jnp.sum(h * cot_h), (y, h)

    (_, (yj, hj)), gj = jax.jit(jax.value_and_grad(
        ref, argnums=tuple(range(6)), has_aux=True))(
        *(jnp.asarray(v) for v in inp.values()))
    args = [torch.from_numpy(v).requires_grad_(True) for v in inp.values()]
    yt, ht = tfn(*args, 16)
    gt = torch.autograd.grad((yt * torch.from_numpy(cot_y)).sum()
                             + (ht * torch.from_numpy(cot_h)).sum(), args)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               atol=1e-5)
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj),
                               atol=1e-5)
    for name, a, b in zip(inp, gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4, err_msg=name)
    with pytest.raises(ValueError, match="ssm_chunk"):
        tfn(*(a.detach()[:, :40] if a.dim() > 2 and a.shape[1] == 48
              else a.detach() for a in args), 16)


def test_forward_train_matches_reference():
    F.check_train(ARCH)


def test_adamw_step_matches_reference():
    F.check_adamw_step(ARCH)


def test_prefill_and_decode_match_reference():
    F.check_serve(ARCH)


def test_decode_matches_prefill_ssm():
    F.check_teacher_forced(ARCH)


def test_families_smoke_loss_is_the_references():
    F.check_smoke_loss(ARCH)
