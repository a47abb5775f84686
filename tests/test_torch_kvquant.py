"""The int8 KV cache (``kv_quant``) of the port against the reference on
the CPU, and the dense family's teacher-forced decode.

- ``_quant_kv`` on 2**18 values over four decades of magnitude: int8
  codes equal on >= 99.99% of entries and never more than 1 apart (the
  packages may divide differently in the last bit), fp16 scales within
  rtol 1e-3; round half to even on exact halves; ``_dequant_kv``.
- Qwen2-0.5B's smoke config with ``kv_quant``: ``forward_train`` (the
  cache plays no part in it) and one AdamW step as for every family;
  prefill and 3 decode steps, logits within 1e-4 and the int8 cache and
  its scales as above.
- The port's teacher-forced decode against its full prefill: the f32
  cache within the reference's atol 2e-4 / rtol 1e-3
  (``test_decode_matches_prefill_dense``); the int8 cache within 5% of
  the largest logit, the bound the chip smoke's ``KV_QUANT`` holds.
"""
import jax.numpy as jnp
import numpy as np
import torch

import torch_families as F
from repro.models import attention as JA
from repro_torch.models import attention as TA

ARCH = "qwen2_0_5b"


def test_quant_kv_matches_reference():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-2, 2, (8, 64, 8, 1))
    x = (rng.standard_normal((8, 64, 8, 64)) * mag).astype(np.float32)
    # exact halves of the scale 2**-3 (amax 127/8): round half to even
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :6] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]) / 8.0
    qj, sj = JA._quant_kv(jnp.asarray(x))
    qt, st = TA._quant_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float16
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999
    np.testing.assert_array_equal(qt.numpy()[0, 0, 0, :6],
                                  [127, 0, 2, 2, 0, -2])
    np.testing.assert_allclose(st.numpy().astype(np.float32),
                               np.asarray(sj, np.float32), rtol=1e-3)
    np.testing.assert_allclose(
        TA._dequant_kv(qt, st, torch.float32).numpy(),
        np.asarray(JA._dequant_kv(jnp.asarray(qt.numpy()),
                                  jnp.asarray(st.numpy()), jnp.float32)),
        rtol=1e-6)


def test_forward_train_and_adamw_step_match_reference():
    F.check_train(ARCH, kv_quant=True)
    F.check_adamw_step(ARCH, kv_quant=True)


def test_prefill_and_decode_match_reference():
    F.check_serve(ARCH, kv_quant=True)


def test_decode_matches_prefill_dense():
    F.check_teacher_forced(ARCH)


def test_int8_decode_stays_near_the_full_prefill():
    full, step = F.teacher_forced(ARCH, kv_quant=True)
    assert np.abs(step - full).max() <= 0.05 * np.abs(full).max()
