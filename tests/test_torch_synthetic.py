"""The port's synthetic data pipeline against the reference, bitwise.

``make_train_batch`` and ``make_serve_batch`` (prefill and decode) for each
modality — text, the audio stub (frame embeddings) and the vision stub
(patch embeddings + text) — at several seeds, steps and data-parallel
shards: every key, dtype, shape and bit equal, in f32 and in bf16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import get_smoke_config as j_smoke
from repro.data import synthetic as JS
from repro.models.config import ShapeCell as JCell
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic as TS
from repro_torch.models.config import ShapeCell

ARCHES = {"text": "qwen2_0_5b", "audio_stub": "musicgen_medium",
          "vision_stub": "llava_next_mistral_7b"}
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _assert_batch_equal(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        a, b = ref[k], got[k]
        assert b.device.type == "cpu"
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16, k
            # equal bits: both round the same f32 draws to bf16
            a = np.asarray(a).view(np.uint16)
            b = b.view(torch.int16).numpy().view(np.uint16)
        else:
            a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("modality", sorted(ARCHES))
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_train_batch_matches_reference(modality, dtypes):
    arch = ARCHES[modality]
    cfg_j, cfg_t = j_smoke(arch), get_smoke_config(arch)
    assert cfg_t.modality == modality
    for seed, step, shard, n, s in [(0, 0, 0, 1, 128), (7, 5, 1, 2, 64),
                                    (3, 11, 3, 4, 96)]:
        ref = JS.make_train_batch(cfg_j, JCell("t", "train", s, 4),
                                  seed=seed, step=step, shard=shard,
                                  num_shards=n, dtype=dtypes[0])
        got = TS.make_train_batch(cfg_t, ShapeCell("t", "train", s, 4),
                                  seed=seed, step=step, shard=shard,
                                  num_shards=n, dtype=dtypes[1],
                                  device="cpu")
        _assert_batch_equal(ref, got)


@pytest.mark.parametrize("modality", sorted(ARCHES))
@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_serve_batch_matches_reference(modality, decode):
    arch = ARCHES[modality]
    cfg_j, cfg_t = j_smoke(arch), get_smoke_config(arch)
    for (dj, dt), (seed, shard, n) in zip(DTYPES, [(0, 0, 1), (5, 1, 2)]):
        ref = JS.make_serve_batch(cfg_j, JCell("s", "decode", 64, 2),
                                  decode=decode, seed=seed, shard=shard,
                                  num_shards=n, dtype=dj)
        got = TS.make_serve_batch(cfg_t, ShapeCell("s", "decode", 64, 2),
                                  decode=decode, seed=seed, shard=shard,
                                  num_shards=n, dtype=dt, device="cpu")
        _assert_batch_equal(ref, got)


def test_batches_are_a_pure_function_of_step_and_disjoint_shards():
    cfg = get_smoke_config("qwen2_0_5b")
    cell = ShapeCell("t", "train", 32, 4)
    a = TS.make_train_batch(cfg, cell, step=3, device="cpu")
    b = TS.make_train_batch(cfg, cell, step=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    s0 = TS.make_train_batch(cfg, cell, step=3, shard=0, num_shards=2,
                             device="cpu")
    s1 = TS.make_train_batch(cfg, cell, step=3, shard=1, num_shards=2,
                             device="cpu")
    assert not torch.equal(s0["tokens"], s1["tokens"])
    # the shifted stream: targets are the next tokens
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    with pytest.raises(ValueError):
        TS.make_train_batch(cfg, ShapeCell("t", "train", 32, 3),
                            num_shards=2, device="cpu")
