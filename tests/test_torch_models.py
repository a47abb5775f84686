"""The port's LM stack against the reference on the CPU, f32, with the
reference's weights carried across by ``repro_torch.convert``:
``rms_norm``, ``apply_rope``, ``rope_freqs``, and ``forward_serve``
prefill and cached decode on the smoke configs of Qwen2.5-3B and
Qwen2-0.5B (dense GQA, QKV bias, tied embeddings). Logits agree within
1e-4 absolute (the two packages sum f32 products in different orders);
greedy tokens agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ATOL = 1e-4
ARCHES = ["qwen2_5_3b", "qwen2_0_5b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch):
    cfg_j = j_smoke(arch)
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    cfg_t = get_smoke_config(arch)
    params_t = convert.params_from_numpy(_np_tree(params_j), cfg_t,
                                         device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def test_configs_are_the_references():
    import repro.configs as JC
    assert ARCH_IDS == JC.ARCH_IDS
    for a in ARCH_IDS:
        assert repr(get_config(a)) == repr(JC.get_config(a))
        assert repr(get_smoke_config(a)) == repr(JC.get_smoke_config(a))
    assert get_config("qwen2-0.5b").hd == 64


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    ref = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_array_equal(TL.rope_freqs(64, 1e6),
                                  JL.rope_freqs(64, 1e6))
    pos = rng.integers(0, 600, (2, 5)).astype(np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    ref = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    err = float(np.abs(got.numpy() - np.asarray(ref)).max())
    print(f"apply_rope max |port - reference| = {err:.3e}")
    assert err <= 1e-4


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_serve_prefill_and_decode_match_reference(arch):
    cfg_j, params_j, cfg_t, params_t = _models(arch)
    rng = np.random.default_rng(1)
    b, t, max_seq = 2, 12, 32
    toks = rng.integers(0, cfg_j.vocab, (b, t)).astype(np.int32)

    cache_j = JT.init_cache(cfg_j, b, max_seq, dtype=jnp.float32)
    lj, cache_j = JT.forward_serve(params_j, cfg_j,
                                   {"tokens": jnp.asarray(toks)}, cache_j,
                                   jnp.zeros((b,), jnp.int32), decode=False)
    cache_t = TT.init_cache(cfg_t, b, max_seq, device="cpu")
    lt, cache_t = TT.forward_serve(params_t, cfg_t,
                                   {"tokens": torch.from_numpy(toks).long()},
                                   cache_t, torch.zeros((b,), dtype=torch.int32),
                                   decode=False)
    errs = [float(np.abs(lt.numpy() - np.asarray(lj)).max())]
    np.testing.assert_allclose(cache_t["k"].numpy(), np.asarray(cache_j["k"]),
                               atol=ATOL)
    lens_j = jnp.full((b,), t, jnp.int32)
    lens_t = torch.full((b,), t, dtype=torch.int32)
    tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for _ in range(3):
        assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
        lj, cache_j = JT.forward_serve(params_j, cfg_j,
                                       {"tokens": jnp.asarray(tok)}, cache_j,
                                       lens_j, decode=True)
        lt, cache_t = TT.forward_serve(params_t, cfg_t,
                                       {"tokens": torch.from_numpy(tok).long()},
                                       cache_t, lens_t, decode=True)
        errs.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        lens_j, lens_t = lens_j + 1, lens_t + 1
    print(f"{arch}: forward_serve max |logits port - reference| per call "
          f"(prefill, 3 decodes) = {['%.2e' % e for e in errs]}")
    assert max(errs) <= ATOL
    np.testing.assert_allclose(cache_t["v"].numpy(), np.asarray(cache_j["v"]),
                               atol=ATOL)


def test_init_params_is_seeded_and_scaled():
    cfg = get_smoke_config("qwen2_0_5b")
    a = TT.init_params(cfg, seed=3, device="cpu")
    b = TT.init_params(cfg, seed=3, device="cpu")
    c = TT.init_params(cfg, seed=4, device="cpu")
    for (n, x), (_, y), (_, z) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(x, y), n
    assert not torch.equal(a.embed, c.embed)
    assert isinstance(a.blocks, torch.nn.ModuleList)
    assert len(a.blocks) == cfg.n_layers
    assert not hasattr(a, "lm_head")           # tied embeddings
    std = float(a.blocks[0].mlp.w_gate.std())
    assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_families_outside_the_slice_raise():
    """The families once outside the port's model slice (moe, ssm,
    hybrid, the stub modalities) and the int8 KV cache run now: for every
    smoke config of ``ARCH_IDS``, and Qwen2-0.5B's with ``kv_quant``,
    ``init_params``, ``init_cache``, ``forward_train`` (and its backward
    pass) and ``forward_serve`` (prefill and one decode step) give finite
    outputs of the expected shapes. What stays outside raises: the paged
    serving engine, for all but the dense text family with a float
    cache (ROADMAP Queue 3 item 6)."""
    from repro_torch.data.synthetic import make_serve_batch, make_train_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.serving.engine import check_servable
    cfgs = [get_smoke_config(a) for a in ARCH_IDS]
    cfgs.append(get_smoke_config("qwen2_0_5b").replace(kv_quant=True))
    b = 2
    for cfg in cfgs:
        model = TT.init_params(cfg, seed=0, device="cpu")
        batch = make_train_batch(cfg, ShapeCell("t", "train", 64, b),
                                 dtype=torch.float32, device="cpu")
        model.requires_grad_(True)
        loss, met = TT.forward_train(model, cfg, batch)
        assert torch.isfinite(loss) and sorted(met) == [
            "ce_loss", "moe_aux", "moe_z"], cfg.name
        assert (float(met["moe_aux"].detach()) > 0) == (cfg.family == "moe")
        loss.backward()
        assert all(p.grad is None or torch.isfinite(p.grad).all()
                   for p in model.parameters()), cfg.name
        model.requires_grad_(False)
        prompt = make_serve_batch(cfg, ShapeCell("s", "decode", 16, b),
                                  decode=False, dtype=torch.float32,
                                  device="cpu")
        cache = TT.init_cache(cfg, b, 24, device="cpu")
        logits, cache = TT.forward_serve(
            model, cfg, prompt, cache, torch.zeros((b,), dtype=torch.int32),
            decode=False)
        step = make_serve_batch(cfg, ShapeCell("s", "decode", 16, b),
                                decode=True, dtype=torch.float32,
                                device="cpu")
        logits2, _ = TT.forward_serve(model, cfg, step, cache,
                                      torch.full((b,), 16, dtype=torch.int32),
                                      decode=True)
        for x in (logits, logits2):
            assert x.shape == (b, cfg.vocab) and torch.isfinite(x).all()
        if cfg.family == "dense" and not cfg.kv_quant:
            check_servable(cfg)
        else:
            with pytest.raises(ValueError):
                check_servable(cfg)


def test_prefill_longer_than_q_chunk_and_ragged():
    """A prompt longer than ``attn_q_chunk`` and not a multiple of it: the
    reference refuses it (``causal_attention`` asserts T % q_chunk == 0,
    ROADMAP Queue 3); the port chunks it with a short last chunk and
    matches the reference run with one chunk over the whole prompt."""
    cfg_j, params_j, cfg_t, params_t = _models("qwen2_0_5b")
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab, (1, 45))
    cache_t = TT.init_cache(cfg_t, 1, 48, device="cpu")
    lt, _ = TT.forward_serve(params_t, cfg_t,
                             {"tokens": torch.from_numpy(toks)}, cache_t,
                             torch.zeros((1,), dtype=torch.int32),
                             decode=False)
    one = cfg_j.replace(attn_q_chunk=64)
    lj, _ = JT.forward_serve(params_j, one,
                             {"tokens": jnp.asarray(toks, jnp.int32)},
                             JT.init_cache(one, 1, 48, dtype=jnp.float32),
                             jnp.zeros((1,), jnp.int32), decode=False)
    assert cfg_t.attn_q_chunk == 32 and 45 % 32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    with pytest.raises(AssertionError):
        JT.forward_serve(params_j, cfg_j,
                         {"tokens": jnp.asarray(toks, jnp.int32)},
                         JT.init_cache(cfg_j, 1, 48, dtype=jnp.float32),
                         jnp.zeros((1,), jnp.int32), decode=False)
