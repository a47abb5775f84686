"""The port's training math against the reference on the CPU, f32.

- ``cross_entropy`` with and without the z-loss: within 1e-6.
- ``forward_train``: the loss within rtol 1e-5 and every gradient within
  atol 1e-5 / rtol 1e-4 (the packages sum f32 products in different
  orders), on the Qwen2-0.5B and Qwen2.5-3B smoke configs, remat on and
  off, the sequence in two loss chunks; the reference's weights carried
  across by ``convert.params_from_numpy``, the gradients back by
  ``convert.named_to_tree``.
- ``adamw_update`` fed the same numpy gradients and state: params, ``mu``
  and ``nu`` within 1e-6 over three steps (not after a fresh backward
  each: at step 1 ``delta ~ sign(g)`` magnifies the gradients' last-bit
  differences), the learning rate and the clip; ``cosine_schedule`` and
  ``global_norm``.
- int8 compression with error feedback: ``q`` bitwise (round half to
  even), the scale and residual within 1e-6, ``compress_tree`` too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import get_smoke_config as j_smoke
from repro.data.synthetic import make_train_batch as j_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ShapeCell as JCell
from repro.optim import AdamWConfig as JCfg
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_train_batch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.config import ShapeCell
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC

ARCHES = ["qwen2_0_5b", "qwen2_5_3b"]
SEQ, BATCH = 128, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(ref, got, **tol):
    a, b = _leaves(ref), _leaves(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 301))).astype(np.float32)
    tgt = rng.integers(0, 301, (2, 7)).astype(np.int32)
    ref = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(tgt),
                           z_loss=z_loss)
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt),
                           z_loss=z_loss)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", ARCHES)
def test_forward_train_loss_and_grads_match_reference(arch, remat):
    cfg_j = j_smoke(arch).replace(remat=remat, loss_chunk=SEQ // 2)
    cfg_t = get_smoke_config(arch).replace(remat=remat, loss_chunk=SEQ // 2)
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(1),
                              dtype=jnp.float32)
    model = convert.params_from_numpy(_np(params_j), cfg_t, device="cpu")
    model.requires_grad_(True)
    batch_j = j_batch(cfg_j, JCell("t", "train", SEQ, BATCH), seed=2,
                      dtype=jnp.float32)
    batch_t = make_train_batch(cfg_t, ShapeCell("t", "train", SEQ, BATCH),
                               seed=2, dtype=torch.float32, device="cpu")

    (loss_j, met_j), grads_j = jax.value_and_grad(
        lambda p: JT.forward_train(p, cfg_j, batch_j), has_aux=True)(
        params_j)
    loss_t, met_t = TT.forward_train(model, cfg_t, batch_t)
    names, ps = zip(*model.named_parameters())
    grads_t = dict(zip(names, torch.autograd.grad(loss_t, ps)))

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    assert sorted(met_t) == sorted(met_j)
    np.testing.assert_allclose(float(met_t["ce_loss"].detach()),
                               float(met_j["ce_loss"]), rtol=1e-5)
    _assert_trees_close(_np(grads_j), convert.named_to_tree(grads_t),
                        atol=1e-5, rtol=1e-4)


def test_forward_train_rejects_a_sequence_off_the_loss_chunk():
    cfg = get_smoke_config("qwen2_0_5b").replace(loss_chunk=48)
    model = TT.init_params(cfg, seed=0, device="cpu")
    batch = make_train_batch(cfg, ShapeCell("t", "train", 64, 1),
                             dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        TT.forward_train(model, cfg, batch)


def _random_tree(tree, rng, scale):
    return jax.tree_util.tree_map(
        lambda x: (scale * rng.standard_normal(x.shape)).astype(np.float32),
        tree)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_adamw_update_matches_reference(clip):
    cfg_j = j_smoke("qwen2_0_5b")
    cfg_t = get_smoke_config("qwen2_0_5b")
    rng = np.random.default_rng(3)
    params = _np(JT.init_params(cfg_j, jax.random.PRNGKey(0),
                                dtype=jnp.float32))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, clip_norm=clip)
    ocj, oct_ = JCfg(**kw), AdamWConfig(**kw)
    state_j = {"mu": _random_tree(params, rng, 1e-3),
               "nu": jax.tree_util.tree_map(np.abs,
                                            _random_tree(params, rng, 1e-5)),
               "step": np.asarray(4, np.int32)}
    model = convert.params_from_numpy(params, cfg_t, device="cpu")
    state_t = convert.opt_state_from_numpy(state_j, model)
    names = [n for n, _ in model.named_parameters()]
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = jax.tree_util.tree_map(jnp.asarray, state_j)
    for _ in range(3):
        g = _random_tree(params, rng, 0.05)
        pj, sj, mj = JA.adamw_update(ocj, pj, jax.tree_util.tree_map(
            jnp.asarray, g), sj)
        grads_t = {n: torch.from_numpy(a) for n, a in
                   convert.tree_to_named(g, names).items()}
        model, state_t, mt = TA.adamw_update(oct_, model, grads_t, state_t)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-6)
        _assert_trees_close(_np(pj), convert.params_to_numpy(model),
                            atol=1e-6, rtol=0)
        got = convert.opt_state_to_numpy(state_t)
        _assert_trees_close(_np(sj["mu"]), got["mu"], atol=1e-6, rtol=0)
        _assert_trees_close(_np(sj["nu"]), got["nu"], atol=1e-6, rtol=0)
        assert int(got["step"]) == int(sj["step"])
        assert got["step"].dtype == np.int32


def test_cosine_schedule_and_global_norm_match_reference():
    kw = dict(lr=2.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    ref, got = JCfg(**kw), AdamWConfig(**kw)
    for s in [0, 1, 5, 9, 10, 11, 55, 99, 100, 150]:
        np.testing.assert_allclose(
            float(TA.cosine_schedule(got, torch.tensor(s, dtype=torch.int32))),
            float(JA.cosine_schedule(ref, jnp.asarray(s, jnp.int32))),
            rtol=1e-6, err_msg=f"step {s}")
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(sh).astype(np.float32)
          for sh in [(3, 4), (17,), (2, 3, 5)]]
    np.testing.assert_allclose(
        float(TA.global_norm([torch.from_numpy(x) for x in xs])),
        float(JA.global_norm([jnp.asarray(x) for x in xs])), rtol=1e-6)


def test_int8_compression_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    # exact halves of the scale: round half to even in both packages
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 127.0],
                     np.float32) * (3.0 / 127.0)
    x[8] = 3.0                                   # amax: scale 3/127
    r0 = (1e-3 * rng.standard_normal(1000)).astype(np.float32)
    for res in (None, r0):
        qj, sj, rj = JC.int8_compress(
            jnp.asarray(x), None if res is None else jnp.asarray(res))
        qt, st, rt = TC.int8_compress(
            torch.from_numpy(x), None if res is None else
            torch.from_numpy(res))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-7)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)
        np.testing.assert_allclose(
            TC.int8_decompress(qt, st).numpy(),
            np.asarray(JC.int8_decompress(qj, sj)), atol=1e-6)
    tree = {"a": x[:100], "b": {"c": x[100:300].reshape(10, 20)}}
    qj, sj, rj = JC.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    qt, st, rt = TC.compress_tree(jax.tree_util.tree_map(torch.from_numpy,
                                                         tree))
    _assert_trees_close(_np(qj), jax.tree_util.tree_map(
        lambda t: t.numpy(), qt), atol=0, rtol=0)
    _assert_trees_close(_np(rj), jax.tree_util.tree_map(
        lambda t: t.numpy(), rt), atol=1e-6)
    _assert_trees_close(_np(JC.decompress_tree(qj, sj)),
                        jax.tree_util.tree_map(lambda t: t.numpy(),
                                               TC.decompress_tree(qt, st)),
                        atol=1e-6)
