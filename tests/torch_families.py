"""Shared helpers of the port's model-family parity tests
(``tests/test_torch_{moe,ssm,hybrid,modalities,kvquant}.py``).

One set of weights (``convert.numpy_params``) and one batch
(``data.synthetic``, bitwise equal in both packages) go through the
reference's jitted ``forward_train`` / ``forward_serve`` and the port's
eager ones on the CPU, f32, at a smoke config (``get_smoke_config``).
The training inputs are ``chip_smoke.FAMILIES_SMOKE``'s, so the
reference's loss here is the one ``FAMILIES_SMOKE_LOSS`` records.

Tolerances (the packages sum f32 products in different orders):
- loss, ``ce_loss``, ``moe_aux``, ``moe_z``: rtol 1e-5;
- gradients: atol 1e-5 / rtol 1e-4 (``tests/test_torch_train.py``'s);
- one AdamW step fed the reference's gradients: params, ``mu``, ``nu``
  within 1e-6;
- prefill and 3 decode steps: logits and float caches within 1e-4
  (``tests/test_torch_models.py``'s), greedy tokens equal; int8 cache
  codes equal on >= 99.99% of entries and never more than 1 apart, fp16
  scales within rtol 1e-3;
- the port's teacher-forced decode (prefill of s-1 tokens, then decode
  token s) against its full prefill of s: atol 2e-4 / rtol 1e-3, the
  reference's ``tests/test_arch_smoke.py`` check.
"""
from __future__ import annotations

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import get_smoke_config as j_smoke
from repro.data.synthetic import make_serve_batch as j_serve_batch
from repro.data.synthetic import make_train_batch as j_train_batch
from repro.models import transformer as JT
from repro.models.config import ShapeCell as JCell
from repro.optim import adamw as JA
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_train_batch
from repro_torch.models import transformer as TT
from repro_torch.models.config import ShapeCell
from repro_torch.optim import adamw as TA

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()
C = SMOKE.FAMILIES_SMOKE
LOGIT_ATOL = 1e-4


def configs(arch, **kw):
    """(reference config, port config) of ``arch``'s smoke config."""
    return j_smoke(arch).replace(**kw), get_smoke_config(arch).replace(**kw)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(ref, got, **tol):
    a = jax.tree_util.tree_flatten_with_path(ref)[0]
    b = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@functools.lru_cache(maxsize=None)
def reference_train(arch, batch=C["batch"], kv_quant=False):
    """The reference's (weights, loss, metrics, gradients), numpy, at
    ``FAMILIES_SMOKE``'s inputs with ``batch`` rows."""
    cfg = j_smoke(arch).replace(kv_quant=kv_quant)
    tree = convert.numpy_params(cfg, C["weights_seed"])
    b = j_train_batch(cfg, JCell("smoke_train", "train", C["seq"], batch),
                      seed=C["data_seed"], step=0, dtype=jnp.float32)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(p, cfg, b), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return (tree, float(loss), {k: float(v) for k, v in met.items()},
            np_tree(grads))


def port_train(arch, tree, batch=C["batch"], **kw):
    """The port's (loss, metrics, gradients as the reference's tree) on
    the same inputs, at the smoke config with ``kw`` replaced."""
    cfg = get_smoke_config(arch).replace(**kw)
    model = convert.params_from_numpy(tree, cfg, device="cpu")
    model.requires_grad_(True)
    b = make_train_batch(cfg, ShapeCell("smoke_train", "train", C["seq"],
                                        batch), seed=C["data_seed"], step=0,
                         dtype=torch.float32, device="cpu")
    loss, met = TT.forward_train(model, cfg, b)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()), {k: float(v.detach())
                                   for k, v in met.items()},
            convert.named_to_tree(dict(zip(names, grads))))


def check_train(arch, batch=C["batch"], ref_over=1.0, kv_quant=False):
    """Loss, metrics and every gradient of the port against the
    reference's divided by ``ref_over``."""
    tree, loss_j, met_j, grads_j = reference_train(arch, batch, kv_quant)
    loss_t, met_t, grads_t = port_train(arch, tree, batch,
                                        kv_quant=kv_quant)
    np.testing.assert_allclose(loss_t, loss_j / ref_over, rtol=1e-5)
    assert sorted(met_t) == sorted(met_j) == ["ce_loss", "moe_aux", "moe_z"]
    for k in met_j:
        np.testing.assert_allclose(met_t[k], met_j[k] / ref_over, rtol=1e-5,
                                   atol=1e-12, err_msg=k)
    assert_trees_close(jax.tree_util.tree_map(lambda g: g / ref_over,
                                              grads_j),
                       grads_t, atol=1e-5, rtol=1e-4)
    return loss_t, met_t


def check_adamw_step(arch, kv_quant=False):
    """One AdamW step from a fresh state, both packages fed the
    reference's gradients: params, ``mu`` and ``nu`` within 1e-6 and
    the step counter equal, over the family's whole tree."""
    tree, _, _, grads = reference_train(arch, kv_quant=kv_quant)
    _, cfg_t = configs(arch, kv_quant=kv_quant)
    kw = dict(lr=3e-3, warmup_steps=0, total_steps=10)
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pj, sj, mj = jax.jit(functools.partial(
        JA.adamw_update, JA.AdamWConfig(**kw)))(
        pj, jax.tree_util.tree_map(jnp.asarray, grads), JA.adamw_init(pj))
    model = convert.params_from_numpy(tree, cfg_t, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    grads_t = {n: torch.from_numpy(np.array(a)) for n, a in
               convert.tree_to_named(grads, names).items()}
    model, st, mt = TA.adamw_update(TA.AdamWConfig(**kw), model, grads_t,
                                    TA.adamw_init(model))
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-6)
    assert_trees_close(np_tree(pj), convert.params_to_numpy(model),
                       atol=1e-6, rtol=0)
    got = convert.opt_state_to_numpy(st)
    assert_trees_close(np_tree(sj["mu"]), got["mu"], atol=1e-6, rtol=0)
    assert_trees_close(np_tree(sj["nu"]), got["nu"], atol=1e-6, rtol=0)
    assert int(got["step"]) == int(sj["step"]) == 1


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _step_batch(cfg, tree, tok):
    """A decode step's input for greedy tokens ``tok`` [B, 1]: the
    token, or its embedding row for the audio stub (as
    ``tests/test_arch_smoke.py``)."""
    if cfg.modality == "audio_stub":
        return {"frame_embeds": np.asarray(tree["embed"])[tok[:, 0]][:, None]}
    return {"tokens": tok}


def _assert_caches_close(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        x, y = np.asarray(ref[k]), got[k].numpy()
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype == np.int8:
            diff = np.abs(x.astype(np.int32) - y.astype(np.int32))
            assert diff.max() <= 1, k
            assert (diff == 0).mean() >= 0.9999, (k, (diff == 0).mean())
        elif x.dtype == np.float16:
            np.testing.assert_allclose(y.astype(np.float32),
                                       x.astype(np.float32), rtol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(y, x, atol=LOGIT_ATOL, err_msg=k)


def check_serve(arch, b=2, s=16, max_seq=32, **kw):
    """Prefill (``make_serve_batch``'s prompt) and 3 greedy decode steps
    through both packages: logits and caches after every call. Returns
    the max |logits port - reference| per call."""
    cfg_j, cfg_t = configs(arch, **kw)
    tree = convert.numpy_params(cfg_j, C["weights_seed"])
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert.params_from_numpy(tree, cfg_t, device="cpu")
    serve = jax.jit(lambda p, bt, c, n, d: JT.forward_serve(
        p, cfg_j, bt, c, n, decode=d), static_argnames=("d",))
    prompt = np_tree(j_serve_batch(cfg_j, JCell("s", "decode", s, b),
                                   decode=False, dtype=jnp.float32))
    cache_j = JT.init_cache(cfg_j, b, max_seq, dtype=jnp.float32)
    cache_t = TT.init_cache(cfg_t, b, max_seq, device="cpu")
    lj, cache_j = serve(pj, prompt, cache_j, jnp.zeros((b,), jnp.int32),
                        False)
    lt, cache_t = TT.forward_serve(model, cfg_t, _to_torch(prompt), cache_t,
                                   torch.zeros((b,), dtype=torch.int32),
                                   decode=False)
    errs = []
    for i in range(4):
        errs.append(float(np.abs(lt.numpy() - np.asarray(lj)).max()))
        assert errs[-1] <= LOGIT_ATOL, (i, errs)
        _assert_caches_close(cache_j, cache_t)
        tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        assert np.array_equal(tok[:, 0], lt.argmax(-1).numpy())
        if i == 3:
            break
        step = _step_batch(cfg_j, tree, tok)
        n = s + i
        lj, cache_j = serve(pj, step, cache_j, jnp.full((b,), n, jnp.int32),
                            True)
        lt, cache_t = TT.forward_serve(
            model, cfg_t, _to_torch(step), cache_t,
            torch.full((b,), n, dtype=torch.int32), decode=True)
    return errs


def teacher_forced(arch, b=2, s=16, **kw):
    """The port's logits of token ``s`` two ways: decode after a prefill
    of s-1 tokens, and the last position of a full prefill of s (the
    reference's ``test_decode_matches_prefill_*``). Returns both."""
    _, cfg = configs(arch, **kw)
    model = convert.params_from_numpy(
        convert.numpy_params(cfg, C["weights_seed"]), cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s)))
    zero = torch.zeros((b,), dtype=torch.int32)
    full, _ = TT.forward_serve(model, cfg, {"tokens": toks},
                               TT.init_cache(cfg, b, 32, device="cpu"), zero,
                               decode=False)
    _, cache = TT.forward_serve(model, cfg, {"tokens": toks[:, :-1]},
                                TT.init_cache(cfg, b, 32, device="cpu"),
                                zero, decode=False)
    step, _ = TT.forward_serve(model, cfg, {"tokens": toks[:, -1:]}, cache,
                               torch.full((b,), s - 1, dtype=torch.int32),
                               decode=True)
    return full.numpy(), step.numpy()


def check_teacher_forced(arch, **kw):
    full, step = teacher_forced(arch, **kw)
    np.testing.assert_allclose(step, full, atol=2e-4, rtol=1e-3)


def check_smoke_loss(arch, ref_over=1.0):
    """``FAMILIES_SMOKE_LOSS[arch]`` is the reference's step-1 loss
    (divided by ``ref_over``), and the smoke's own path gives it on the
    CPU."""
    want = SMOKE.FAMILIES_SMOKE_LOSS[arch]
    np.testing.assert_allclose(reference_train(arch)[1] / ref_over, want,
                               rtol=1e-6)
    np.testing.assert_allclose(SMOKE.families_smoke_loss(arch, device="cpu"),
                               want, rtol=1e-5)


def _torch_trainer(arch, d, total, every):
    """The port's ``Trainer`` at ``arch``'s smoke config and
    ``FAMILIES_SMOKE``'s cell and data, checkpointing into ``d``."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import Trainer, TrainerConfig
    cfg = get_smoke_config(arch)
    cell = ShapeCell("smoke_train", "train", C["seq"], C["batch"])
    return Trainer(cfg, cell, AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=30),
                   TrainerConfig(total_steps=total, ckpt_every=every,
                                 ckpt_dir=str(d), log_every=100),
                   make_batch=lambda s: make_train_batch(
                       cfg, cell, seed=C["data_seed"], step=s,
                       dtype=torch.float32, device="cpu"),
                   seed=3, device="cpu")


def _assert_same_state(ref, t):
    got = {"params": convert.params_to_numpy(t.params),
           "opt": convert.opt_state_to_numpy(t.opt_state)}
    a = jax.tree_util.tree_flatten_with_path(np_tree(ref))[0]
    b = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(y, x,
                                      err_msg=jax.tree_util.keystr(path))


def check_checkpoints_cross(arch, tmp_path):
    """A ``{"params", "opt"}`` checkpoint of ``arch``'s smoke config
    written by each package restores in the other, equal leaf for leaf:
    the reference's ``CheckpointManager`` (what its ``Trainer`` saves and
    resumes through) writes ``numpy_params`` weights with a random AdamW
    state at step 2 and the port's ``Trainer`` resumes from it; the
    port's ``Trainer`` writes after 2 steps and the reference's manager
    restores it into the reference's tree."""
    from repro.checkpoint import CheckpointManager as JManager
    rng = np.random.default_rng(4)
    params = convert.numpy_params(configs(arch)[0], C["weights_seed"])
    tree = {"params": params, "opt": {
        "mu": jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32),
            params),
        "nu": jax.tree_util.tree_map(
            lambda x: rng.random(x.shape).astype(np.float32), params),
        "step": np.asarray(2, np.int32)}}
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    mgr = JManager(str(tmp_path / "j"), keep=3)
    mgr.save(2, tree)
    mgr.wait()
    t = _torch_trainer(arch, tmp_path / "j", 3, 2)
    assert t.maybe_resume() and t.start_step == 2
    _assert_same_state(tree, t)
    t = _torch_trainer(arch, tmp_path / "t", 2, 2)
    t.run()
    step, got = JManager(str(tmp_path / "t"), keep=3).restore_latest(tree)
    assert step == 2
    _assert_same_state(got, t)
