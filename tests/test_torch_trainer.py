"""The port's training loop and checkpoints, against the reference where
both run.

- The port's versions of ``tests/test_substrates.py``: AdamW memorizes a
  batch, the schedule's shape, int8 error feedback, a checkpoint round
  trip (bf16 leaf included), retention, and the bitwise resume (killed
  after step 8, resumed from the step-5 checkpoint, equal bit for bit to
  the uninterrupted run: the chip smoke's ``bitwise_resume``).
- The async writer: a failed write surfaces on the next ``wait()`` or
  ``save()``, once.
- Checkpoint files cross the packages both ways: a ``Trainer`` of one
  package resumes from the other's file with equal weights and optimizer
  state, bit for bit.
- Five ``Trainer`` steps from the same weights give losses within rtol
  1e-4 of the reference's; ``TRAIN_SMOKE_LOSS`` (the smoke's step-1 loss
  constant) is recomputed from the reference.
- ``python -m repro_torch.launch.train --smoke --device cpu`` runs.
"""
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.configs import get_smoke_config as j_smoke
from repro.data.synthetic import make_train_batch as j_batch
from repro.models.config import ShapeCell as JCell
from repro.optim import AdamWConfig as JCfg
from repro.runtime.train import Trainer as JTrainer
from repro.runtime.train import TrainerConfig as JTCfg
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_train_batch
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeCell
from repro_torch.optim import (AdamWConfig, adamw_init, cosine_schedule,
                               int8_compress, int8_decompress)
from repro_torch.runtime.train import (Trainer, TrainerConfig,
                                       build_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = ShapeCell("smoke_train", "train", 128, 2)
J_CELL = JCell("smoke_train", "train", 128, 2)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


def test_adamw_reduces_loss():
    cfg = get_smoke_config("qwen2_0_5b")
    params = T.init_params(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=40)
    opt = adamw_init(params)
    batch = make_train_batch(cfg, CELL, dtype=torch.float32, device="cpu")
    step = build_train_step(cfg, opt_cfg)
    losses = []
    for _ in range(25):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    # memorizing one small batch must drive the loss down hard
    assert losses[-1] < losses[0] - 1.0, losses[::6]
    assert int(opt["step"]) == 25


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s)))
           for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6
    assert abs(lrs[2] - 1.0) < 1e-6
    assert 0.1 < lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-6


def test_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s, r = int8_compress(x)
    deq = int8_decompress(q, s)
    # quantization error bounded by scale/2 per element
    assert float((deq - x).abs().max()) <= float(s) * 0.51
    # error feedback: residual + deq == original
    np.testing.assert_allclose((deq + r).numpy(), x.numpy(), atol=1e-6)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16) / 3,
                  "d": torch.tensor(7, dtype=torch.int32)}}
    p = str(tmp_path / "ck")
    save_pytree(tree, p)
    out = restore_pytree(tree, p)
    for k, x, y in [("a", tree["a"], out["a"]),
                    ("c", tree["b"]["c"], out["b"]["c"]),
                    ("d", tree["b"]["d"], out["b"]["d"])]:
        assert x.dtype == y.dtype and torch.equal(x, y), k
    # the file is the reference's: it restores there too
    from repro.checkpoint import restore_pytree as j_restore
    ref = j_restore({"a": jnp.zeros(10), "b": {
        "c": jnp.zeros((3, 4), jnp.bfloat16),
        "d": jnp.zeros((), jnp.int32)}}, p)
    np.testing.assert_array_equal(np.asarray(ref["b"]["c"], np.float32),
                                  tree["b"]["c"].float().numpy())


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"w": torch.zeros((4,))}
    for s in [10, 20, 30, 40]:
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.latest_step() == 40
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2, files


def test_async_checkpoint_copies_and_retains(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros((4,))
    for s in [1, 2, 3]:
        mgr.save(s, {"w": w})
        w += 1              # in-place updates after save do not leak in
    step, tree = mgr.restore_latest({"w": torch.empty(4)})
    assert step == 3 and torch.equal(tree["w"], torch.full((4,), 2.0))
    assert sorted(os.listdir(tmp_path)) == ["step_000000002.npz",
                                            "step_000000003.npz"]


def test_async_write_error_surfaces_on_wait(tmp_path):
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d), keep=2)
    d.rmdir()                                 # the write will fail
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        mgr.wait()
    mgr.wait()                                # raised once
    mgr.save(2, {"w": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):    # the next save raises it
        mgr.save(3, {"w": torch.zeros(3)})
    d.mkdir()
    mgr.save(4, {"w": torch.zeros(3)})
    mgr.wait()
    assert mgr.latest_step() == 4


def test_trainer_failure_recovery_bitwise(tmp_path):
    """Kill training mid-run; restart must reproduce the uninterrupted run
    bit for bit (deterministic data + checkpointed optimizer)."""
    res = SMOKE.bitwise_resume(str(tmp_path), device="cpu")
    assert res["resumed_at"] == 5


def _j_trainer(d, total, ckpt_every, log_every=100):
    cfg = j_smoke("qwen2_5_3b")
    return JTrainer(cfg, J_CELL, JCfg(lr=1e-3, warmup_steps=2,
                                      total_steps=30),
                    JTCfg(total_steps=total, ckpt_every=ckpt_every,
                          ckpt_dir=str(d), log_every=log_every),
                    make_batch=lambda s: j_batch(cfg, J_CELL, seed=7, step=s,
                                                 dtype=jnp.float32), seed=3)


def _t_trainer(d, total, ckpt_every, log_every=100):
    cfg = get_smoke_config("qwen2_5_3b")
    return Trainer(cfg, CELL, AdamWConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=30),
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(d), log_every=log_every),
                   make_batch=lambda s: make_train_batch(
                       cfg, CELL, seed=7, step=s, dtype=torch.float32,
                       device="cpu"), seed=3, device="cpu")


def _assert_same_state(j, t):
    ref = jax.tree_util.tree_map(np.asarray, {"params": j.params,
                                              "opt": j.opt_state})
    got = {"params": convert.params_to_numpy(t.params),
           "opt": convert.opt_state_to_numpy(t.opt_state)}
    a = jax.tree_util.tree_flatten_with_path(ref)[0]
    b = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(y, x,
                                      err_msg=jax.tree_util.keystr(path))


def test_checkpoints_cross_the_packages(tmp_path):
    # reference writes, port resumes
    j = _j_trainer(tmp_path / "j", 5, 5)
    j.run()
    t = _t_trainer(tmp_path / "j", 8, 5)
    assert t.maybe_resume() and t.start_step == 5
    _assert_same_state(j, t)
    # port writes, reference resumes
    t = _t_trainer(tmp_path / "t", 5, 5)
    t.run()
    j = _j_trainer(tmp_path / "t", 8, 5)
    assert j.maybe_resume() and j.start_step == 5
    _assert_same_state(j, t)


def test_trainer_losses_match_reference(tmp_path):
    cfg = get_smoke_config("qwen2_5_3b")
    tree = convert.numpy_params(cfg, 5)
    j = _j_trainer(tmp_path / "j", 5, 100, log_every=1)
    j.params = jax.tree_util.tree_map(jnp.asarray, tree)
    from repro.optim import adamw_init as j_init
    j.opt_state = j_init(j.params)
    t = _t_trainer(tmp_path / "t", 5, 100, log_every=1)
    t.params = convert.params_from_numpy(tree, cfg, device="cpu")
    t.opt_state = adamw_init(t.params)
    lj = [m["loss"] for m in j.run()["metrics"]]
    lt = [m["loss"] for m in t.run()["metrics"]]
    assert len(lj) == len(lt) == 5
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


def test_train_smoke_loss_constant_is_the_references():
    from repro.models import transformer as JT
    c = SMOKE.TRAIN_SMOKE
    cfg = j_smoke(c["arch"])
    tree = convert.numpy_params(cfg, c["weights_seed"])
    batch = j_batch(cfg, JCell("smoke_train", "train", c["seq"],
                               c["batch"]), seed=c["data_seed"], step=0,
                    dtype=jnp.float32)
    loss, _ = JT.forward_train(jax.tree_util.tree_map(jnp.asarray, tree),
                               cfg, batch)
    np.testing.assert_allclose(float(loss), SMOKE.TRAIN_SMOKE_LOSS,
                               rtol=1e-6)
    # and the smoke's own path, on the CPU
    np.testing.assert_allclose(SMOKE.train_smoke_loss(device="cpu"),
                               SMOKE.TRAIN_SMOKE_LOSS, rtol=1e-5)


def test_launch_train_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2_0_5b", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    assert "done at step 3" in out.stdout, out.stdout + out.stderr
    assert os.listdir(tmp_path) == ["step_000000002.npz"]


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from repro_torch.core import skiplist as SL
    cfg = get_smoke_config("qwen2_0_5b")
    for make in (lambda: SL.init(16, 4),
                 lambda: make_train_batch(cfg, CELL),
                 lambda: T.init_params(cfg),
                 lambda: Trainer(cfg, CELL, AdamWConfig(),
                                 TrainerConfig(ckpt_dir=str(tmp_path)),
                                 make_batch=lambda s: None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2_0_5b", "--smoke", "--steps", "1", "--ckpt-dir",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
