"""The mesh path of the port's training runtime on the CPU.

- ``build_train_step(mesh=)`` on a one-rank gloo mesh gives bit for bit
  the parameters, AdamW state and losses of ``mesh=None`` over two steps
  (the same seed, weights and batch).
- With the dry-run's activation roles bound on that mesh,
  ``forward_train`` gives bit for bit its output with no role bound.
- ``restore_pytree(shardings=)`` restores a checkpoint the reference
  wrote (``tests/test_elastic.py``'s model) onto a 2×2 gloo mesh, four
  ranks spawned in one subprocess: every leaf laid out by the rules, its
  full tensor equal bit for bit to the reference's single-device
  restore, which is the saved arrays.
"""
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_spmd import ROOT

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_train_batch
from repro_torch.launch.inputs import activation_roles
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import transformer as TT
from repro_torch.models.config import ShapeCell
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import actctx
from repro_torch.runtime.train import build_train_step

CELL = ShapeCell("t", "train", 64, 2)


def _run(mesh, steps=2):
    cfg = get_smoke_config("qwen2_5_3b")
    params = TT.init_params(cfg, seed=3, device="cpu")
    opt = adamw_init(params)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=steps), mesh)
    batch = make_train_batch(cfg, CELL, seed=0, step=0,
                             dtype=torch.float32, device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])

    def plain(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    return ({n: plain(p) for n, p in params.named_parameters()},
            {k: {n: plain(t) for n, t in opt[k].items()}
             for k in ("mu", "nu")}, losses)


def test_mesh_step_equals_the_plain_step_bit_for_bit():
    p0, o0, l0 = _run(None)
    with host_mesh("cpu") as mesh:
        p1, o1, l1 = _run(mesh)
    assert [float(x) for x in l0] == [float(x) for x in l1]
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
    for k in o0:
        for n in o0[k]:
            assert torch.equal(o0[k][n], o1[k][n]), (k, n)


def test_roles_leave_forward_train_unchanged():
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.runtime import sharding as S
    cfg = get_smoke_config("granite_moe_3b_a800m")
    batch = make_train_batch(cfg, CELL, seed=1, step=0,
                             dtype=torch.float32, device="cpu")
    params = TT.init_params(cfg, seed=5, device="cpu")
    with torch.no_grad():
        want, wm = TT.forward_train(params, cfg, batch)
    with host_mesh("cpu") as mesh:
        S.distribute_params_(params, mesh)
        db = S.distribute(batch, S.batch_shardings(batch, mesh), mesh)
        roles = activation_roles(cfg, CELL, mesh)
        assert {"hidden", "moe_dispatch", "moe_route"} <= set(roles)
        with actctx.roles(**roles), implicit_replication(), \
                torch.no_grad():
            got, gm = TT.forward_train(params, cfg, db)
        got = got.full_tensor()
    assert torch.equal(want, got)
    assert float(wm["moe_aux"]) == float(gm["moe_aux"].full_tensor())


SPAWN = """
import sys
import torch.multiprocessing as mp
import torch_mesh_workers as W
mp.spawn(W.elastic_worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_elastic_restore_onto_a_2x2_mesh(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_pytree as ref_restore
    from repro.checkpoint import save_pytree as ref_save
    from repro.configs import get_smoke_config as ref_config
    from repro.models import transformer as JT
    cfg = ref_config("qwen2_5_3b").replace(d_model=64, n_heads=4,
                                          n_kv_heads=2)
    params = JT.init_params(cfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    path = str(tmp_path / "elastic.npz")
    ref_save(params, path)
    ref = ref_restore(params, path)
    np.savez(tmp_path / "want.npz", **{
        "/".join(str(k).strip("[].'") for k in p): np.asarray(x)
        for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    r = subprocess.run([sys.executable, "-c", SPAWN, str(_free_port()),
                        str(tmp_path)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    for rank in range(4):
        assert pathlib.Path(tmp_path, f"rank{rank}.ok").exists()
