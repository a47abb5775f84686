"""Fault-tolerant training runtime (the reference's ``runtime/train.py``).

``build_train_step`` returns the step, for every model family:
``forward_train``, the backward pass through autograd, and
``adamw_update`` in place; the metrics carry the loss, ``ce_loss`` and
the MoE losses ``moe_aux`` and ``moe_z`` (zero outside the moe family).
``Trainer`` wraps it with the loop's mechanics:

  * checkpoint/restart — resume is bitwise: the data pipeline is a pure
    function of the step and the optimizer state is checkpointed. The
    checkpoint is ``{"params", "opt"}`` in the reference's tree and key
    names (``convert.params_to_numpy`` / ``opt_state_to_numpy``), so a
    file written by either package restores in the other;
  * simulated failures — ``failure_hook`` lets tests kill the loop at an
    arbitrary step and assert recovery.

``build_train_step(mesh=)`` is the reference's mesh path: the same step
on DTensors laid out by ``runtime.sharding``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, Optional

import torch

from .. import convert
from ..checkpoint import CheckpointManager
from ..models import transformer as T
from ..models.config import ArchConfig, ShapeCell
from ..optim import AdamWConfig, adamw_init, adamw_update
from . import sharding as S


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, mesh=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``;
    params and state are updated in place, metrics are device scalars.

    With a ``DeviceMesh`` (``launch.mesh.make_host_mesh``, or any mesh
    with ``data``/``model`` axes) the step first lays the parameters and
    the AdamW state out by ``runtime.sharding``'s rules (in place, as
    DTensors, on its first call) and the batch over the data axes, then
    runs the same step on DTensors; its metrics come back replicated as
    plain tensors."""

    def step(params, opt_state, batch):
        params.requires_grad_(True)
        loss, metrics = T.forward_train(params, cfg, batch)
        names, ps = zip(*params.named_parameters())
        # a weight the loss does not reach (the audio stub's embedding)
        # gets a zero gradient, as under the reference's value_and_grad
        grads = dict(zip(names, torch.autograd.grad(
            loss, ps, allow_unused=True, materialize_grads=True)))
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), **{
            k: v.detach() for k, v in metrics.items()}, **opt_metrics}

    if mesh is None:
        return step

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def mesh_step(params, opt_state, batch):
        if not isinstance(params.embed, DTensor):      # first call
            pshard = S.param_shardings(params, mesh)
            S.distribute_params_(params, mesh, pshard)
            opt_state.update(S.distribute_opt_state(opt_state, pshard,
                                                    mesh))
        batch = S.distribute(batch, S.batch_shardings(batch, mesh), mesh)
        with implicit_replication():
            params, opt_state, metrics = step(params, opt_state, batch)
        return params, opt_state, {
            k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}

    return mesh_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: ArchConfig, cell: ShapeCell,
                 opt_cfg: AdamWConfig, tcfg: TrainerConfig, *,
                 make_batch: Callable[[int], Any], dtype=torch.float32,
                 seed: int = 0,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device="cuda"):
        self.cfg, self.cell, self.opt_cfg, self.tcfg = cfg, cell, opt_cfg, tcfg
        self.make_batch = make_batch
        self.failure_hook = failure_hook
        self.step_fn = build_train_step(cfg, opt_cfg)
        self.params = T.init_params(cfg, seed=seed, dtype=dtype,
                                    device=device)
        self.opt_state = adamw_init(self.params)
        self.mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.start_step = 0
        self.metrics_log: list = []

    def _tree(self) -> dict:
        return {"params": convert.params_to_numpy(self.params),
                "opt": convert.opt_state_to_numpy(self.opt_state)}

    def maybe_resume(self) -> bool:
        # the template carries shapes and dtypes only; the checkpoint is
        # copied into the live weights and state in place
        step, tree = self.mgr.restore_latest({
            "params": convert.template_tree(
                dict(self.params.named_parameters())),
            "opt": convert.opt_state_template(self.opt_state)})
        if step is None:
            return False
        convert.load_params_(self.params, tree["params"])
        convert.load_opt_state_(self.opt_state, tree["opt"])
        self.start_step = step
        return True

    def run(self) -> Dict[str, Any]:
        step = self.start_step
        while step < self.tcfg.total_steps:
            batch = self.make_batch(step)   # pure function of step: a
            # restarted run regenerates the identical stream (no loss/dup)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            step += 1
            if step % self.tcfg.log_every == 0 or step == 1:
                self.metrics_log.append(
                    {k: float(v) for k, v in metrics.items()} | {"step": step})
            if step % self.tcfg.ckpt_every == 0:
                self.mgr.save(step, self._tree())
            if self.failure_hook is not None:
                self.failure_hook(step)   # may raise SimulatedFailure
        self.mgr.wait()
        return {"final_step": step, "metrics": self.metrics_log}


class SimulatedFailure(RuntimeError):
    pass
