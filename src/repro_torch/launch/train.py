"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs a training run through the port's whole stack — config, synthetic
data pipeline, train step, checkpointing, resume — on the GPU unless
``--device cpu``, for any ``--arch`` of ``configs.ARCH_IDS`` (the logged
metrics include the MoE losses ``moe_aux`` and ``moe_z``). The weights
are random, drawn from a fixed seed. ``--smoke`` takes the reduced
config (CPU-runnable).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config, get_smoke_config
from ..data.synthetic import make_train_batch
from ..models.config import ShapeCell
from ..optim import AdamWConfig
from ..runtime.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", "train", args.seq, args.batch)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)

    def mk(step):
        return make_train_batch(cfg, cell, seed=0, step=step,
                                dtype=torch.float32, device=args.device)

    tr = Trainer(cfg, cell, opt_cfg,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir, log_every=10),
                 make_batch=mk, device=args.device)
    if args.resume and tr.maybe_resume():
        print(f"resumed from step {tr.start_step}")
    out = tr.run()
    for m in out["metrics"]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in m.items()})
    print(f"done at step {out['final_step']}")


if __name__ == "__main__":
    main()
