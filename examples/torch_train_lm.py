"""Training on the PyTorch port: a dense LM through the whole stack
(config -> data -> train step -> checkpointing -> resume).

``examples/train_lm.py`` on ``repro_torch``: Qwen2-0.5B at full width cut
to 4 layers and a 32k vocabulary (~100M parameters), batch 8 x 256, on
the GPU unless ``--device cpu``. ``--mesh host`` lays the weights, the
AdamW state and the batch out over this host's devices (a one-rank NCCL
group on one card, gloo on the CPU) and trains through
``build_train_step(mesh=)``. ``--smoke`` takes the reduced config.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
          [--device cpu] [--mesh host] [--smoke]
"""
import argparse
import contextlib
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import make_train_batch
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ShapeCell
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.train import Trainer, TrainerConfig, build_train_step

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--device", default="cuda")
ap.add_argument("--mesh", choices=["none", "host"], default="none")
ap.add_argument("--smoke", action="store_true")
ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
args = ap.parse_args()

if args.smoke:
    cfg = get_smoke_config("qwen2-0.5b")
    cell = ShapeCell("example", "train", 64, 2)
else:   # ~100M params: qwen2-0.5b scaled down in depth, full width
    cfg = get_config("qwen2-0.5b").replace(n_layers=4, vocab=32768,
                                           loss_chunk=128)
    cell = ShapeCell("example", "train", 256, 8)
opt = AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 15, 1),
                  total_steps=args.steps)
n_params = sum(p.numel() for p in T.init_params(
    cfg, device="meta").parameters())
print(f"model: {cfg.name}-deep{cfg.n_layers}  params={n_params/1e6:.1f}M  "
      f"tokens/step={cell.global_batch * cell.seq_len}  mesh={args.mesh}")


def batch(step):
    return make_train_batch(cfg, cell, seed=0, step=step,
                            dtype=torch.float32, device=args.device)


with (host_mesh(args.device) if args.mesh == "host"
      else contextlib.nullcontext()) as mesh:
    t0 = time.time()
    if mesh is None:
        tr = Trainer(cfg, cell, opt,
                     TrainerConfig(total_steps=args.steps, ckpt_every=100,
                                   ckpt_dir=args.ckpt_dir, log_every=20),
                     make_batch=batch, device=args.device)
        if tr.maybe_resume():
            print(f"resumed from checkpoint at step {tr.start_step}")
        out = tr.run()
        metrics, steps_done = out["metrics"], out["final_step"] - tr.start_step
    else:
        step_fn = build_train_step(cfg, opt, mesh)
        params = T.init_params(cfg, device=args.device)
        state = adamw_init(params)
        metrics = []
        for s in range(args.steps):
            params, state, m = step_fn(params, state, batch(s))
            if (s + 1) % 20 == 0 or s == 0:
                metrics.append({k: float(v) for k, v in m.items()}
                               | {"step": s + 1})
        steps_done = args.steps
    dt = time.time() - t0

for m in metrics:
    print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
          f"grad_norm {m['grad_norm']:.3f}  lr {m['lr']:.2e}")
if steps_done:
    tok_s = steps_done * cell.global_batch * cell.seq_len / dt
    print(f"throughput: {tok_s:,.0f} tokens/s over {steps_done} steps")
first, last = metrics[0]["loss"], metrics[-1]["loss"]
assert last < first, "loss did not decrease"
print(f"loss {first:.3f} -> {last:.3f}  OK")
