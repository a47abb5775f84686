"""Serving launcher: batched requests through the paged DiLi engine.

``python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke --requests 4``

Runs on the GPU unless ``--device cpu``. The weights are random, drawn
from a fixed seed (no checkpoint is read). The engine attends through the
``paged_attention`` kernel (on a CPU device, its plain twin). With
``--rebalance`` the DiLi balancer runs between decode steps: it splits
the page index once a sublist outgrows its threshold and, over two or
more shards (``--dili-shards``), moves sublists between them. The paged
engine serves the dense text family; another ``--arch`` exits with the
engine's ``ValueError`` before any weights are made (ROADMAP Queue 3
item 6).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get_config, get_smoke_config
from ..models import transformer as T
from ..serving.engine import Request, ServingEngine, check_servable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--dili-shards", type=int, default=2)
    ap.add_argument("--rebalance", action="store_true",
                    help="run the DiLi load balancer between decode steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_servable(cfg)
    params = T.init_params(cfg, seed=0, device=args.device)
    eng = ServingEngine(cfg, params, page_size=args.page_size,
                        num_pages=256, max_batch=args.requests,
                        dili_shards=args.dili_shards, use_kernel=True,
                        device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(seq_id=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.admit(r)
        print(f"admitted seq {r.seq_id} ({len(r.prompt)} prompt tokens)")

    step = 0
    while any(not r.done for r in reqs):
        eng.step(rebalance=args.rebalance and step % 2 == 1)
        step += 1
    for r in reqs:
        print(f"seq {r.seq_id}: generated {r.out}")
    print(f"page-table sublists per shard: "
          f"{[len(eng.kv.backend.sublists(s)) for s in range(eng.kv.backend.n)]}")


if __name__ == "__main__":
    main()
