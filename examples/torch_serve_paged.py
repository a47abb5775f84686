"""Serving on the PyTorch port: batched generation over a DiLi-indexed
paged KV cache, with a live Move of the page index between decode steps.

``examples/serve_paged.py`` on ``repro_torch``: the (sequence, page) ->
slot index is migrated while decoding continues, and the greedy tokens
equal an undisturbed run's. Runs on the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_paged.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, ServingEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = get_smoke_config("qwen2.5-3b")
params = T.init_params(cfg, seed=0, device=args.device)
rng = np.random.default_rng(7)
prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
           for n in (12, 9, 15)]
N_NEW = 8


def generate(rebalance: bool):
    eng = ServingEngine(cfg, params, page_size=8, num_pages=128,
                        dili_shards=2, device=args.device)
    reqs = [Request(seq_id=i, prompt=p, max_new=N_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    for step in range(N_NEW):
        if rebalance and step == 2:
            subs = [e for e in eng.kv.backend.sublists(0) if e["owner"] == 0]
            if subs:
                eng.kv.backend.move(0, subs[0]["keymax"], 1)
                print("  [step 2] issued Move of the page-index sublist "
                      "shard0 -> shard1")
        eng.step(rebalance=rebalance)
    owners = sorted({e["owner"] for s in range(2)
                     for e in eng.kv.backend.sublists(s)})
    return [r.out for r in reqs], owners


print("run A: undisturbed decode")
out_a, _ = generate(rebalance=False)
print("run B: decode with live page-index migration")
out_b, owners = generate(rebalance=True)

for i, (a, b) in enumerate(zip(out_a, out_b)):
    status = "OK" if a == b else "MISMATCH"
    print(f"seq {i}: {a[:N_NEW]}  [{status}]")
assert out_a == out_b, "live migration changed the outputs!"
print(f"page-index owners after migration: shards {owners}")
print("outputs identical under live Split/Move. OK")
