"""Quickstart on the PyTorch port: the DiLi distributed list as a library.

``examples/quickstart.py`` on ``repro_torch``: a 4-server cluster behind
the futures-based ``DiLiClient``, a load phase, then a mixed workload
while the balancer Splits and Moves sublists, every result checked
against the sequential oracle. Runs on the GPU unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      (--smoke: a quarter of the keys and rounds)
"""
import argparse

import numpy as np

from repro_torch.api import DiLiClient, LocalBackend
from repro_torch.core.balancer import Balancer
from repro_torch.core.oracle import OracleList
from repro_torch.core.types import DiLiConfig, OP_FIND, OP_INSERT, OP_REMOVE

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--smoke", action="store_true")
args = ap.parse_args()
n_keys, rounds = (200, 5) if args.smoke else (800, 20)

cfg = DiLiConfig(num_shards=4, pool_capacity=8192, max_sublists=64,
                 max_ctrs=64, max_scan=8192, batch_size=32,
                 mailbox_cap=256, split_threshold=50, move_batch=16)
backend = LocalBackend(cfg, device=args.device)
client = DiLiClient(backend, balance=Balancer(backend))
oracle = OracleList()
rng = np.random.default_rng(0)

# ---- load phase (the client picks the serving shards)
keys = rng.permutation(np.arange(1, 5000))[:n_keys].tolist()
load = client.insert_batch(keys)
oracle.apply_batch([OP_INSERT] * len(keys), keys)
client.drain(run_balance=True)

# ---- mixed phase: ops race the balancer's Split/Move churn
checks = []
for round_i in range(rounds):
    kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], 32).tolist()
    ks = rng.integers(1, 5000, 32).tolist()
    checks.append((client.submit(kinds, ks), oracle.apply_batch(kinds, ks)))
    client.pump()      # one round; runs the balance policy at its cadence
client.settle()        # drain futures, run balance to a fixed point

# ---- verify
wrong = sum(f.result() != exp
            for batch, exps in checks for f, exp in zip(batch, exps))
assert wrong == 0, f"{wrong} ops violated linearizability"
assert all(load.results()), "load-phase inserts must all succeed"
assert client.all_keys() == sorted(oracle.snapshot())
loads = [sum(e["size"] or 0 for e in backend.sublists(s)
             if e["owner"] == s) for s in range(4)]
n_ops = sum(len(b) for b, _ in checks) + len(keys)
print(f"ops linearized correctly : {n_ops}")
print(f"final key count          : {len(oracle.snapshot())}")
print(f"keys per server          : {loads}")
owned = [sum(1 for e in backend.sublists(s) if e["owner"] == s)
         for s in range(4)]
print(f"sublists per server      : {owned}")
print(f"max delegation hops seen : {client.stats['max_hops']}")
print(f"stale-route corrections  : {client.wrong_routes}")
print("OK")
