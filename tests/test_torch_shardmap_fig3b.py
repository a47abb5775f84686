"""The chip smoke's ``[shardmap4]`` constant, reproduced on the CPU.

``chip_smoke.py`` runs fig3b's 4-server workload through the port's
``ShardMapBackend`` on the card and holds it to ``SHARDMAP4_EXPECTED``.
This test recomputes it from the reference's ``ShardMapBackend`` (4 XLA
host devices, in a subprocess; ``benchmarks/run.py``'s
``_bench_cfg(4, block_probe=True)``, ``_drive_backend`` and ``_settle``)
and from the port's on the CPU (the smoke's ``drive_backend`` and
``settle``), and checks that the two runs end with the same key set.
"""
import importlib.util

import torch_spmd as W

REF_CODE = """
import importlib.util, json
from repro.api import ShardMapBackend
from repro.core.balancer import Balancer
from repro.data import ycsb

def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

bench = load("benchmarks_run", "benchmarks/run.py")
smoke = load("chip_smoke", "chip_smoke.py")
backend = ShardMapBackend(bench._bench_cfg(4, block_probe=True))
bal = Balancer(backend)
load_kinds, load_keys = ycsb.load_phase(1500, 6000, seed=3)
kinds, keys = ycsb.mixed_phase(3000 * 4, 6000, 0.5, seed=4)
bench._drive_backend(backend, load_kinds, load_keys, 64, balancer=bal)
load_end = backend.stats["rounds"]
bench._settle(backend, bal)
settle_end = backend.stats["rounds"]
bench._drive_backend(backend, kinds, keys, 64, balancer=bal)
print(json.dumps(dict(counts=smoke.fig3b4_counts(backend, load_end,
                                                 settle_end),
                      keys=backend.all_keys(), stats=backend.stats)))
"""


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", W.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shardmap4_counts_equal_smoke_constant():
    smoke = _smoke()
    ref = W.run_reference(REF_CODE, devices=4)

    from repro_torch.api import ShardMapBackend
    from repro_torch.core.balancer import Balancer
    backend = ShardMapBackend(smoke.bench_cfg(num_shards=4), device="cpu")
    bal = Balancer(backend)
    (load_kinds, load_keys), (kinds, keys) = smoke.fig3b4_workload()
    log = []
    smoke.drive_backend(backend, load_kinds, load_keys, 64, balancer=bal,
                        log=log)
    load_end = backend.stats["rounds"]
    smoke.settle(backend, bal)
    settle_end = backend.stats["rounds"]
    smoke.drive_backend(backend, kinds, keys, 64, balancer=bal, log=log)
    got = smoke.fig3b4_counts(backend, load_end, settle_end)
    got_keys = backend.all_keys()
    smoke.check_against_results("shardmap4", log, got_keys)

    assert ref["counts"] == smoke.SHARDMAP4_EXPECTED
    assert got == smoke.SHARDMAP4_EXPECTED
    assert got_keys == ref["keys"]
    assert backend.stats == ref["stats"]
    # the routed round gives the Local backend's rounds and kernel hits
    assert {k: v for k, v in got.items()
            if k not in ("fast_hits", "mut_hits")} == \
        {k: v for k, v in smoke.FIG3B4_EXPECTED.items()
         if k not in ("fast_hits", "mut_hits")}
