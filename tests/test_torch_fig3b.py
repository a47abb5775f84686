"""The chip smoke's 4-server and Move constants, reproduced on the CPU.

``chip_smoke.py`` holds the port's fig3b 4-server run on the card against
``FIG3B4_EXPECTED`` (rounds of the load, settle and mix, hit counters, the
batched replay's ``move_hits``, the deepest delegation, keys per server)
and the Move rounds of ``benchmarks/run.py::rebalance`` part A against
``REBALANCE_EXPECTED``. This test recomputes both from the reference —
fig3b with ``benchmarks/run.py``'s own ``_bench_cfg(4, block_probe=True)``,
``_drive_backend`` (balancer every 4th round) and ``_settle`` — and from
the port on the CPU with the smoke's copies of those functions, and checks
that the two runs end with the same key set.
"""
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


def _fig3b4(backend, bal, drive, settle, workload):
    (load_kinds, load_keys), (kinds, keys) = workload
    drive(backend, load_kinds, load_keys, 64, balancer=bal)
    load_end = backend.stats["rounds"]
    settle(backend, bal)
    settle_end = backend.stats["rounds"]
    drive(backend, kinds, keys, 64, balancer=bal)
    return (SMOKE.fig3b4_counts(backend, load_end, settle_end),
            backend.all_keys())


def _reference_fig3b4():
    from repro.api import LocalBackend
    from repro.core.balancer import Balancer
    from repro.data import ycsb
    bench = _load("benchmarks_run", "benchmarks/run.py")
    backend = LocalBackend(bench._bench_cfg(4, block_probe=True))
    workload = (ycsb.load_phase(1500, 6000, seed=3),
                ycsb.mixed_phase(3000 * 4, 6000, 0.5, seed=4))
    return _fig3b4(backend, Balancer(backend), bench._drive_backend,
                   bench._settle, workload)


def _port_fig3b4():
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    backend = LocalBackend(SMOKE.bench_cfg(num_shards=4), device="cpu")
    log = []

    def drive(*a, **kw):
        SMOKE.drive_backend(*a, log=log, **kw)

    counts, keys = _fig3b4(backend, Balancer(backend), drive, SMOKE.settle,
                           SMOKE.fig3b4_workload())
    # the smoke's own check of the key set against the ops' results
    SMOKE.check_against_results("fig3b4", log, keys)
    return counts, keys


def test_fig3b4_counts_equal_smoke_constants():
    ref, ref_keys = _reference_fig3b4()
    got, got_keys = _port_fig3b4()
    assert ref == SMOKE.FIG3B4_EXPECTED
    assert got == SMOKE.FIG3B4_EXPECTED
    assert got_keys == ref_keys
    # non-vacuous: the balancer moved sublists onto every server
    assert all(n > 0 for n in got["owned"]) and got["move_hits"] > 0


@pytest.mark.parametrize("k", sorted(SMOKE.REBALANCE_EXPECTED))
def test_rebalance_move_rounds_equal_smoke_constants(k):
    import repro.core.sim as JSIM
    import repro.core.types as JT
    import repro_torch.core.sim as TSIM
    import repro_torch.core.types as TT
    ref = SMOKE.rebalance_move(JSIM.Cluster, JT.DiLiConfig, JT.OP_INSERT, k)
    got = SMOKE.rebalance_move(TSIM.Cluster, TT.DiLiConfig, TT.OP_INSERT, k,
                               device="cpu")
    for r in (ref, got):
        assert r["ok"] and r["keys_ok"]
        assert r["rounds"] == SMOKE.REBALANCE_EXPECTED[k]
    assert got["cluster"].stats == ref["cluster"].stats


def test_smoke_workload_is_the_benchmarks():
    import numpy as np
    from repro.data import ycsb as JY
    ref = (JY.load_phase(1500, 6000, seed=3),
           JY.mixed_phase(3000 * 4, 6000, 0.5, seed=4))
    for a, b in zip(ref, SMOKE.fig3b4_workload()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    bench = _load("benchmarks_run", "benchmarks/run.py")
    assert SMOKE.bench_cfg(num_shards=4)._asdict() == \
        bench._bench_cfg(4, block_probe=True)._asdict()
