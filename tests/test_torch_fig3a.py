"""The chip smoke's fig3a counts, reproduced on the CPU.

``chip_smoke.py`` holds the port's fig3a r50 run on the card against
``FIG3A_EXPECTED`` and its r10 run (the write-intensive mix, the DiLi side
of ``dili_over_skip_r10``) against ``FIG3A_R10_EXPECTED``: rounds,
fast/mut/blk hits, sublists and keys. This test
recomputes those numbers from the reference with ``benchmarks/run.py``'s
own driver and config (``_bench_cfg(1, block_probe=True)``,
``_drive_backend`` with the balancer every 4th round, ``_settle``), and from
the port on the CPU with the smoke's copy of that driver, so the constant
in the smoke is checked against both packages. The port's run also
counts the steps of the pre-pass's pointer walk, the smoke's
``FIG3A_WALK_STEPS``.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load("chip_smoke", "chip_smoke.py")


def _fig3a_counts(backend, bal, drive, settle, ycsb, read_pct):
    load_kinds, load_keys = ycsb.load_phase(2000, 8000, seed=1)
    kinds, keys = ycsb.mixed_phase(4000, 8000, read_pct / 100, seed=2)
    drive(backend, load_kinds, load_keys, 64, balancer=bal)
    load_rounds = backend.stats["rounds"]
    settle(backend, bal)
    settle_rounds = backend.stats["rounds"]
    drive(backend, kinds, keys, 64, balancer=bal)
    st = backend.stats
    return dict(rounds=st["rounds"], load_rounds=load_rounds,
                settle_rounds=settle_rounds, fast_hits=st["fast_hits"],
                mut_hits=st["mut_hits"], blk_hits=st["blk_hits"],
                sublists=sum(1 for e in backend.sublists(0)
                             if e["owner"] == 0),
                keys=len(backend.all_keys()))


def _reference(read_pct):
    from repro.api import LocalBackend
    from repro.core.balancer import Balancer
    from repro.data import ycsb
    bench = _load("benchmarks_run", "benchmarks/run.py")
    backend = LocalBackend(bench._bench_cfg(1, block_probe=True))
    return _fig3a_counts(backend, Balancer(backend), bench._drive_backend,
                         bench._settle, ycsb, read_pct)


def _port(read_pct):
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.traverse import probe_batch
    from repro_torch.data import ycsb
    backend = LocalBackend(SMOKE.bench_cfg(), device="cpu")
    probe_batch.steps = 0
    counts = _fig3a_counts(backend, Balancer(backend), SMOKE.drive_backend,
                           SMOKE.settle, ycsb, read_pct)
    # the smoke's walk-step count: lanes the kernel answers skip the walk
    if read_pct == 50:
        assert probe_batch.steps == SMOKE.FIG3A_WALK_STEPS
    return counts


@pytest.mark.parametrize("run", [_reference, _port],
                         ids=["reference", "port_cpu"])
def test_fig3a_counts_equal_smoke_constants(run):
    assert run(50) == SMOKE.FIG3A_EXPECTED


@pytest.mark.parametrize("run", [_reference, _port],
                         ids=["reference", "port_cpu"])
def test_fig3a_r10_counts_equal_smoke_constants(run):
    assert run(10) == SMOKE.FIG3A_R10_EXPECTED


def test_smoke_config_is_the_benchmarks():
    from repro_torch.core.types import DiLiConfig as TCfg
    bench = _load("benchmarks_run", "benchmarks/run.py")
    ref = bench._bench_cfg(1, block_probe=True)
    got = SMOKE.bench_cfg()
    assert isinstance(got, TCfg)
    assert got._asdict() == ref._asdict()
    # and the smoke's workload is the benchmark's: same generator output
    from repro.data import ycsb as JY
    from repro_torch.data import ycsb as TY
    for a, b in zip(JY.load_phase(2000, 8000, seed=1)
                    + JY.mixed_phase(4000, 8000, 0.5, seed=2),
                    TY.load_phase(2000, 8000, seed=1)
                    + TY.mixed_phase(4000, 8000, 0.5, seed=2)):
        np.testing.assert_array_equal(a, b)
