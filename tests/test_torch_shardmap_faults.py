"""The SPMD backend's host-routed round under the nemesis, held to the
reference's round traces.

``tests/nemesis_harness.py::run_differential`` on the reference's
``ShardMapBackend`` (4 XLA host devices, one subprocess) and
``chip_smoke.nemesis_differential(backend="shardmap")`` on the port's,
on the CPU, for: N5 (``tests/test_nemesis.py``, seeds 11 and 12, 200
ops, ``default_nemesis(0.15)``), the crash schedule of
``tests/test_durability.py``'s ShardMap differential (seed 31, 150 ops,
server 1 down rounds 40-80; the port runs it twice) and the RANGE
differential of ``tests/test_range_scan.py`` (a scan every 3 batches,
seed 31, 200 ops). Both pass the harness's checks and the traces are
equal line for line; the smoke's ``SHARDMAP_NEMESIS_DIGEST`` and
``SHARDMAP_CRASH_DIGEST`` are recomputed here.
"""
import importlib.util

import pytest

import torch_spmd as W
from nemesis_harness import check

REF_CODE = """
import json
from nemesis_harness import default_nemesis, run_differential
from repro.core.net import NemesisConfig
from repro.core.net.digest import trace_digest

CRASH = {"drop_prob": 0.05, "dup_prob": 0.05, "reorder_prob": 0.05,
         "crashes": [[1, 40, 80]]}
RUNS = {"n5-11": (11, default_nemesis(), 200, 0),
        "n5-12": (12, default_nemesis(), 200, 0),
        "crash": (31, NemesisConfig.from_dict(CRASH), 150, 0),
        "range": (31, default_nemesis(), 200, 3)}
out = {}
for name, (seed, nem, n_ops, scan_every) in RUNS.items():
    res = run_differential("shardmap", seed, nem, n_ops=n_ops,
                           scan_every=scan_every)
    out[name] = dict(trace=res["trace"], digest=trace_digest(res["trace"]),
                     final_keys=res["final_keys"], rounds=res["rounds"],
                     net_stats=res["net_stats"],
                     nemesis_stats=res["nemesis_stats"],
                     n_scans=res["n_scans"], mismatches=res["mismatches"])
print(json.dumps(out))
"""

CRASH = {"drop_prob": 0.05, "dup_prob": 0.05, "reorder_prob": 0.05,
         "crashes": [[1, 40, 80]]}


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", W.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(scope="module")
def reference():
    return W.run_reference(REF_CODE, devices=4)


def _port(seed, config, n_ops, scan_every=0):
    from repro_torch.core.net import NemesisConfig
    return SMOKE.nemesis_differential(
        seed, NemesisConfig.from_dict(config), n_ops=n_ops,
        scan_every=scan_every, backend="shardmap", device="cpu")


def _same(ref, got, what):
    from repro_torch.core.net import trace_digest
    check(got, what)
    assert not ref["mismatches"]
    assert got["rounds"] == ref["rounds"]
    assert len(got["trace"]) == len(ref["trace"])
    for i, (a, b) in enumerate(zip(ref["trace"], got["trace"])):
        assert a == b, f"{what}: round {i} differs:\n ref  {a}\n port {b}"
    assert trace_digest(got["trace"]) == ref["digest"]
    assert got["final_keys"] == ref["final_keys"]
    assert got["net_stats"] == ref["net_stats"]
    assert got["nemesis_stats"] == ref["nemesis_stats"]
    assert got["net_stats"]["sent"] > 0, "the wire was never exercised"


@pytest.mark.parametrize("seed", [11, 12])
def test_n5_replays_the_reference_trace(reference, seed):
    e = SMOKE.SHARDMAP_NEMESIS
    got = _port(seed, e["config"], e["n_ops"])
    _same(reference[f"n5-{seed}"], got, f"n5 seed={seed}")
    if seed == e["seed"]:
        assert reference["n5-11"]["digest"] == SMOKE.SHARDMAP_NEMESIS_DIGEST


def test_crash_schedule_replays_byte_identically(reference):
    e = SMOKE.SHARDMAP_CRASH
    assert e["config"] == CRASH and (e["seed"], e["n_ops"]) == (31, 150)
    runs = [_port(e["seed"], e["config"], e["n_ops"]) for _ in range(2)]
    assert runs[0]["trace"] == runs[1]["trace"]
    for got in runs:
        _same(reference["crash"], got, "crash seed=31")
        dur = got["backend"].durability
        assert dur.stats["recoveries"] == 1
        assert dur.stats["replayed_rounds"] > 0
    trace = runs[0]["trace"]
    assert any("mb crash s1" in ln for ln in trace)
    assert any("mb restart s1" in ln for ln in trace)
    assert reference["crash"]["digest"] == SMOKE.SHARDMAP_CRASH_DIGEST


def test_range_differential_replays_the_reference_trace(reference):
    e = SMOKE.SHARDMAP_NEMESIS
    got = _port(31, e["config"], 200, scan_every=3)
    _same(reference["range"], got, "range seed=31")
    assert got["n_scans"] == reference["range"]["n_scans"] > 0
    assert got["backend"].stats["range_hits"] >= 0
