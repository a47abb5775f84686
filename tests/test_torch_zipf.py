"""``benchmarks/run.py::zipf`` at theta 0.99 with replication on, through
both packages on the CPU: the chip smoke's ``ZIPF_EXPECTED["on"]``
(rounds of load + settle, warm and measured mix, the measured mix's
``rep_hits`` and the digest of every op's result) is what the reference
gives with the benchmark's own driver and what the port gives with the
smoke's driver, and the two end with the same keys. The smoke's
configuration and sizes are the benchmark's. Replication off:
``tests/test_torch_zipf_off.py``; the theta 0.5 and 0.9 rows:
``tests/test_torch_zipf_rows.py``.
"""
import importlib.util
import inspect
import pathlib

import benchmarks.run as BR
from torch_zipf import bench_cfg_for, ref_zipf_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def test_smoke_zipf_config_is_the_benchmarks():
    defaults = {k: v.default for k, v in
                inspect.signature(BR.zipf).parameters.items()}
    assert defaults == {k: SMOKE.ZIPF[k]
                        for k in ("n_load", "n_ops", "key_space")}
    for on in (True, False):
        assert SMOKE.zipf_cfg(on)._asdict() == bench_cfg_for(on)._asdict()


def test_zipf_replication_on_matches_reference_and_expected():
    ref = ref_zipf_run(SMOKE.ZIPF["theta"], True, SMOKE)
    got = SMOKE.zipf_run(True, device="cpu")
    want = SMOKE.ZIPF_EXPECTED["on"]
    assert {k: ref[k] for k in want} == want
    assert {k: got[k] for k in want} == want
    assert got["keys_match"] and ref["keys"] == got["backend"].all_keys()
    assert got["mismatches"] == ref["mismatches"]
    assert got["first_replicate"] < got["first_serve"]
