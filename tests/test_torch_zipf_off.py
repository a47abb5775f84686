"""``benchmarks/run.py::zipf`` at theta 0.99 with replication off, through
both packages on the CPU: the chip smoke's ``ZIPF_EXPECTED["off"]`` is
what the reference gives with the benchmark's own driver and what the
port gives with the smoke's driver (split from
``tests/test_torch_zipf.py`` so that the two run in parallel).
"""
import importlib.util
import pathlib

from torch_zipf import ref_zipf_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)


def test_zipf_replication_off_matches_reference_and_expected():
    ref = ref_zipf_run(SMOKE.ZIPF["theta"], False, SMOKE)
    got = SMOKE.zipf_run(False, device="cpu")
    want = SMOKE.ZIPF_EXPECTED["off"]
    assert {k: ref[k] for k in want} == want
    assert {k: got[k] for k in want} == want
    assert got["keys_match"] and ref["keys"] == got["backend"].all_keys()
    assert got["mismatches"] == ref["mismatches"]
    assert got["first_replicate"] is None and got["first_serve"] is None
