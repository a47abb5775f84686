"""The theta 0.5 and 0.9 rows of ``benchmarks/run.py::zipf`` with
replication on, through both packages on the CPU: the measured mix's
rounds and ``rep_hits`` are equal across the packages and to the rows
``BENCH_zipf.json`` recorded (56 rounds and 0 hits at 0.5, where the
balancer's ``hot_share`` gate keeps replication off; 34 rounds and 2,089
hits at 0.9), and so are the other counts, the results' digest, the
final keys and the ops on which both depart from the sequential oracle.
At 0.9 a REMOVE of a present key answers absent in both packages and the
key stays (ROADMAP Queue 3 item 5: a Move leaves the target's chain
unsorted); the test holds the two packages to the same departure.
"""
import importlib.util
import json
import pathlib

import pytest

from torch_zipf import ref_zipf_run

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)
ROWS = {r["metric"]: r["value"] for r in json.loads(
    (ROOT / "BENCH_zipf.json").read_text())["rows"]}


@pytest.mark.parametrize("theta", [0.5, 0.9])
def test_zipf_replication_on_row_matches_reference(theta):
    tlab = f"t{int(theta * 100):03d}"
    ref = ref_zipf_run(theta, True, SMOKE)
    got = SMOKE.zipf_run(True, theta=theta, device="cpu")
    for k in ("setup_rounds", "warm_rounds", "rounds", "rep_hits",
              "results"):
        assert got[k] == ref[k], k
    assert (got["rounds"], got["rep_hits"]) == \
        (ROWS[f"{tlab}_on_rounds"], ROWS[f"{tlab}_rep_hits"])
    assert ref["keys"] == got["backend"].all_keys()
    assert got["mismatches"] == ref["mismatches"]
    assert got["keys_match"] == (ref["keys"] == ref["oracle_keys"])
    if theta == 0.5:
        assert got["keys_match"] and not got["mismatches"]
        assert got["rep_hits"] == 0 and got["first_replicate"] is None
