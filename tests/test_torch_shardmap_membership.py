"""M8 of ``tests/test_membership.py``: the 3 → 5 → 2 schedule on the SPMD
backend under the lossy wire (capacity 6, seed 11, 150 ops,
``default_nemesis(0.1)``), through the reference's ``ShardMapBackend``
(6 XLA host devices, in a subprocess) and the port's on the CPU. Both
pass the harness's checks; the round traces (their ``mb`` lines
included), the fired events and the final membership view are equal.
"""
import importlib.util

import torch_spmd as W
from membership_harness import check

REF_CODE = """
import json
from membership_harness import run_membership_differential
from nemesis_harness import default_nemesis
res = run_membership_differential("shardmap", 11, default_nemesis(0.1),
                                  n_ops=150)
print(json.dumps(dict(trace=res["trace"], fired=res["fired"],
                      view=res["view"], rounds=res["rounds"],
                      final_keys=res["final_keys"],
                      mismatches=res["mismatches"],
                      net_stats=res["net_stats"])))
"""


def test_m8_replays_the_reference_trace():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", W.ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.core.net import NemesisConfig

    ref = W.run_reference(REF_CODE, devices=6)
    p = 0.1
    got = smoke.membership_differential(
        11, NemesisConfig(drop_prob=p, dup_prob=p, reorder_prob=p,
                          delay_prob=p / 2, delay_rounds=3),
        n_ops=150, backend="shardmap", device="cpu")
    check(got, "m8 seed=11")
    assert not ref["mismatches"]
    assert got["rounds"] == ref["rounds"] == 315
    assert len(got["trace"]) == len(ref["trace"])
    for i, (a, b) in enumerate(zip(ref["trace"], got["trace"])):
        assert a == b, f"line {i} differs:\n ref  {a}\n port {b}"
    assert [list(f) for f in got["fired"]] == ref["fired"] == [
        [77, "join", 3], [145, "join", 4], [179, "retire", 4],
        [216, "retire", 3], [253, "retire", 2]]
    assert got["view"] == ref["view"]
    assert got["view"]["active"] == [0, 1]
    assert got["final_keys"] == ref["final_keys"]
    assert dict(got["backend"].net.stats) == ref["net_stats"]
    assert any(" mb " in ln for ln in got["trace"])
