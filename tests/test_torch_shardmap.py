"""``ShardMapBackend`` of the port against the reference's.

``tests/test_client_api.py::PARITY_SCRIPT``'s workload (a load, a Split
and a Move by hand, 16 rounds of mixed ops through ``DiLiClient``) and a
scripted replicate / serve / drop run go through both packages'
``ShardMapBackend``: the reference once, on 4 XLA host devices in a
subprocess, the port here on the CPU. Results, key sets, stats and
rounds must be equal, and the replica run's stacked state digests equal
after every round. The port's ``LocalBackend`` and ``ShardMapBackend``
must agree with each other as the reference's do. A ``gpu`` test runs
the parity workload on the card.
"""
import pytest
import torch

import torch_spmd as W

REF_CODE = """
import json
import torch_spmd as W
P = W.pkg("jax")
cfg = P.types.DiLiConfig(**W.SCRIPT_CFG)
print(json.dumps(dict(
    parity=W.parity_run(P, P.api.ShardMapBackend(cfg)),
    local=W.parity_run(P, P.api.LocalBackend(cfg)),
    replica=W.replica_run(P))))
"""


@pytest.fixture(scope="module")
def reference():
    return W.run_reference(REF_CODE, devices=4)


def _cfg():
    from repro_torch.core.types import DiLiConfig
    return DiLiConfig(**W.SCRIPT_CFG)


def _run(kind, device="cpu"):
    from repro_torch import api
    return W.parity_run(W.pkg("torch"),
                        getattr(api, kind)(_cfg(), device=device))


def test_parity_script_matches_the_reference_shardmap(reference):
    got = _run("ShardMapBackend")
    ref = reference["parity"]
    assert got["results"] == ref["results"]
    assert got["keys"] == ref["keys"] == got["oracle"]
    assert got["stats"] == ref["stats"]
    assert got["rounds"] == ref["rounds"]
    # the reference's own parity: its Local and ShardMap runs agree
    assert reference["local"]["results"] == ref["results"]
    assert reference["local"]["keys"] == ref["keys"]


def test_local_and_shardmap_backends_agree():
    smap, local = _run("ShardMapBackend"), _run("LocalBackend")
    assert smap["oracle"] == local["oracle"]
    assert local["keys"] == local["oracle"], "local diverged"
    assert smap["keys"] == smap["oracle"], "shard_map diverged"
    assert smap["results"] == local["results"]
    assert len(smap["results"]) == 188 and len(smap["keys"]) == 68
    # the SPMD stats vector carries no fast-path lanes (the reference's
    # nine-lane layout), the Local backend's do
    assert smap["stats"]["fast_hits"] == smap["stats"]["mut_hits"] == 0
    assert smap["stats"]["move_hits"] == local["stats"]["move_hits"] > 0


def test_replica_run_matches_the_reference(reference):
    got = W.replica_run(W.pkg("torch"))
    ref = reference["replica"]
    assert got["ok"] == ref["ok"] == [True, True, True]
    assert got["rounds"] == ref["rounds"] == len(got["digests"])
    for r, (a, b) in enumerate(zip(ref["digests"], got["digests"])):
        assert a == b, f"round {r}: stacked state differs"
    assert [list(c) for c in got["comps"]] == ref["comps"]
    assert got["reads"] == ref["reads"]
    assert got["stats"] == ref["stats"]
    assert got["keys"] == ref["keys"]
    assert got["sets_after_drop"] == ref["sets_after_drop"] == {}
    assert got["rep_hits"] > 0


def test_cap_pair_below_mailbox_cap_raises():
    from repro_torch.api import ShardMapBackend
    with pytest.raises(ValueError, match="cap_pair"):
        ShardMapBackend(_cfg(), cap_pair=8, device="cpu")


def test_outbox_overflow_raises():
    from repro_torch.api import ShardMapBackend
    from repro_torch.core.sim import OutboxOverflow
    from repro_torch.core.types import OP_INSERT
    backend = ShardMapBackend(_cfg()._replace(mailbox_cap=4), device="cpu")
    # every op lands on shard 1, which does not own the key range and
    # delegates all eight in one round
    backend.submit(1, [OP_INSERT] * 8, list(range(10, 18)))
    with pytest.raises(OutboxOverflow, match="mailbox_cap=4"):
        backend.step()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs the SPMD round on the GPU")
    return "cuda"


@pytest.mark.gpu
def test_parity_script_on_the_card(cuda_device):
    smap = _run("ShardMapBackend", cuda_device)
    local = _run("LocalBackend", cuda_device)
    assert smap["results"] == local["results"]
    assert smap["keys"] == local["keys"] == smap["oracle"]
    assert smap["stats"] == _run("ShardMapBackend")["stats"]
