"""The port's SPMD round (``repro_torch.core.distributed``) against the
reference's (``repro.core.distributed``).

``bucket_by_dst`` is compared in this process on random outboxes, its
overflow and clip cases included. ``make_dili_round`` (the Local
exchange) and ``make_dili_round_hostroute`` run
``tests/test_distributed.py::SCRIPT``'s workload (4 shards, cap_pair 16,
38 rounds) in both packages: the reference once, on 4 XLA host devices
in a subprocess, the port here on the CPU. All nine outputs of every
round must be equal (a digest of each), and every op must answer as the
sequential oracle does.
"""
import numpy as np
import pytest
import torch

import torch_spmd as W
from repro_torch.core import messages as TM
from repro_torch.core.distributed import bucket_by_dst

REF_CODE = """
import json
import torch_spmd as W
P = W.pkg("jax")
print(json.dumps(dict(routed=W.routed_run(P), hostroute=W.hostroute_run(P))))
"""


@pytest.fixture(scope="module")
def reference():
    return W.run_reference(REF_CODE, devices=4)


def _outbox(rng, num_shards, cap):
    """Random rows: a quarter MSG_NONE, destinations skewed to shard 0
    and partly out of range, lanes anywhere in int32."""
    rows = rng.integers(-2**31, 2**31 - 1, (cap, TM.FIELDS),
                        dtype=np.int64).astype(np.int32)
    rows[:, TM.F_KIND] = rng.integers(1, TM.N_KINDS, cap)
    rows[rng.random(cap) < 0.25, TM.F_KIND] = TM.MSG_NONE
    dst = rng.integers(-2, num_shards + 2, cap)
    dst[rng.random(cap) < 0.4] = 0
    rows[:, TM.F_DST] = dst
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_bucket_by_dst_matches_reference(num_shards, seed):
    import jax.numpy as jnp
    from repro.core.distributed import bucket_by_dst as ref_bucket

    rng = np.random.default_rng(100 * num_shards + seed)
    cap, cap_pair = 64, 8
    rows = _outbox(rng, num_shards, cap)
    for count in (cap, cap - 9, cap + 5, 3):
        want_b, want_c = ref_bucket(jnp.asarray(rows), jnp.int32(count),
                                    num_shards, cap_pair)
        got_b, got_c = bucket_by_dst(torch.from_numpy(rows), count,
                                     num_shards, cap_pair)
        assert got_b.dtype == torch.int32 and got_c.dtype == torch.int32
        np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        if count >= cap - 9:
            # non-vacuous: some destination overflowed its cap_pair rows
            assert int(np.asarray(want_c).max()) > cap_pair


def test_bucket_by_dst_takes_a_tensor_count():
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(_outbox(rng, 4, 32))
    a = bucket_by_dst(rows, 20, 4, 4)
    b = bucket_by_dst(rows, torch.tensor(20, dtype=torch.int32), 4, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _compare_rounds(ref, got, what):
    assert len(got) == len(ref) == W.ROUNDS
    names = ("states+bgs", "inbox", "comp_slot", "comp_val", "comp_src",
             "comp_key", "stats", "ent_hits")
    for r, (a, b) in enumerate(zip(ref, got)):
        for name, x, y in zip(names, a, b):
            assert x == y, f"{what}: round {r}, output {name} differs"


def _check_oracle(run):
    missing = [k for k in run["expected"] if k not in run["results"]]
    assert not missing, f"ops never completed: {missing[:10]}"
    bad = {k: (run["results"][k], e) for k, e in run["expected"].items()
           if bool(run["results"][k]) != e}
    assert not bad, f"mismatches: {dict(list(bad.items())[:5])}"


def test_make_dili_round_matches_reference_every_round(reference):
    got = W.routed_run(W.pkg("torch"))
    _compare_rounds(reference["routed"]["rounds"], got["rounds"], "routed")
    assert got["results"] == reference["routed"]["results"]


def test_make_dili_round_matches_the_oracle(reference):
    _check_oracle(reference["routed"])
    _check_oracle(W.routed_run(W.pkg("torch")))


def test_hostroute_round_matches_reference_every_round(reference):
    got = W.hostroute_run(W.pkg("torch"))
    _compare_rounds(reference["hostroute"]["rounds"], got["rounds"],
                    "hostroute")
    assert got["results"] == reference["hostroute"]["results"]
    _check_oracle(got)


def test_stack_and_unstack_are_inverse():
    from repro_torch.core.distributed import stack_states, unstack_states
    from repro_torch.core.sim import Cluster
    from repro_torch.core.types import DiLiConfig
    from torch_parity import assert_trees_equal

    cl = Cluster(DiLiConfig(**W.SCRIPT_CFG), device="cpu")
    st, bg = stack_states(cl.states, cl.bgs)
    assert st.pool.key.shape == (4, W.SCRIPT_CFG["pool_capacity"])
    states, bgs = unstack_states(st, bg)
    for s in range(4):
        assert_trees_equal(cl.states[s], states[s])
        assert_trees_equal(cl.bgs[s], bgs[s])
