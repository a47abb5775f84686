"""The pre-pass's pointer walk with lanes that start done.

``batch_apply.round_prepass`` launches the ``hybrid_search`` kernel before
``traverse.probe_batch`` and hands the walk the lanes the kernel answered
as done from the start. Those lanes' walk outputs are replaced by the
kernel's window, so the round is bit-identical to the reference
(``tests/test_torch_round.py``) as long as every other lane walks exactly
as before. This holds that on a one-shard list with tombstones: outside
the mask the four outputs equal the unmasked walk's, inside it the lanes
come back ok and absent at their head, and the walk takes no more steps
(none when every lane is masked).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import refs
from repro_torch.core import traverse as TR
from repro_torch.core.ops import resolve_route
from repro_torch.core.sim import Cluster
from repro_torch.core.types import DiLiConfig, OP_INSERT, OP_REMOVE

CFG = DiLiConfig(num_shards=1, pool_capacity=1024, max_sublists=16,
                 max_ctrs=16, max_scan=1024, batch_size=32, mailbox_cap=128,
                 split_threshold=10_000)


@pytest.fixture(scope="module")
def walk_inputs():
    """A settled one-sublist list of 170 keys (30 removed) and 96 probe
    lanes: keys present, absent and past the last key."""
    rng = np.random.default_rng(4)
    keys = rng.choice(np.arange(1, 4000), 200, replace=False)
    cl = Cluster(CFG, device="cpu")
    cl.submit(0, [OP_INSERT] * len(keys), keys.tolist())
    cl.run_until_quiet(400)
    cl.submit(0, [OP_REMOVE] * 30, keys[:30].tolist())
    cl.run_until_quiet(400)
    state = cl.states[0]
    q = np.concatenate([rng.choice(keys, 48), rng.integers(0, 4100, 48)])
    key = torch.from_numpy(q.astype(np.int32))
    rt = resolve_route(state, key, torch.full_like(key, refs.NULL_REF), 0)
    return state, rt.head_idx, key


def _walk(state, head_idx, key, start_done=None):
    TR.probe_batch.steps = 0
    out = TR.probe_batch(state, head_idx, key, 0,
                         min(CFG.fast_scan_bound, CFG.max_scan),
                         start_done=start_done)
    return out, TR.probe_batch.steps


@pytest.mark.parametrize("masked", ["none", "random", "largest_keys", "all"])
def test_probe_batch_start_done_lanes(walk_inputs, masked):
    state, head_idx, key = walk_inputs
    full, full_steps = _walk(state, head_idx, key)
    n = key.shape[0]
    mask = {"none": torch.zeros(n, dtype=torch.bool),
            "random": torch.from_numpy(
                np.random.default_rng(1).random(n) < 0.5),
            "largest_keys": key > key.float().quantile(0.75).to(key.dtype),
            "all": torch.ones(n, dtype=torch.bool)}[masked]
    part, steps = _walk(state, head_idx, key, start_done=mask)
    for f, p in zip(full, part):
        assert torch.equal(f[~mask], p[~mask])
    assert bool(part.ok[mask].all()) and not bool(part.present[mask].any())
    assert torch.equal(part.left[mask], head_idx[mask])
    assert torch.equal(part.right[mask], head_idx[mask])
    assert full_steps > 0 and steps <= full_steps
    if masked == "none":
        assert steps == full_steps
    if masked == "largest_keys":      # the longest walks are left out
        assert steps < full_steps
    if masked == "all":
        assert steps == 0
