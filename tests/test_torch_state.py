"""State containers, registry operations and state conversion: the port
against the reference, bit for bit (canonical int32 views of ref lanes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bg as JB
from repro.core import blocks as JBL
from repro.core import registry as JR
from repro.core import types as JT
from repro.core.sim import Cluster as JCluster
from repro_torch import convert
from repro_torch.core import bg as TB
from repro_torch.core import blocks as TBL
from repro_torch.core import refs as TREFS
from repro_torch.core import registry as TR
from repro_torch.core import types as TT
from repro_torch.core.sim import Cluster as TCluster

from torch_parity import assert_trees_equal, digest

KW = dict(num_shards=2, pool_capacity=256, max_sublists=16, max_ctrs=16,
          max_scan=256, batch_size=8, mailbox_cap=32, block_cap=24)


@pytest.mark.parametrize("sid,bootstrap,peers", [(0, True, None),
                                                 (1, False, None),
                                                 (3, True, 0b1011)])
def test_init_shard_matches(sid, bootstrap, peers):
    ref = JT.init_shard(JT.DiLiConfig(**KW), sid, bootstrap=bootstrap,
                        key_lo=-50, key_hi=9000, peers_mask=peers)
    got = TT.init_shard(TT.DiLiConfig(**KW), sid, bootstrap=bootstrap,
                        key_lo=-50, key_hi=9000, peers_mask=peers,
                        device="cpu")
    assert_trees_equal(ref, got)
    assert digest(ref) == digest(got)
    assert_trees_equal(JB.init_bg_table(JT.DiLiConfig(**KW)),
                       TB.init_bg_table(TT.DiLiConfig(**KW), device="cpu"),
                       "bg")


def test_cluster_construction_matches():
    ref = JCluster(JT.DiLiConfig(**KW))
    got = TCluster(TT.DiLiConfig(**KW), device="cpu")
    assert got.in_cap == ref.in_cap
    assert digest(ref.states, ref.bgs) == digest(got.states, got.bgs)
    assert got.registry_entries(1) == ref.registry_entries(1)
    # the delay/balancer streams are spawned as in the reference
    assert got.rng.random() == ref.rng.random()
    assert got.balancer_rng.random() == ref.balancer_rng.random()


def _random_registry(rng, m, size):
    """A sorted registry of ``size`` contiguous entries (ST_KEY-padded),
    with random refs (mark bits included), as numpy columns."""
    cuts = np.sort(rng.choice(np.arange(-500, 500), size + 1, replace=False))
    keymin = np.full(m, JT.ST_KEY, np.int32)
    keymax = np.full(m, JT.ST_KEY, np.int32)
    keymin[:size] = cuts[:-1]
    keymax[:size] = cuts[1:]
    sh = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    st = rng.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 16, m).astype(np.int32)
    off = rng.integers(-3, 40, m).astype(np.int32)
    return keymin, keymax, sh, st, ctr, off, np.int32(size)


def _regs(cols):
    keymin, keymax, sh, st, ctr, off, size = cols
    ref = JT.Registry(*(jnp.asarray(c) for c in cols))
    got = TT.Registry(*(torch.from_numpy(np.asarray(c).view(np.int32)
                                         if np.asarray(c).dtype == np.uint32
                                         else np.array(c))
                        for c in cols))
    return ref, got


@pytest.mark.parametrize("seed", range(4))
def test_registry_ops_match(seed):
    rng = np.random.default_rng(seed)
    m = 16
    size = int(rng.integers(1, m - 1))
    ref, got = _regs(_random_registry(rng, m, size))

    keys = np.concatenate([np.asarray(ref.keymin[:size]),
                           np.asarray(ref.keymin[:size]) + 1,
                           np.asarray(ref.keymax[:size]),
                           rng.integers(-600, 600, 64),
                           [JT.KEY_MIN, JT.KEY_MAX]]).astype(np.int32)
    np.testing.assert_array_equal(
        TR.get_by_key(got, torch.from_numpy(keys)).numpy(),
        np.asarray(JR.get_by_key(ref, jnp.asarray(keys))))
    for k in keys[:20]:
        assert TR.lookup(got.keymin.numpy(), got.keymax.numpy(), size,
                         int(k)) == int(JR.get_by_key(ref, int(k)))

    # add an entry at a fresh keymin, then remove a random one
    taken = set(np.asarray(ref.keymin[:size]).tolist())
    new_min = int(rng.choice([k for k in range(-600, 600) if k not in taken]))
    sh_new = int(rng.integers(0, 2**32))
    a_ref = JR.add_entry(ref, new_min, new_min + 3, jnp.uint32(sh_new),
                         jnp.uint32(7), 5, 2)
    a_got = TR.add_entry(got, new_min, new_min + 3,
                         np.uint32(sh_new).view(np.int32).item(), 7, 5, 2)
    assert_trees_equal(a_ref, a_got, "add_entry")
    pos = int(rng.integers(0, size + 1))
    assert_trees_equal(JR.remove_entry(a_ref, pos),
                       TR.remove_entry(a_got, pos), "remove_entry")
    assert_trees_equal(JR.set_fields(ref, 2, keymax=77, offset=9),
                       TR.set_fields(got, 2, keymax=77, offset=9),
                       "set_fields")


@pytest.mark.parametrize("when", [True, False])
def test_invalidate_entry_matches(when):
    """Out-of-range entries (the reference's dropped writes) leave the
    valid bits alone; in-range ones clear exactly one bit when asked."""
    rng = np.random.default_rng(5)
    valid = rng.random(KW["max_sublists"]) < 0.7
    ref = JT.empty_blocks(JT.DiLiConfig(**KW))._replace(
        valid=jnp.asarray(valid))
    got = TT.empty_blocks(TT.DiLiConfig(**KW), "cpu")._replace(
        valid=torch.from_numpy(valid.copy()))
    for e in range(-2, KW["max_sublists"] + 2):
        assert_trees_equal(JBL.invalidate_entry(ref, e, when),
                           TBL.invalidate_entry(got, e, when), f"e={e}")


def _random_state(rng, cfg):
    """A reference ShardState with every leaf randomised (ref lanes over
    the whole uint32 range, so mark bits and high sids occur)."""
    st = JT.init_shard(cfg, 0, bootstrap=True)

    def rnd(x):
        a = np.asarray(x)
        if a.dtype == np.bool_:
            return jnp.asarray(rng.random(a.shape) < 0.5)
        if a.dtype == np.uint32:
            return jnp.asarray(rng.integers(0, 2**32, a.shape,
                                            dtype=np.uint64)
                               .astype(np.uint32))
        return jnp.asarray(rng.integers(-2**31, 2**31, a.shape,
                                        dtype=np.int64).astype(np.int32))

    import jax
    return jax.tree_util.tree_map(rnd, st)


def test_convert_round_trip():
    rng = np.random.default_rng(11)
    cfg = JT.DiLiConfig(**KW)
    ref = _random_state(rng, cfg)
    d0 = convert.shard_state_to_numpy(ref)
    port = convert.shard_state_from_numpy(d0, device="cpu")
    assert_trees_equal(ref, port, "from_numpy")
    d1 = convert.shard_state_to_numpy(port)
    ref_leaves = convert.to_numpy(ref)

    def flat(d, p=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{p}.{k}")
            else:
                yield f"{p}.{k}", v

    a, b = dict(flat(ref_leaves)), dict(flat(d1))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    bg = JB.init_bg_table(cfg)._replace(
        phase=jnp.asarray([1, 2], jnp.int32),
        sh_star=jnp.asarray([2**31 + 5, 7], jnp.uint32))
    bg_port = convert.bg_table_from_numpy(convert.bg_table_to_numpy(bg),
                                          device="cpu")
    assert_trees_equal(bg, bg_port, "bg")
    assert TREFS.ref_mark(bg_port.sh_star).tolist() == [True, False]


def test_convert_rejects_missing_fields():
    d = convert.shard_state_to_numpy(TT.init_shard(TT.DiLiConfig(**KW), 0,
                                                   device="cpu"))
    del d["pool"]["nxt"]
    with pytest.raises(KeyError):
        convert.shard_state_from_numpy(d, device="cpu")
