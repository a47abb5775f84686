"""The port's sharding rules (``repro_torch.runtime.sharding``) against
the reference's (``repro.runtime.sharding``).

- Parameter specs for every ``ARCH_IDS`` at full size on 16×16, 2×16×16,
  32×8 and 8×32: the port's per-layer weights carry the reference's
  stacked spec with its leading layer dim dropped, and the reference's
  stacked tree (a checkpoint's layout) carries it whole; each leaf's
  local shard on rank 0 of a fake-group mesh has the shape of the
  reference's ``NamedSharding.shard_shape`` on 512 XLA host devices.
- ``cache_specs`` for every family, with ``kv_quant`` and with
  ``seq_axis`` on and off, and ``batch_spec``, on meshes the reference
  sees as axis names and sizes.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_mesh import MESHES, norm, reference_layouts

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import production_mesh
from repro_torch.models import transformer as TT
from repro_torch.runtime import sharding as S


def _stacked_meta(model) -> dict:
    """The reference's stacked parameter tree, as meta tensors."""
    tree = convert.template_tree(dict(model.named_parameters()))

    def meta(x):
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        return torch.empty(x.shape, device="meta")
    return meta(tree)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_specs_and_local_shapes_equal_the_references(mesh_name):
    from torch.distributed.tensor import distribute_tensor
    ref = reference_layouts()["params"][mesh_name]
    multi_pod, model_size = MESHES[mesh_name]
    with production_mesh(multi_pod=multi_pod, model_size=model_size,
                         device_type="cpu") as mesh:
        for arch in ARCH_IDS:
            model = TT.init_params(get_config(arch), dtype=torch.bfloat16,
                                   device="meta")
            want = ref[arch]
            # per layer: the stacked spec without its layer dim
            for name, spec in S.param_specs(model, mesh).items():
                path, layer = convert._ref_path(name)
                shape, _, _, rspec = want["/".join(path)]
                nd = len(shape) - (layer is not None)
                assert norm(spec, nd) == rspec[len(rspec) - nd:], \
                    (arch, name)
            # the stacked tree: specs and rank 0's shard shapes
            tree = _stacked_meta(model)
            specs = dict(_paths(S.param_specs(tree, mesh)))
            assert set(specs) == set(want), arch
            for path, leaf in _paths(tree):
                shape, _, shard, rspec = want[path]
                assert list(leaf.shape) == shape, (arch, path)
                assert norm(specs[path], len(shape)) == rspec, (arch, path)
                local = distribute_tensor(
                    leaf, mesh, S.placements(specs[path], mesh)).to_local()
                assert list(local.shape) == shard, (arch, path)


def _stub_mesh(names, sizes):
    """What the reference's ``cache_specs``/``batch_spec`` read of a mesh,
    and what the port's read."""
    return SimpleNamespace(axis_names=names, devices=np.empty(sizes),
                           mesh_dim_names=names, shape=sizes)


_CACHE_MESHES = [(("data", "model"), (16, 16)),
                 (("pod", "data", "model"), (2, 16, 16)),
                 (("data", "model"), (32, 8))]


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("seq_axis", [False, True])
def test_cache_and_batch_specs_equal_the_references(kv_quant, seq_axis):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import transformer as JT
    from repro.runtime import sharding as JS
    for names, sizes in _CACHE_MESHES:
        mesh = _stub_mesh(names, sizes)
        assert norm(S.batch_spec(mesh), 2) == norm(
            tuple(JS.batch_spec(mesh)), 2)
        for arch in ARCH_IDS:
            cfg = get_config(arch).replace(kv_quant=kv_quant)
            rcfg = ref_config(arch).replace(kv_quant=kv_quant)
            rcache = jax.eval_shape(lambda: JT.init_cache(
                rcfg, 8, 1024, dtype=jnp.bfloat16))
            want = JS.cache_specs(rcache, mesh, seq_axis=seq_axis)
            cache = TT.init_cache(cfg, 8, 1024, dtype=torch.bfloat16,
                                  device="meta")
            got = S.cache_specs(cache, mesh, seq_axis=seq_axis)
            assert set(got) == set(want), arch
            for k, x in cache.items():
                assert list(x.shape) == list(rcache[k].shape), (arch, k)
                assert norm(got[k], x.dim()) == norm(tuple(want[k]),
                                                     x.dim()), (arch, k)


def test_placements_of_a_tuple_axis_shard_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    with production_mesh(multi_pod=True, device_type="cpu") as mesh:
        assert S.placements(S.P(("pod", "data"), None, "model"), mesh) == \
            [Shard(0), Shard(0), Shard(2)]
        assert S.placements(S.P(), mesh) == [Replicate()] * 3
        with pytest.raises(ValueError):
            S.placements(S.P("model", "model"), mesh)
