"""Shared pieces of the mesh-layer parity tests
(``tests/test_torch_{sharding,inputs}.py``).

The reference lays its specs over 512 XLA host devices, a count fixed
before JAX loads, so ``reference_layouts()`` runs it once per test
process in a subprocess (``torch_spmd.run_reference``) and returns, as
JSON: every parameter leaf's spec and shard shape for every ``ARCH_IDS``
on four meshes, and every ``input_specs`` argument leaf (shape, dtype,
shard shape) and ``activation_roles`` spec for every ``ARCH_IDS ×
cells_for`` on 2×16×16. The port builds the same meshes over a fake
process group in the test process (``production_mesh``).
"""
from __future__ import annotations

import functools

from torch_spmd import run_reference

# mesh name -> (multi_pod, model_size)
MESHES = {"16x16": (False, 16), "2x16x16": (True, 16), "32x8": (False, 8),
          "8x32": (False, 32)}

REF = r"""
import json
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from repro.configs import ARCH_IDS, get_config
from repro.launch.dryrun import cells_for
from repro.launch.inputs import activation_roles, input_specs
from repro.launch.mesh import make_production_mesh
from repro.models import transformer as T
from repro.runtime.sharding import _leaf_path, param_specs

MESHES = %r


def spec(s, nd):
    s = list(s) + [None] * (nd - len(s))
    return [list(a) if isinstance(a, tuple) else a for a in s]


def leaves(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shd = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {_leaf_path(p): [list(x.shape), str(x.dtype),
                            list(s.shard_shape(x.shape)),
                            spec(s.spec, len(x.shape))]
            for (p, x), s in zip(flat, shd)}


out = {"params": {}, "inputs": {}, "roles": {}}
for name, (mp, ms) in MESHES.items():
    mesh = make_production_mesh(multi_pod=mp, model_size=ms)
    out["params"][name] = {}
    for a in ARCH_IDS:
        cfg = get_config(a)
        params = jax.eval_shape(lambda: T.init_params(
            cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
        specs = param_specs(params, mesh)
        out["params"][name][a] = leaves(params, jax.tree_util.tree_map(
            lambda s: NamedSharding(mesh, s), specs))
mesh = make_production_mesh(multi_pod=True)
for a in ARCH_IDS:
    cfg = get_config(a)
    for cell in cells_for(cfg):
        kind, args, shardings = input_specs(cfg, cell, mesh)
        out["inputs"][f"{a}/{cell.name}"] = [kind, leaves(args, shardings)]
        out["roles"][f"{a}/{cell.name}"] = {
            r: spec(s.spec, len(s.spec))
            for r, s in activation_roles(cfg, cell, mesh).items()}
print(json.dumps(out))
""" % (MESHES,)


@functools.lru_cache(maxsize=None)
def reference_layouts() -> dict:
    return run_reference(REF, 512)


def norm(spec, ndim: int) -> list:
    """A spec as the reference's JSON lists it: one entry per dim."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return [list(a) if isinstance(a, tuple) else a for a in spec]
