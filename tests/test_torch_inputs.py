"""The port's ``launch/inputs.py`` against the reference's on 2×16×16:
for every ``ARCH_IDS × cells_for`` cell, every argument of the step
(the parameters — per layer in the port, the reference's stacked leaf
without its layer dim —, the AdamW state, the batch, the cache and its
lengths) has the reference's shape, dtype and rank-0 shard shape, and
``activation_roles`` binds the reference's roles to its specs; the port's
own roles (``dtensor_specs``) come on top. ``init_params(device="meta")``
makes every family's model with no draw."""
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_mesh import norm, reference_layouts

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import inputs as I
from repro_torch.launch.dryrun import cells_for
from repro_torch.launch.mesh import production_mesh
from repro_torch.models import transformer as TT
from repro_torch.runtime import sharding as S


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _leaves(kind, args, pl, mesh):
    """{reference path: (shape, dtype, local shape)}; a per-layer
    parameter (and its moments) keyed by its stacked path, layer 0."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, placements):
        local = distribute_tensor(x, mesh, placements).to_local()
        return list(x.shape), _dtype(x), list(local.shape)

    out = {}

    def params(prefix, named, shard):
        for n, t in named.items():
            path, layer = convert._ref_path(n)
            if layer in (None, 0):
                out[prefix + "/".join(path)] = one(t, shard[n])

    params("0/", dict(args[0].named_parameters()), pl[0])
    if kind == "train":
        opt, batch = args[1], args[2]
        for m in ("mu", "nu"):
            params(f"1/{m}/", opt[m], pl[1][m])
        out["1/step"] = one(opt["step"], pl[1]["step"])
        for k, v in batch.items():
            out[f"2/{k}"] = one(v, pl[2][k])
    else:
        for i, tree in ((1, args[1]), (2, args[2])):
            for k, v in tree.items():
                out[f"{i}/{k}"] = one(v, pl[i][k])
        out["3"] = one(args[3], pl[3])
    return out


def _cells():
    return [(a, c.name) for a in ARCH_IDS for c in cells_for(get_config(a))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_roles_equal_the_references(arch):
    from repro_torch.models.config import shape_by_name
    ref = reference_layouts()
    with production_mesh(multi_pod=True, device_type="cpu") as mesh:
        cfg = get_config(arch)
        for cell in cells_for(cfg):
            key = f"{arch}/{cell.name}"
            rkind, want = ref["inputs"][key]
            kind, args, pl = I.input_specs(cfg, shape_by_name(cell.name),
                                           mesh)
            assert kind == rkind, key
            got = _leaves(kind, args, pl, mesh)
            stacked = {p for p in want if "blocks/" in p}
            assert set(got) == set(want), (key, set(got) ^ set(want))
            for path, (shape, dtype, local) in got.items():
                rshape, rdtype, rlocal, _ = want[path]
                if path in stacked:          # drop the layer dim
                    rshape, rlocal = rshape[1:], rlocal[1:]
                assert (shape, dtype, local) == (rshape, rdtype, rlocal), \
                    (key, path)
            rroles = ref["roles"][key]
            specs = I.activation_specs(cfg, cell, mesh)
            assert {r: norm(s, len(rroles[r])) for r, s in specs.items()} \
                == rroles, key
            roles = I.activation_roles(cfg, cell, mesh)
            assert set(roles) == set(rroles) | set(
                I.dtensor_specs(cfg, cell, mesh)), key
            for r, s in specs.items():
                assert roles[r] == (mesh, S.placements(s, mesh)), (key, r)


def test_init_params_on_meta_draws_nothing():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = TT.init_params(cfg, dtype=torch.bfloat16, device="meta")
        assert all(p.is_meta for p in model.parameters()), arch
        n = sum(p.numel() for p in model.parameters())
        assert n == sum(p.numel() for p in TT.LM(
            cfg, dtype=torch.bfloat16, device="meta").parameters()), arch
