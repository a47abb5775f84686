"""Worker of ``tests/test_torch_mesh_train.py``'s elastic restore: one
rank of four on a 2×2 ("data", "model") gloo mesh, spawned by
``torch.multiprocessing``. It restores ``<dir>/elastic.npz`` (written by
the reference) with the rules' placements and checks every leaf against
``<dir>/want.npz`` (the reference's own restore) bit for bit: its local
shard, and its full tensor."""
import os

import numpy as np
import torch


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def elastic_worker(rank: int, port: int, root: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint import restore_pytree
    from repro_torch.runtime import sharding as S

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        want = dict(np.load(os.path.join(root, "want.npz")))
        template = {}
        for key, arr in want.items():
            S._set(template, key, torch.empty(arr.shape,
                                              dtype=torch.float32))
        shardings = _on_mesh(S.param_shardings(template, mesh), mesh)
        tree = restore_pytree(template, os.path.join(root, "elastic.npz"),
                              shardings)
        wq = tree["blocks"]["attn"]["wq"]
        assert all(p != Replicate() for p in wq.placements), wq.placements
        for key, t in _paths(tree):
            full = t.full_tensor().numpy()
            assert full.tobytes() == want[key].tobytes(), key
            local = t.to_local().numpy()
            idx = tuple(slice(o, o + n) for o, n in zip(
                _offset(t), local.shape))
            assert local.tobytes() == np.ascontiguousarray(
                want[key][idx]).tobytes(), key
        open(os.path.join(root, f"rank{rank}.ok"), "w").close()
    finally:
        dist.destroy_process_group()


def _on_mesh(shardings, mesh):
    """``restore_pytree``'s leaves: ``(mesh, placements)``."""
    if isinstance(shardings, dict):
        return {k: _on_mesh(v, mesh) for k, v in shardings.items()}
    return (mesh, shardings)


def _offset(t):
    """This rank's offset into ``t``'s global shape (the rules shard a
    tensor dim over one mesh dim at most, evenly)."""
    from torch.distributed.tensor import Shard
    off = [0] * t.dim()
    coord = t.device_mesh.get_coordinate()
    for mdim, p in enumerate(t.placements):
        if isinstance(p, Shard):
            off[p.dim] = coord[mdim] * (t.shape[p.dim]
                                        // t.device_mesh.size(mdim))
    return off
