"""Mesh builders (the reference's ``launch/mesh.py``).

The reference lays its meshes over XLA devices: 256 or 512 placeholder
host devices for the production dry-run, the host's own devices for the
examples. The port lays them over ``torch.distributed`` process groups:

  * ``make_production_mesh``: 256 ranks per pod (512 with ``multi_pod``)
    over the *fake* process group (``torch.testing._internal.distributed.
    fake_pg``), whose collectives move nothing, so one process traces
    rank 0's share of a step on meta tensors;
  * ``make_host_mesh``: a 1-D ``("data",)`` mesh over the cards of this
    host (NCCL), or over CPU processes (gloo) when the caller asks for
    the CPU.

A process has one default group, so each comes with a context manager
that initialises the group and destroys it afterwards
(``production_mesh``, ``host_mesh``); the builders themselves need the
group initialised. Nothing here touches ``torch.distributed`` at import.
"""
from __future__ import annotations

import math
import socket
from contextlib import contextmanager


def _dist():
    import torch.distributed as dist
    return dist


def _fake_store():
    # no fallback: the dry-run's 512 ranks exist only as the fake group
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextmanager
def fake_group(world_size: int):
    """The default process group as a fake group of ``world_size`` ranks,
    this process being rank 0; destroyed on exit."""
    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError("a default process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _shape(multi_pod: bool, model_size: int):
    if 256 % model_size:
        raise ValueError(f"model_size {model_size} does not divide 256")
    data = 256 // model_size
    shape = (2, data, model_size) if multi_pod else (data, model_size)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, model_size: int = 16,
                         device_type: str = "cuda"):
    """256 ranks per pod; multi_pod adds a 2-pod leading axis.

    ``model_size`` re-slices the same ranks into a different logical
    (data, model) split. Needs the default group initialised with as many
    ranks (``production_mesh`` does it)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = _shape(multi_pod, model_size)
    n = math.prod(shape)
    world = _dist().get_world_size()
    if world != n:
        raise RuntimeError(f"the default group has {world} ranks; the "
                           f"mesh {shape} needs {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextmanager
def production_mesh(*, multi_pod: bool = False, model_size: int = 16,
                    device_type: str = "cuda"):
    """``make_production_mesh`` over a fake group made for it."""
    shape, _ = _shape(multi_pod, model_size)
    with fake_group(math.prod(shape)):
        yield make_production_mesh(multi_pod=multi_pod,
                                   model_size=model_size,
                                   device_type=device_type)


def make_host_mesh(device="cuda"):
    """This host's cards (or, for ``device="cpu"``, the group's CPU
    ranks) as a 1-D data mesh. Needs the default group initialised
    (``host_mesh`` does it)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device(device)
    return init_device_mesh(dev.type, (_dist().get_world_size(),),
                            mesh_dim_names=("data",))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextmanager
def host_mesh(device="cuda"):
    """``make_host_mesh`` over a one-rank group made for it, this process
    on its first card (NCCL), or on the CPU (gloo), at a free local
    port."""
    import torch
    from ..core.types import resolve_device
    dev = resolve_device(device)
    dist = _dist()
    if dist.is_initialized():
        raise RuntimeError("a default process group is already "
                           "initialised in this process")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1)
    try:
        yield make_host_mesh(dev)
    finally:
        dist.destroy_process_group()
