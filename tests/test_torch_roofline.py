"""The port's ``launch/roofline.py``: ``model_flops`` and
``active_params`` equal the reference's exactly for every ``ARCH_IDS ×
SHAPES``; ``CostMode`` counts each collective's output bytes per device
on hand cases over a fake 16-rank group (an all-reduce of a ``Partial``,
an all-gather of a ``Shard``, an all-to-all) and the local flops of a
sharded matmul, and tags each with the module that issued it
(``perfprobe.breakdown``); the hardware constants are the H100 SXM's."""
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import fake_group
from repro_torch.models.config import SHAPES


def test_model_flops_and_active_params_equal_the_references():
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as JR
    for arch in ARCH_IDS:
        assert R.active_params(get_config(arch)) == \
            JR.active_params(ref_config(arch)), arch
        for cell in SHAPES:
            assert R.model_flops(get_config(arch), cell) == \
                JR.model_flops(ref_config(arch), cell), (arch, cell.name)


@pytest.fixture
def mesh16():
    from torch.distributed.device_mesh import init_device_mesh
    with fake_group(16):
        yield init_device_mesh("cpu", (16,), mesh_dim_names=("model",))


def test_collective_bytes_on_hand_cases(mesh16):
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard, distribute_tensor)
    mesh = mesh16
    part = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh,
                              [Partial()], run_check=False)
    with R.CostMode() as c:
        part.redistribute(mesh, [Replicate()])
    assert R.collective_bytes(c) == {"all-reduce": 8 * 32 * 4}

    sh = distribute_tensor(torch.empty(64, 8, device="meta"), mesh,
                           [Shard(0)])
    with R.CostMode() as c:
        sh.redistribute(mesh, [Replicate()])
    assert R.collective_bytes(c) == {"all-gather": 64 * 8 * 4}

    x = torch.zeros(16 * 4, 15, dtype=torch.int32)
    with R.CostMode() as c:
        dist.all_to_all_single(torch.empty_like(x), x)
    assert R.collective_bytes(c) == {"all-to-all": 16 * 4 * 15 * 4}
    assert c.events[0]["kind"] == "all-to-all"


def test_flops_are_per_device(mesh16):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    a = distribute_tensor(torch.empty(64, 32, device="meta"), mesh16,
                          [Shard(0)])
    b = distribute_tensor(torch.empty(32, 48, device="meta"), mesh16,
                          [Replicate()])
    with R.CostMode() as c:
        a @ b
    assert c.flops_global == 2 * 64 * 32 * 48
    assert c.flops == 2 * 4 * 32 * 48            # rank 0's rows
    assert c.bytes == 4 * (4 * 32 + 32 * 48 + 4 * 48)


def test_h100_constants():
    assert (R.PEAK_FLOPS, R.PEAK_FLOPS_F32, R.HBM_BW, R.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert "H100" in R.CARD and "700 W" in R.CARD
    t = R.terms(989e12, 3.35e12, 450e9)
    assert t == {"compute": 1.0, "memory": 1.0, "collective": 1.0}


def test_perfprobe_tags_collectives_with_their_module(mesh16):
    from torch import nn
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.perfprobe import breakdown

    class Gather(nn.Module):
        def forward(self, x):
            return x.redistribute(mesh16, [Replicate()])

    x = distribute_tensor(torch.empty(64, 8, device="meta"), mesh16,
                          [Shard(0)])
    with R.CostMode(modules=True) as c:
        Gather()(x)
        Gather()(x)
    rows, counts = breakdown(c.events)
    (key, nbytes), = rows
    assert key[0] == "all-gather" and "Gather" in key[2]
    assert nbytes == 2 * 64 * 8 * 4 and counts[key] == 2
