"""The port's production dry-run (``repro_torch.launch.dryrun``).

- dili-service on 16×16: one service round's all-to-all bytes per device
  equal the reference's own ``run_dili_service(multi_pod=False)``, which
  compiles the round for 256 XLA host devices in a subprocess (~25 s);
  the port's ``service_input_specs`` shapes and dtypes equal the
  reference's.
- One model cell, for time: Qwen2-0.5B × train_4k on 16×16 with the depth
  probes. It traces, ``model_flops_global`` equals the reference's, and
  the per-device flops times 256 come within 5% of the traced step's
  global count (the matmuls split evenly over the mesh).
- ``python -m repro_torch.launch.dryrun`` exits non-zero when a cell
  fails.
"""
import math
import os
import subprocess
import sys

import torch_parity  # noqa: F401  (one torch thread per test process)
from torch_spmd import ROOT, run_reference

from repro_torch.launch import dryrun as D

REF = """
import json
from repro.launch.dryrun import run_dili_service
from repro.core.distributed import service_input_specs
from repro.core.types import DiLiConfig
import jax
res = run_dili_service(multi_pod=False, verbose=False)
cfg = DiLiConfig(num_shards=256, pool_capacity=1 << 16, max_sublists=512,
                 max_ctrs=512, max_scan=2048, batch_size=64,
                 mailbox_cap=192, move_batch=16)
specs = service_input_specs(cfg, 256, 256 * 4)
res["specs"] = [[list(x.shape), str(x.dtype)]
                for x in jax.tree_util.tree_leaves(specs)]
print(json.dumps(res))
"""


def test_dili_service_all_to_all_bytes_equal_the_references():
    from torch.utils._pytree import tree_leaves
    from repro_torch.core.distributed import service_input_specs
    from repro_torch.core.types import DiLiConfig
    ref = run_reference(REF, 512)
    got = D.run_dili_service(multi_pod=False, verbose=False, device="cpu")
    assert got["collectives"]["all-to-all"] == \
        ref["collectives"]["all-to-all"] == 256 * 4 * 15 * 4
    assert got["devices"] == ref["devices"] == 256
    cfg = DiLiConfig(num_shards=256, pool_capacity=1 << 16,
                     max_sublists=512, max_ctrs=512, max_scan=2048,
                     batch_size=64, mailbox_cap=192, move_batch=16)
    specs = service_input_specs(cfg, 256, 256 * 4)
    mine = [[list(x.shape), str(x.dtype).removeprefix("torch.")]
            for x in tree_leaves(specs)]
    # the reference's uint32 ref columns are the port's int32 bit patterns
    theirs = [[s, d.replace("uint32", "int32")] for s, d in ref["specs"]]
    assert mine == theirs


def test_qwen2_0_5b_train_cell_traces_with_even_flops():
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as JR
    from repro.models.config import shape_by_name as ref_shape
    res = D.run_cell("qwen2_0_5b", "train_4k", multi_pod=False,
                     verbose=False, device="cpu")
    assert res["model_flops_global"] == JR.model_flops(
        ref_config("qwen2_0_5b"), ref_shape("train_4k"))
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "roofline_mfu_bound"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert res["dominant"] in res["terms_seconds"]
    assert abs(res["flops_per_device"] * 256 / res["flops_global_traced"]
               - 1) < 0.05
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0


def test_cli_exit_code_reports_a_failed_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "res.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2_0_5b", "--shape", "decode_32k", "--override",
         "n_heads=7", "--device", "cpu", "--out", str(out)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "1 failed" in r.stdout and not out.exists()


def test_importing_the_dryrun_initialises_no_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    import repro_torch.launch.dryrun  # noqa: F401
    import repro_torch.launch.perfprobe  # noqa: F401
    assert not dist.is_initialized()
