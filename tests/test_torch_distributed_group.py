"""The Group exchange of ``make_dili_round``: one rank per shard over a
``torch.distributed`` gloo group, the buckets routed by
``all_to_all_single``. Four ranks, spawned in one subprocess, run
``tests/test_distributed.py::SCRIPT``'s 38 rounds, each its own shard;
every rank's nine outputs must equal, round for round, that shard's
slice of the Local exchange's (one process, all four shards stacked).
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import torch_spmd as W

SPAWN = """
import sys
import torch.multiprocessing as mp
import torch_spmd as W
mp.spawn(W.group_worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_group_exchange_equals_local_exchange(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(W.ROOT / "src"), str(W.ROOT / "tests")]))
    r = subprocess.run([sys.executable, "-c", SPAWN, str(_free_port()),
                        str(tmp_path)], env=env, cwd=W.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    local = W.local_rounds_by_shard(W.pkg("torch"))
    for rank in range(4):
        got = json.loads(pathlib.Path(tmp_path, f"rank{rank}.json")
                         .read_text())
        assert len(got) == W.ROUNDS
        for rnd, (a, b) in enumerate(zip(local[rank], got)):
            assert a == b, f"rank {rank}, round {rnd}: outputs differ"
