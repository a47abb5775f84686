"""The reference's side of the zipf parity tests
(``tests/test_torch_zipf*.py``): ``benchmarks/run.py::zipf``'s run at one
theta, driven by the benchmark's own ``_drive_client``, with every
submitted batch's futures recorded so the results can be digested the
way the chip smoke's ``zipf_run`` digests the port's.
"""
from __future__ import annotations

import types

import benchmarks.run as BR
import torch_parity  # noqa: F401  (one torch thread per test process)
from repro.api import DiLiClient, LocalBackend
from repro.core.balancer import Balancer
from repro.data.ycsb import load_phase, mixed_phase


def bench_cfg_for(replication: bool):
    """``benchmarks/run.py::zipf``'s own nested ``cfg_for``, called."""
    code = next(c for c in BR.zipf.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "cfg_for")
    return types.FunctionType(code, vars(BR))(replication)


def ref_zipf_run(theta: float, replication: bool, smoke) -> dict:
    """One ``zipf`` run of the reference at ``theta``; the sizes come from
    the smoke's ``ZIPF`` (a test holds them equal to the benchmark's
    defaults). Returns the fields of ``ZIPF_EXPECTED``, the final keys and
    the smoke's ``oracle_check`` of the run."""
    z = smoke.ZIPF
    load = load_phase(z["n_load"], z["key_space"], seed=12)
    warm = mixed_phase(z["n_ops"], z["key_space"], 0.9, seed=13,
                       theta=theta)
    meas = mixed_phase(z["n_ops"], z["key_space"], 1.0, seed=14,
                       theta=theta)
    backend = LocalBackend(bench_cfg_for(replication))
    bal = Balancer(backend, hot_rate=6.0, cold_rate=1.0, hot_share=0.45,
                   replica_fanout=3)
    client = DiLiClient(backend, balance=bal, max_inflight=1024)
    futs = []
    submit = client.submit

    def recorded(kinds, keys):
        futs.append(submit(kinds, keys))
        return futs[-1]

    client.submit = recorded
    st = backend.stats
    BR._drive_client(client, *load, z["batch"])
    client.settle(max_rounds=8000)
    r_set = st["rounds"]
    BR._drive_client(client, *warm, z["batch"])
    r_warm, h0 = st["rounds"], st["rep_hits"]
    BR._drive_client(client, *meas, z["batch"])
    mismatches, oracle_keys = smoke.oracle_check(futs)
    return dict(setup_rounds=r_set, warm_rounds=r_warm - r_set,
                rounds=st["rounds"] - r_warm, rep_hits=st["rep_hits"] - h0,
                results=smoke.results_digest(futs), keys=backend.all_keys(),
                mismatches=mismatches, oracle_keys=oracle_keys)
