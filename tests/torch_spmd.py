"""Shared pieces of the SPMD parity tests (``tests/test_torch_distributed*.py``,
``tests/test_torch_shardmap*.py``).

The reference's SPMD round needs one XLA device per shard, and the
device count is fixed before JAX loads, so every reference run goes
through ``run_reference``: a subprocess on XLA host devices that prints
one JSON object as its last line. The port runs in the test process on
the CPU. The workloads here are written once against a package
namespace (``pkg("jax")`` / ``pkg("torch")``) so both runs share every
draw.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np

from torch_parity import digest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tests/test_distributed.py::SCRIPT: 4 shards, 38 rounds (the last 8
# drain), client batches every other round
SCRIPT_CFG = dict(num_shards=4, pool_capacity=1024, max_sublists=16,
                  max_ctrs=16, max_scan=1024, batch_size=8, mailbox_cap=64,
                  move_batch=4)
CAP_PAIR = 16
ROUNDS = 38


def run_reference(code: str, devices: int, timeout: int = 900) -> dict:
    """Run ``code`` on ``devices`` XLA host devices; return the JSON object
    of its last output line."""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return json.loads(r.stdout.strip().splitlines()[-1])


def pkg(name: str) -> SimpleNamespace:
    """The modules a workload needs, from the reference or the port."""
    if name == "jax":
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh

        import repro.api as api
        import repro.core.distributed as dist
        import repro.core.messages as M
        import repro.core.sim as sim
        import repro.core.types as types
        from repro.core.oracle import OracleList
        mesh = lambda n: Mesh(np.array(jax.devices()[:n]), ("shard",))
        return SimpleNamespace(
            name=name, api=api, dist=dist, M=M, sim=sim, types=types,
            OracleList=OracleList, extra={}, asarray=jnp.asarray,
            stacked=lambda backend: (backend._states, backend._bgs),
            round=lambda cfg, **kw: dist.make_dili_round(
                mesh(cfg.num_shards), cfg, **kw),
            hostroute=lambda cfg: dist.make_dili_round_hostroute(
                mesh(cfg.num_shards), cfg))
    import torch

    import repro_torch.api as api
    import repro_torch.core.distributed as dist
    import repro_torch.core.messages as M
    import repro_torch.core.sim as sim
    import repro_torch.core.types as types
    from repro_torch.core.oracle import OracleList
    return SimpleNamespace(
        name=name, api=api, dist=dist, M=M, sim=sim, types=types,
        OracleList=OracleList, extra=dict(device="cpu"),
        asarray=torch.as_tensor,
        # the port holds one tree per shard (on its own device); the
        # reference's digest is of the tree stacked over the shards
        stacked=lambda backend: dist.stack_states(
            [types.tree_map(torch.Tensor.cpu, t) for t in backend._states],
            [types.tree_map(torch.Tensor.cpu, t) for t in backend._bgs]),
        round=lambda cfg, **kw: dist.make_dili_round(cfg, **kw),
        hostroute=lambda cfg: dist.make_dili_round_hostroute(cfg))


# ------------------------------------------------------ make_dili_round

def script_feed(P):
    """``tests/test_distributed.py::SCRIPT``'s client batches, one
    ``[4, batch, F]`` array per round, and the sequential oracle's answer
    for each op slot."""
    T, M = P.types, P.M
    oracle = P.OracleList()
    rng = np.random.default_rng(0)
    expected, feeds, slot = {}, [], 0
    for r in range(ROUNDS):
        rows = np.zeros((4, SCRIPT_CFG["batch_size"], M.FIELDS), np.int32)
        if r < 30 and r % 2 == 0:
            for s in range(4):
                for b in range(SCRIPT_CFG["batch_size"]):
                    kind = int(rng.choice([T.OP_FIND, T.OP_INSERT,
                                           T.OP_REMOVE]))
                    key = int(rng.integers(1, 60))
                    rows[s, b, M.F_KIND] = M.MSG_OP
                    rows[s, b, M.F_DST] = s
                    rows[s, b, M.F_SRC] = s
                    rows[s, b, M.F_A] = kind
                    rows[s, b, M.F_KEY] = key
                    rows[s, b, M.F_REF1] = 0x003FFFFF
                    rows[s, b, M.F_SID] = s
                    rows[s, b, M.F_TS] = slot
                    expected[slot] = oracle.apply(kind, key)
                    slot += 1
        feeds.append(rows)
    return feeds, expected


def initial(P, cfg):
    """Stacked round-0 states, from the simulator's init (registry
    replicas included), as ``tests/test_distributed.py`` builds them."""
    sim = P.sim.Cluster(cfg, **P.extra)
    return P.dist.stack_states(sim.states, sim.bgs)


def output_digests(out) -> list:
    """One digest for the states and tables, one for each other output."""
    return [digest(out[0], out[1])] + [digest(x) for x in out[2:]]


def record(out, results: dict) -> None:
    cs, cv = np.asarray(out[3]), np.asarray(out[4])
    for a, b in zip(cs.ravel(), cv.ravel()):
        if a >= 0:
            results[int(a)] = int(b)


def routed_run(P) -> dict:
    """The 38 rounds through ``make_dili_round`` (cap_pair 16): per-round
    digests of all nine outputs and the ops' results."""
    cfg = P.types.DiLiConfig(**SCRIPT_CFG)
    feeds, expected = script_feed(P)
    states, bgs = initial(P, cfg)
    inbox = P.asarray(np.zeros((4, 4 * CAP_PAIR, P.M.FIELDS), np.int32))
    rnd = P.round(cfg, cap_pair=CAP_PAIR)
    rounds, results = [], {}
    for client in feeds:
        out = rnd(states, bgs, inbox, P.asarray(client))
        states, bgs, inbox = out[0], out[1], out[2]
        rounds.append(output_digests(out))
        record(out, results)
    return dict(rounds=rounds, results={str(k): v for k, v in
                                        results.items()},
                expected={str(k): bool(v) for k, v in expected.items()})


def direct_route(outbox, counts, backlog, in_cap: int, M) -> np.ndarray:
    """Host routing without a transport: each source's live rows join
    their destination's backlog in source order; the next inbox is each
    backlog's first ``in_cap`` rows (``Cluster``'s feed discipline)."""
    outbox = np.asarray(outbox)
    for s, c in enumerate(np.asarray(counts).tolist()):
        rows = outbox[s][:c]
        for d in range(len(backlog)):
            backlog[d] = np.concatenate(
                [backlog[d], rows[rows[:, M.F_DST] == d]])
    inbox = np.zeros((len(backlog), in_cap, M.FIELDS), np.int32)
    for d in range(len(backlog)):
        feed, backlog[d] = backlog[d][:in_cap], backlog[d][in_cap:]
        inbox[d, :feed.shape[0]] = feed
    return inbox


def hostroute_run(P) -> dict:
    """The same client feed through ``make_dili_round_hostroute``, the
    host routing the raw outboxes directly: per-round digests of all nine
    outputs and the ops' results."""
    M = P.M
    cfg = P.types.DiLiConfig(**SCRIPT_CFG)
    in_cap = max(cfg.mailbox_cap * cfg.num_shards, cfg.batch_size * 2)
    feeds, expected = script_feed(P)
    states, bgs = initial(P, cfg)
    rnd = P.hostroute(cfg)
    backlog = [np.zeros((0, M.FIELDS), np.int32) for _ in range(4)]
    inbox = np.zeros((4, in_cap, M.FIELDS), np.int32)
    rounds, results = [], {}
    for client in feeds:
        out = rnd(states, bgs, P.asarray(inbox), P.asarray(client))
        states, bgs = out[0], out[1]
        rounds.append(output_digests(out))
        record(out, results)
        inbox = direct_route(out[2], np.asarray(out[7])[:, 0], backlog,
                             in_cap, M)
    return dict(rounds=rounds, results={str(k): v for k, v in
                                        results.items()},
                expected={str(k): bool(v) for k, v in expected.items()})


# ------------------------------------------------------- ShardMapBackend

def parity_run(P, backend) -> dict:
    """``tests/test_client_api.py::PARITY_SCRIPT``'s workload: a load, a
    Split and a Move by hand, then 16 rounds of mixed ops through
    ``DiLiClient``. Returns the results, the key set, the oracle's keys,
    the backend's stats and rounds."""
    T = P.types
    client = P.api.DiLiClient(backend)
    oracle = P.OracleList()
    rng = np.random.default_rng(0)
    results = []
    load = rng.permutation(np.arange(1, 120))[:60].tolist()
    batch = client.insert_batch(load)
    oracle.apply_batch([T.OP_INSERT] * len(load), load)
    client.drain()
    results += batch.results()
    subs = [e for e in backend.sublists(0) if e["owner"] == 0]
    big = max(subs, key=lambda e: e["size"])
    mid = backend.middle_item(0, big["head_idx"])
    backend.split(0, big["keymax"], mid)
    client.drain()
    subs = [e for e in backend.sublists(0) if e["owner"] == 0]
    backend.move(0, subs[-1]["keymax"], 2)
    mixed = []
    for _ in range(16):
        kinds = rng.choice([T.OP_FIND, T.OP_INSERT, T.OP_REMOVE], 8).tolist()
        keys = rng.integers(1, 160, 8).tolist()
        mixed.append(client.submit(kinds, keys))
        oracle.apply_batch(kinds, keys)
        client.pump()
    client.drain()
    for b in mixed:
        results += b.results()
    return dict(results=[int(r) for r in results], keys=backend.all_keys(),
                oracle=sorted(oracle.snapshot()),
                stats=dict(backend.stats),
                rounds=int(backend.stats["rounds"]))


REPLICA_CFG = dict(SCRIPT_CFG, replication=True, replica_sessions=2,
                   replica_slots=4, replica_batch=8,
                   replica_refresh_rounds=4, replica_staleness_rounds=32)


def replica_run(P) -> dict:
    """A scripted replicate / serve / drop run on ``ShardMapBackend``:
    load 60 keys onto shard 0, replicate its sublist onto shards 1 and 2,
    send FINDs to the replicas while the image installs and serves, then
    drop the replicas and read again. A digest of the stacked state after
    every round; the results, ``rep_hits`` and the rounds."""
    T = P.types
    backend = P.api.ShardMapBackend(T.DiLiConfig(**REPLICA_CFG), **P.extra)
    digests = []
    step = backend.step

    def recorded():
        out = step()
        digests.append(digest(*P.stacked(backend)))
        return out

    backend.step = recorded
    comps = []              # (round, op_id, result, src), in order

    def run(shard, kinds, keys, rounds):
        ids = backend.submit(shard, kinds, keys)
        for _ in range(rounds):
            comps.extend((backend.round_no, int(i), int(v), int(s))
                         for i, v, s in backend.step())
        return ids

    keys = list(range(3, 183, 3))
    run(0, [T.OP_INSERT] * len(keys), keys, 12)
    kmax = [e for e in backend.sublists(0) if e["owner"] == 0][0]["keymax"]
    ok = [backend.replicate(0, kmax, 1), backend.replicate(0, kmax, 2)]
    reads = []
    for r in range(30):
        shard = 1 + r % 2
        reads.append(run(shard, [T.OP_FIND] * 4,
                         [keys[(7 * r + i) % len(keys)] + i % 2
                          for i in range(4)], 1))
    run(0, [T.OP_INSERT, T.OP_REMOVE], [301, 3], 4)
    ok.append(backend.drop_replica(0, kmax))
    sets = {str(k): v for k, v in backend.replica_sets().items()}
    reads.append(run(1, [T.OP_FIND] * 4, [6, 9, 301, 3], 30))
    return dict(ok=[bool(x) for x in ok], comps=comps, reads=reads, rep_hits=int(backend.stats["rep_hits"]),
                stats=dict(backend.stats), sets_after_drop=sets,
                rounds=backend.round_no, digests=digests,
                keys=backend.all_keys())


# ----------------------------------------------------- the Group exchange

def group_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of the Group exchange: shard ``rank`` of ``routed_run``'s
    workload through ``make_dili_round(group=...)`` over gloo; writes the
    per-round output digests to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=4, rank=rank)
    try:
        P = pkg("torch")
        cfg = P.types.DiLiConfig(**SCRIPT_CFG)
        feeds, _ = script_feed(P)
        mine = slice(rank, rank + 1)
        states, bgs = (P.dist.shard_slice(t, mine) for t in initial(P, cfg))
        inbox = torch.zeros((1, 4 * CAP_PAIR, P.M.FIELDS), dtype=torch.int32)
        rnd = P.dist.make_dili_round(cfg, cap_pair=CAP_PAIR,
                                     group=dist.group.WORLD)
        rounds = []
        for client in feeds:
            out = rnd(states, bgs, inbox, torch.as_tensor(client[mine]))
            states, bgs, inbox = out[0], out[1], out[2]
            rounds.append(output_digests(out))
        pathlib.Path(out_dir, f"rank{rank}.json").write_text(
            json.dumps(rounds))
    finally:
        dist.destroy_process_group()


def local_rounds_by_shard(P) -> list:
    """``routed_run``'s Local exchange, each round's outputs digested per
    shard slice: ``out[shard][round]``."""
    cfg = P.types.DiLiConfig(**SCRIPT_CFG)
    feeds, _ = script_feed(P)
    states, bgs = initial(P, cfg)
    inbox = P.asarray(np.zeros((4, 4 * CAP_PAIR, P.M.FIELDS), np.int32))
    rnd = P.round(cfg, cap_pair=CAP_PAIR)
    per = [[] for _ in range(4)]
    for client in feeds:
        out = rnd(states, bgs, inbox, P.asarray(client))
        states, bgs, inbox = out[0], out[1], out[2]
        for s in range(4):
            per[s].append(output_digests(
                [P.dist.shard_slice(x, slice(s, s + 1)) for x in out]))
    return per
