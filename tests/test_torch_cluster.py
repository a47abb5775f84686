"""The whole slice: client, backend, cluster, round, balancer splits and
the block probe, the port against the reference bit for bit.

C1  One shard through ``DiLiClient`` + ``LocalBackend`` + ``Balancer`` with
    the block probe on: a YCSB load and a 50%-read mix give the same
    op-for-op results, key set, round count, stats and per-round state
    digests, and the run is non-vacuous (splits happened, the kernel path
    answered lanes).
C2  Two shards with channel delays and no balancer, plus one explicit
    Split on shard 0: delegation, ``MSG_RESULT`` routing and the
    ``MSG_REG_SPLIT`` broadcast agree, hop counters included.
C3  Carry-over: a reference run's states, background tables and backlog
    are carried into the port through ``repro_torch.convert`` mid-stream
    (a Split in flight) and both continue on the same feed in lockstep.
C4  Guards: the package imports neither ``jax`` nor ``repro``; entry points
    default to CUDA and raise without it; every family trains through
    the ``Trainer``, and the paged serving engine refuses every family
    but the dense text one, and the int8 KV cache; the transport's
    nemesis, a membership join and a WAL run, equal to the reference.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.core.balancer as JBAL
import repro.core.sim as JSIM
import repro.core.net as JNET
import repro.core.types as JT
import repro.data.ycsb as JY
import repro_torch.api as TA
import repro_torch.core.balancer as TBAL
import repro_torch.core.net as TNET
import repro_torch.core.sim as TSIM
import repro_torch.core.types as TT
import repro_torch.data.ycsb as TY
from repro.core.oracle import OracleList
from repro_torch import convert
from repro_torch.core import bg as TB

from torch_parity import assert_trees_equal, digest

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(num_shards=1, pool_capacity=4096, max_sublists=32, max_ctrs=32,
          max_scan=4096, batch_size=16, mailbox_cap=256, move_batch=8,
          split_threshold=48, find_fastpath=True, block_probe=True)
PKGS = {
    "jax": dict(api=JA, bal=JBAL, sim=JSIM, types=JT, extra={}),
    "torch": dict(api=TA, bal=TBAL, sim=TSIM, types=TT,
                  extra=dict(device="cpu")),
}


def _recording(backend, log):
    """Wrap ``backend.step`` to digest every shard's state + bg table after
    each round."""
    step = backend.step

    def wrapped():
        out = step()
        log.append(digest(backend.states, backend.bgs))
        return out

    backend.step = wrapped


def _client_run(pkg, load, mix):
    p = PKGS[pkg]
    backend = p["api"].LocalBackend(p["types"].DiLiConfig(**KW),
                                    **p["extra"])
    log = []
    _recording(backend, log)
    client = p["api"].DiLiClient(backend, balance=p["bal"].Balancer(backend))
    futs = []
    for kinds, keys in (load, mix):
        futs += list(client.submit(kinds.tolist(), keys.tolist()))
        while client.pending:
            client.pump()
        client.settle()
    sub = [e for e in backend.sublists(0) if e["owner"] == 0]
    return dict(results=[f.raw() for f in futs], keys=backend.all_keys(),
                stats=dict(backend.stats), sublists=len(sub), digests=log,
                wrong_routes=client.wrong_routes)


def test_c1_one_shard_client_balancer_block_probe():
    load = JY.load_phase(300, 1000, seed=1)
    mix = JY.mixed_phase(400, 1000, 0.5, seed=2)
    # the port's generator is a copy: same seeds, same ops
    for a, b in zip(load + mix, TY.load_phase(300, 1000, seed=1)
                    + TY.mixed_phase(400, 1000, 0.5, seed=2)):
        np.testing.assert_array_equal(a, b)

    ref = _client_run("jax", load, mix)
    got = _client_run("torch", load, mix)
    assert got["results"] == ref["results"]
    assert got["keys"] == ref["keys"]
    assert got["stats"] == ref["stats"]
    assert got["sublists"] == ref["sublists"]
    assert got["wrong_routes"] == ref["wrong_routes"]
    assert len(got["digests"]) == len(ref["digests"]) == got["stats"]["rounds"]
    for r, (a, b) in enumerate(zip(ref["digests"], got["digests"])):
        assert a == b, f"state digest differs after round {r}"

    # non-vacuous: the balancer split and the kernel path answered lanes
    assert got["sublists"] > 1
    assert got["stats"]["blk_hits"] > 0
    oracle = OracleList()
    expected = oracle.apply_batch(np.concatenate([load[0], mix[0]]),
                                  np.concatenate([load[1], mix[1]]))
    assert [bool(v) for v in got["results"]] == expected
    assert got["keys"] == sorted(oracle.snapshot())


def _two_shard_run(pkg, kinds, keys):
    p = PKGS[pkg]
    cfg = p["types"].DiLiConfig(**{**KW, "num_shards": 2})
    cl = p["sim"].Cluster(cfg, seed=3, delay_prob=0.2, **p["extra"])
    ids, log = [], []
    b = cfg.batch_size
    for r, i in enumerate(range(0, len(kinds), b)):
        ids += cl.submit(r % 2, kinds[i:i + b], keys[i:i + b])
        cl.step()
        log.append(digest(cl.states, cl.bgs))
        if r == 8:
            head = cl.sublists(0)[0]["head_idx"]
            assert cl.split(0, JT.KEY_MAX, cl.middle_item(0, head))
    cl.run_until_quiet(400)
    return dict(results=[cl.results[j] for j in ids], keys=cl.all_keys(),
                stats=dict(cl.stats), digests=log,
                reg1=cl.registry_entries(1))


def test_c2_two_shards_with_delays():
    rng = np.random.default_rng(4)
    n = 320
    kinds = rng.choice([JT.OP_FIND, JT.OP_INSERT, JT.OP_REMOVE], n,
                       p=[0.4, 0.35, 0.25]).tolist()
    keys = rng.integers(1, 200, n).tolist()
    ref = _two_shard_run("jax", kinds, keys)
    got = _two_shard_run("torch", kinds, keys)
    assert got["results"] == ref["results"]
    assert got["keys"] == ref["keys"]
    assert got["stats"] == ref["stats"]
    assert got["digests"] == ref["digests"]
    # shard 1's ops were delegated to the owner and answered over
    # MSG_RESULT; the split reached shard 1's registry replica
    assert got["stats"]["delegated"] > 0 and got["stats"]["max_hops"] >= 1
    assert len(got["reg1"]) == 2 and got["reg1"] == ref["reg1"]
    assert [bool(v) for v in got["results"]] == \
        OracleList().apply_batch(kinds, keys)


def test_c2_delegated_insert_keeps_its_value():
    """An INSERT submitted at a server that does not own its key reaches
    the owner by delegation. The port's forwarded row carries the value;
    the reference's drops it and stores 0 (ROADMAP, Queue 3). Results,
    keys, stats and every other state lane agree."""
    outs = {}
    for pkg in ("jax", "torch"):
        p = PKGS[pkg]
        cl = p["sim"].Cluster(p["types"].DiLiConfig(**{**KW,
                                                       "num_shards": 2}),
                              **p["extra"])
        ids = cl.submit(1, [JT.OP_INSERT] * 3, [7, 8, 9], [70, 80, 90])
        ids += cl.submit(0, [JT.OP_INSERT], [10], [100])
        cl.run_until_quiet(50)
        head = cl.sublists(0)[0]["head_idx"]
        outs[pkg] = dict(results=[cl.results[i] for i in ids],
                         keys=cl.all_keys(), stats=dict(cl.stats),
                         vals=cl.shard_chain(0, head, include_meta=True))
    ref, got = outs["jax"], outs["torch"]
    assert got["results"] == ref["results"] == [1, 1, 1, 1]
    assert got["keys"] == ref["keys"] == [7, 8, 9, 10]
    assert got["stats"] == ref["stats"] and got["stats"]["delegated"] == 3
    assert [(k, v) for k, _, v in got["vals"]] == \
        [(7, 70), (8, 80), (9, 90), (10, 100)]
    assert [(k, v) for k, _, v in ref["vals"]] == \
        [(7, 0), (8, 0), (9, 0), (10, 100)]
    assert [i for k, i, _ in got["vals"]] == [i for k, i, _ in ref["vals"]]


def test_c3_carry_over_through_convert():
    load_kinds, load_keys = JY.load_phase(200, 600, seed=7)
    mix_kinds, mix_keys = JY.mixed_phase(240, 600, 0.5, seed=8)
    kinds = np.concatenate([load_kinds, mix_kinds]).tolist()
    keys = np.concatenate([load_keys, mix_keys]).tolist()
    b = KW["batch_size"]
    feed = [(kinds[i:i + b], keys[i:i + b]) for i in range(0, len(kinds), b)]
    cut = 12

    ref = JSIM.Cluster(JT.DiLiConfig(**KW))
    for r in range(cut):
        ref.submit(0, *feed[r])
        ref.step()
        if r == cut - 2:
            head = ref.sublists(0)[0]["head_idx"]
            assert ref.split(0, JT.KEY_MAX, ref.middle_item(0, head))
    # the split is mid-flight: exec ran, registry update still to come
    assert int(np.asarray(ref.bgs[0].phase)[0]) == TB.BG_SPLIT_WAIT

    got = TSIM.Cluster(TT.DiLiConfig(**KW), device="cpu")
    got.states = [convert.shard_state_from_numpy(
        convert.shard_state_to_numpy(ref.states[0]), device="cpu")]
    got.bgs = [convert.bg_table_from_numpy(
        convert.bg_table_to_numpy(ref.bgs[0]), device="cpu")]
    got.backlog = [ref.backlog[0].copy()]
    got._ids.next_id, got._ids.free = ref._ids.next_id, list(ref._ids.free)
    got._pending_ops = dict(ref._pending_ops)
    got.round_no = ref.round_no
    assert digest(got.states, got.bgs) == digest(ref.states, ref.bgs)

    for r in range(cut, len(feed)):
        ids_r = ref.submit(0, *feed[r])
        ids_t = got.submit(0, *feed[r])
        assert ids_r == ids_t
        ref.step()
        got.step()
        assert digest(got.states, got.bgs) == digest(ref.states, ref.bgs), \
            f"digest differs after round {r}"
    ref.run_until_quiet(200)
    got.run_until_quiet(200)
    assert got.round_no == ref.round_no
    assert_trees_equal(ref.states[0], got.states[0])
    assert {k: v for k, v in got.results.items()} == \
        {k: v for k, v in ref.results.items() if k in got.results}
    assert got.all_keys() == ref.all_keys()
    assert int(got.states[0].registry.size) == 2


# ------------------------------------------------------------------ guards

def test_c4_package_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "import repro_torch.core.distributed, repro_torch.api\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "import torch.distributed as dist\n"
        "bad += ['a process group'] if dist.is_initialized() else []\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    # the chip smoke script and the port's examples import nothing of JAX
    # or the reference either
    for path in [ROOT / "chip_smoke.py",
                 *sorted((ROOT / "examples").glob("torch_*.py"))]:
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] in
                    ("jax", "jaxlib", "repro")], (path.name, names)
    assert len(list((ROOT / "examples").glob("torch_*.py"))) == 3


def test_c4_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = TT.DiLiConfig(**KW)
    for make in (lambda: TSIM.Cluster(cfg),
                 lambda: TA.LocalBackend(cfg),
                 lambda: TA.local_client(cfg),
                 lambda: TA.ShardMapBackend(cfg),
                 lambda: TT.init_shard(cfg, 0),
                 lambda: TB.init_bg_table(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_c4_work_outside_the_slice_raises(tmp_path):
    # the int8 KV cache and the non-dense families (item 14) once raised
    # here; every family trains now, one step through the Trainer. The
    # paged serving engine still serves the dense text family
    # only: the others, and kv_quant, raise ValueError before any weights
    # are made (ROADMAP Queue 3 item 6)
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.launch import serve
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import Trainer, TrainerConfig
    from repro_torch.serving.engine import check_servable
    cell = ShapeCell("t", "train", 64, 2)
    others = []
    for name in ARCH_IDS:
        cfg = get_smoke_config(name)
        tr = Trainer(cfg, cell, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=1),
                     TrainerConfig(total_steps=1, ckpt_every=1,
                                   ckpt_dir=str(tmp_path / name),
                                   log_every=1),
                     make_batch=lambda s, c=cfg: make_train_batch(
                         c, cell, step=s, dtype=torch.float32,
                         device="cpu"), device="cpu")
        m = tr.run()["metrics"][0]
        assert np.isfinite(m["loss"]) and int(tr.opt_state["step"]) == 1
        assert (m["moe_aux"] > 0) == (cfg.family == "moe"), name
        if cfg.family != "dense" or cfg.modality != "text":
            others.append(name)
            with pytest.raises(ValueError, match="Queue 3 item 6"):
                serve.main(["--arch", name, "--smoke", "--device", "cpu"])
    assert len(others) == 6, others
    with pytest.raises(ValueError, match="kv_quant"):
        check_servable(get_smoke_config("qwen2_0_5b").replace(kv_quant=True))


def _fault_run(pkg, case, tmp):
    """A two-slot run through the transport under a lossy wire, a join of
    a retired slot with a Move onto it, or a WAL: what C4 once raised
    for. Returns the observables both packages must agree on."""
    p = PKGS[pkg]
    T = p["types"]
    cfg = T.DiLiConfig(**dict(KW, num_shards=2))
    kw = dict(p["extra"], seed=3, trace=True)
    if case == "nemesis":
        net = (JNET if pkg == "jax" else TNET).NemesisConfig(
            drop_prob=0.2, dup_prob=0.2, reorder_prob=0.2)
        kw["nemesis"] = net
    elif case == "join_shard":
        kw["initial_shards"] = 1
    else:
        kw["durability"] = f"{tmp}/{pkg}"
    cl = p["sim"].Cluster(cfg, **kw)
    keys = list(range(3, 300, 7))
    cl.submit(0, [T.OP_INSERT] * len(keys), keys)
    if case != "join_shard":
        cl.submit(1, [T.OP_FIND, T.OP_REMOVE, T.OP_INSERT], [10, 17, 400])
    cl.run_until_quiet(400)
    if case == "join_shard":
        assert cl.join_shard() == 1
        cl.run_until_quiet(400)
        sub = [e for e in cl.sublists(0) if e["owner"] == 0][0]
        assert cl.split(0, sub["keymax"], cl.middle_item(0, sub["head_idx"]))
        cl.run_until_quiet(400)
        sub = [e for e in cl.sublists(0) if e["owner"] == 0][0]
        assert cl.move(0, sub["keymax"], 1)
        cl.run_until_quiet(800)
        assert cl.membership.active == (0, 1)
    out = dict(trace=cl.round_trace, keys=cl.all_keys(),
               results=dict(cl.results), log=list(cl.membership.log),
               states=[digest(st, b) for st, b in zip(cl.states, cl.bgs)])
    if case == "durability":
        out["wal"] = [[(k, r[k].tolist()) for k in sorted(r)]
                      for s in range(2)
                      for r in cl.durability.wal(s).records()]
    return out


@pytest.mark.parametrize("case", ["nemesis", "join_shard", "durability"])
def test_c4_fault_tolerance_paths_match_the_reference(case, tmp_path):
    """The calls C4 used to hold as raising now run, equal to the
    reference: round traces, results, keys, membership logs, per-shard
    state digests and (with a WAL) every journaled record."""
    ref = _fault_run("jax", case, tmp_path)
    got = _fault_run("torch", case, tmp_path)
    assert got == ref
    assert got["trace"] and got["results"]
