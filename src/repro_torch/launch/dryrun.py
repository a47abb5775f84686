"""Production dry-run: trace every (arch × shape × mesh) cell (the
reference's ``launch/dryrun.py``).

The reference lowers and compiles each cell's step for 256 or 512
placeholder XLA devices and reads its roofline terms off the compiled
program. The port runs each cell's step once on meta DTensors over a fake
process group of 256 or 512 ranks (``launch/mesh.py``): train is the
forward pass, autograd and ``adamw_update``; prefill and decode are
``forward_serve``. It runs under ``implicit_replication()`` with the
activation roles bound, and ``roofline.CostMode`` counts rank 0's flops,
bytes and collectives. A cell that traces proves the distribution config
coherent: every op has a layout, every collective is one DTensor issues.

Departures from the reference's flow, each because of what DTensor is:
  * **Depth probes only.** A full-depth trace of an 80-layer model costs
    minutes of Python, so ``run_cell`` always takes the reference's
    ``probe_costs`` path (depths 1 and 2; ``p``, ``2p`` and ``p+1`` for
    the hybrid family, extrapolated linearly) unless ``probes=False``.
  * **A shorter sequence for the SSM families.** Their scans are a
    Python loop over time steps, several ms of dispatch each on meta
    tensors with autograd, so their train and prefill cells trace at
    ``SSM_SEQ`` positions, every chunk count (attention queries, loss,
    scan) kept, and report the costs of that step (``seq_len_traced``;
    ``model_flops_global`` and the MFU bound are its). Extrapolating
    from shorter sequences does not work: DTensor's choice between
    moving activations and moving weights changes with their sizes.
  * **One pod.** On the 2×16×16 mesh DTensor's redistribution planner
    searches a graph per op that takes minutes; ``pod`` is pure data
    parallelism, so the step runs on rank 0's pod (the ``("data",
    "model")`` sub-mesh, half the batch: the same local shards) and the
    gradients' all-reduce over ``pod`` is issued on tensors of their
    local shapes after it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
  python -m repro_torch.launch.dryrun --arch dili-service
(add ``--device cpu`` on a machine without a card: the mesh's device
type; every tensor of a model cell is on meta either way.)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback

import torch

from ..configs import ARCH_IDS, get_config
from ..models import transformer as T
from ..models.config import SHAPES, shape_by_name
from ..optim import AdamWConfig
from ..runtime import actctx
from ..runtime import sharding as S
from ..runtime.train import build_train_step
from . import roofline as R
from .inputs import activation_roles, input_specs
from .mesh import production_mesh

# the positions an SSM family's train or prefill cell is traced at
SSM_SEQ = 512


def cells_for(cfg):
    """The shape cells an arch runs (long_500k only for sub-quadratic)."""
    out = []
    for cell in SHAPES:
        if cell.name == "long_500k" and not cfg.sub_quadratic:
            continue  # full-attention archs skip 524k ctx (DESIGN.md §5)
        out.append(cell)
    return out


def _local_bytes(*trees) -> int:
    """Bytes of rank 0's shards of every tensor in ``trees``."""
    from torch.utils._pytree import tree_leaves
    total = 0
    for tree in trees:
        if isinstance(tree, torch.nn.Module):
            tree = list(tree.parameters())
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if hasattr(t, "to_local") else t
                total += t.numel() * t.element_size()
    return total


def _distributed_args(kind, args, pl, mesh):
    if kind == "train":
        params, opt, batch = args
        S.distribute_params_(params, mesh, pl[0])
        return (params, S.distribute_opt_state(opt, pl[0], mesh),
                S.distribute(batch, pl[2], mesh))
    params, batch, cache, clen = args
    S.distribute_params_(params, mesh, pl[0])
    return (params, S.distribute(batch, pl[1], mesh),
            S.distribute(cache, pl[2], mesh),
            S.distribute(clen, pl[3], mesh))


def _pod(mesh, cell):
    """(mesh the step runs on, the cell's share of it): one pod of a
    multi-pod mesh (see the module docstring)."""
    pods = S.axis_sizes(mesh).get("pod", 1)
    if pods == 1:
        return mesh, cell
    return mesh["data", "model"], dataclasses.replace(
        cell, global_batch=cell.global_batch // pods)


def _trace_cell(cfg, cell, mesh, *, modules: bool = False):
    """One step of ``cell`` on meta DTensors: (kind, CostMode, bytes per
    device of a serving step's logits, None for train)."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import implicit_replication
    sub, c = _pod(mesh, cell)
    kind, args, pl = input_specs(cfg, c, sub)
    args = _distributed_args(kind, args, pl, sub)
    actctx.set_roles(**activation_roles(cfg, c, sub))
    try:
        with implicit_replication(), R.CostMode(modules=modules) as cost:
            if kind == "train":
                params, opt, _ = build_train_step(cfg, AdamWConfig())(*args)
                logits = None
                if sub is not mesh:         # the gradients' pod all-reduce
                    for p in params.parameters():
                        funcol.all_reduce(p.to_local(), "sum", (mesh, 0))
            else:
                logits, _ = T.forward_serve(args[0], cfg, *args[1:],
                                            decode=kind == "decode")
    finally:
        actctx.set_roles()
    return kind, cost, None if logits is None else _local_bytes(logits)


def seq_cut(cfg, cell):
    """(cfg, cell) as traced: the SSM families' train and prefill cells at
    ``SSM_SEQ`` positions (see the module docstring), with each chunk
    count (attention queries, loss, scan) kept; every other cell as it
    is."""
    if cfg.family not in ("ssm", "hybrid") or cell.kind == "decode" or \
            cell.seq_len <= SSM_SEQ:
        return cfg, cell
    s = cell.seq_len
    counts = [s // min(c, s) for c in (cfg.attn_q_chunk, cfg.loss_chunk,
                                       cfg.ssm_chunk)]
    unit = math.lcm(*counts)
    t = -(-SSM_SEQ // unit) * unit
    return (cfg.replace(attn_q_chunk=t // counts[0],
                        loss_chunk=t // counts[1], ssm_chunk=t // counts[2]),
            dataclasses.replace(cell, seq_len=t))


def _combine(weights, costs):
    """sum of ``w * c`` over costs dicts (collectives per kind)."""
    out = {"flops": 0.0, "bytes": 0.0, "flops_global": 0.0,
           "collectives": {}, "by_role": {}}
    for w, c in zip(weights, costs):
        for k in ("flops", "bytes", "flops_global"):
            out[k] += w * c[k]
        for d in ("collectives", "by_role"):
            for k, v in c[d].items():
                out[d][k] = out[d].get(k, 0.0) + w * v
    return out


def _costs(cfg, cell, mesh):
    """Per-device costs of one step of ``cell`` at ``cfg``'s depth."""
    kind, cost, logits_bytes = _trace_cell(cfg, cell, mesh)
    return kind, cost.totals(), logits_bytes


def probe_costs(cfg, cell, mesh):
    """Per-device costs extrapolated to full depth from traces at small
    depths: total = c(L0) + (depth - L0)/(L1 - L0) * (c(L1) - c(L0)); the
    hybrid family takes p, 2p and p+1 layers (groups and trailing Mamba
    blocks), as the reference's."""
    if cfg.family == "hybrid":
        p = max(cfg.hybrid_period, 1)
        l0, l1 = p, 2 * p
        groups = max(1, cfg.n_layers // p)
        trailing = cfg.n_layers - groups * p
        c0 = _costs(cfg.replace(n_layers=l0), cell, mesh)
        c1 = _costs(cfg.replace(n_layers=l1), cell, mesh)
        cm = _costs(cfg.replace(n_layers=l0 + 1), cell, mesh)
        # x0 + (groups - 1) * (x1 - x0) + trailing * (xm - x0)
        return c0[0], _combine((1 - (groups - 1) - trailing, groups - 1,
                                trailing), (c0[1], c1[1], cm[1])), c0[2]

    l0, l1 = 1, 2
    c0 = _costs(cfg.replace(n_layers=l0), cell, mesh)
    c1 = _costs(cfg.replace(n_layers=l1), cell, mesh)
    n = cfg.n_layers
    return c0[0], _combine((1 - (n - l0), n - l0), (c0[1], c1[1])), c0[2]


def _memory(cfg, cell, mesh, kind, logits_bytes):
    """Argument and output bytes per device at full depth (the sums of
    rank 0's shards): the new params and state of a train step, the new
    cache and the logits of a serving step. XLA's temp size has no
    counterpart here."""
    sub, c = _pod(mesh, cell)
    k, args, pl = input_specs(cfg, c, sub)
    args = _distributed_args(k, args, pl, sub)
    out = _local_bytes(args[0], args[1]) if kind == "train" else \
        _local_bytes(args[2]) + logits_bytes
    return {"argument_size_in_bytes": _local_bytes(*args),
            "output_size_in_bytes": out}


def run_cell(arch: str, cell_name: str, *, multi_pod: bool,
             verbose: bool = True, probes: bool = True,
             model_size: int = 16, overrides: dict | None = None,
             device: str = "cuda"):
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    cfg, cell = seq_cut(cfg, shape_by_name(cell_name))
    with production_mesh(multi_pod=multi_pod, model_size=model_size,
                         device_type=torch.device(device).type) as mesh:
        n_dev = mesh.size()
        t0 = time.time()
        if probes:
            kind, costs, logits_bytes = probe_costs(cfg, cell, mesh)
        else:
            kind, costs, logits_bytes = _costs(cfg, cell, mesh)
        t1 = time.time()
        memory = _memory(cfg, cell, mesh, kind, logits_bytes)
    res = R.analyze(costs, n_devices=n_dev, cfg=cfg, cell=cell,
                    memory=memory)
    mesh_name = ("2x" if multi_pod else "") + \
        f"{256 // model_size}x{model_size}"
    # compile_seconds: the trace's seconds (the reference's key)
    res.update(mesh=mesh_name, kind=kind, compile_seconds=round(t1 - t0, 1),
               probe_extrapolated=probes, seq_len_traced=cell.seq_len)
    if overrides:
        res["overrides"] = {k: str(v) for k, v in overrides.items()}
    if verbose:
        mem = res["memory_analysis"]
        print(f"[{arch} × {cell.name} × {res['mesh']}] kind={kind} "
              f"trace={res['compile_seconds']}s")
        print(f"  memory_analysis: {mem}")
        print(f"  flops/dev={res['flops_per_device']:.3e} "
              f"bytes/dev={res['bytes_per_device']:.3e} "
              f"coll/dev={res['collective_bytes_per_device']:.3e}")
        t = res["terms_seconds"]
        print(f"  terms(s): compute={t['compute']:.4e} "
              f"memory={t['memory']:.4e} collective={t['collective']:.4e} "
              f"-> dominant={res['dominant']}")
        print(f"  MODEL_FLOPS={res['model_flops_global']:.3e} "
              f"useful/traced={res['useful_flops_ratio']:.3f} "
              f"roofline_MFU_bound={res['roofline_mfu_bound']:.3f}")
    return res


def run_dili_service(*, multi_pod: bool, verbose: bool = True,
                     device: str = "cuda"):
    """Dry-run the paper's own architecture: the DiLi service round, one
    shard per rank of the production mesh, routed by one all-to-all.

    ``service_input_specs`` gives the stacked round's shapes. The round's
    host loops need data, which a fake group's meta tensors do not hold,
    so rank 0 runs its round on an ``init_shard`` state of those shapes
    (an empty inbox and client feed) through
    ``make_dili_round(group=<the fake group>)``."""
    import torch.distributed as dist
    from torch.utils._pytree import tree_leaves
    from ..core import bg as B
    from ..core.distributed import (make_dili_round, service_input_specs,
                                    stack_states)
    from ..core.types import DiLiConfig, init_shard

    with production_mesh(multi_pod=multi_pod,
                         device_type=torch.device(device).type) as mesh:
        n = mesh.size()
        cfg = DiLiConfig(num_shards=n, pool_capacity=1 << 16,
                         max_sublists=512, max_ctrs=512, max_scan=2048,
                         batch_size=64, mailbox_cap=192, move_batch=16)
        cap_pair = 4
        spec_st, spec_bg, spec_in, spec_cl = service_input_specs(
            cfg, n, n * cap_pair)
        rank = dist.get_rank()
        states, bgs = stack_states([init_shard(cfg, rank, device=device)],
                                   [B.init_bg_table(cfg, device=device)])
        if [tuple(x.shape) for x in tree_leaves((states, bgs))] != \
                [(1,) + tuple(x.shape[1:])
                 for x in tree_leaves((spec_st, spec_bg))]:
            raise AssertionError("init_shard's shapes are not the specs'")
        inbox = torch.zeros((1,) + tuple(spec_in.shape[1:]),
                            dtype=spec_in.dtype, device=device)
        client = torch.zeros((1,) + tuple(spec_cl.shape[1:]),
                             dtype=spec_cl.dtype, device=device)
        rnd = make_dili_round(cfg, cap_pair, group=dist.group.WORLD)
        t0 = time.time()
        with R.CostMode() as cost:
            rnd(states, bgs, inbox, client)
        t1 = time.time()
    coll = R.collective_bytes(cost)
    t = R.terms(cost.flops, cost.bytes, float(sum(coll.values())))
    res = {
        "arch": "dili-service", "cell": f"round_b{cfg.batch_size}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n, "kind": "service_round",
        "compile_seconds": round(t1 - t0, 1),
        "flops_per_device": float(cost.flops),
        "bytes_per_device": float(cost.bytes),
        "collectives": coll,
        "collective_bytes_per_device": float(sum(coll.values())),
        "terms_seconds": t, "dominant": max(t, key=t.get),
        "hardware": R.CARD,
    }
    if verbose:
        print(f"[dili-service × {res['mesh']}] "
              f"trace={res['compile_seconds']}s "
              f"coll/dev={res['collective_bytes_per_device']:.3e} {coll}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="arch id, or 'dili-service', or omit with --all")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--model-size", type=int, default=16)
    ap.add_argument("--override", default="",
                    help="comma k=v ArchConfig overrides")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cpu without a card)")
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs = []
    if args.all:
        for a in ARCH_IDS:
            for cell in cells_for(get_config(a)):
                for mp in meshes:
                    jobs.append((a, cell.name, mp))
        for mp in meshes:
            jobs.append(("dili-service", None, mp))
    else:
        assert args.arch
        if args.arch == "dili-service":
            jobs = [("dili-service", None, mp) for mp in meshes]
        elif args.shape:
            jobs = [(args.arch, args.shape, mp) for mp in meshes]
        else:
            jobs = [(args.arch, c.name, mp) for mp in meshes
                    for c in cells_for(get_config(args.arch))]

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = eval(v)  # noqa: S307 - trusted CLI

    results, failures = [], []
    for arch, shape, mp in jobs:
        try:
            if arch == "dili-service":
                res = run_dili_service(multi_pod=mp, device=args.device)
            else:
                res = run_cell(arch, shape, multi_pod=mp,
                               model_size=args.model_size,
                               overrides=overrides, device=args.device)
            results.append(res)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
        except Exception as e:
            traceback.print_exc()
            failures.append({"arch": arch, "cell": shape,
                             "mesh": "2x16x16" if mp else "16x16",
                             "error": f"{type(e).__name__}: {e}"})

    print(f"\n=== dry-run: {len(results)} ok, {len(failures)} failed ===")
    for f_ in failures:
        print("FAILED:", f_)
    return 0 if not failures else 1


if __name__ == "__main__":
    raise SystemExit(main())
