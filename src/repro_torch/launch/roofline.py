"""Roofline terms of a traced dry-run step (no card needed; the
reference's ``launch/roofline.py``).

  compute    = flops_per_device / peak FLOP/s
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_bytes_per_device / NVLink bandwidth

The reference reads these off a compiled SPMD executable (XLA's
``cost_analysis`` and the partitioned HLO text). The port traces one step
on meta DTensors over a fake process group and counts with ``CostMode``,
a ``TorchDispatchMode`` that sees every op twice: once on the DTensors
(global shapes), where it counts nothing but the flops of the global
step (``flops_global``) and lets DTensor dispatch, and once on each local
shard that DTensor's dispatch computes, where it counts rank 0's share:

  * flops: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention) on the local shapes; elementwise ops count none;
  * bytes: each local op's tensor inputs plus outputs, views excluded
    (no fusion, so an upper bound on what a fused program moves);
  * collectives: the output bytes of each ``_c10d_functional``,
    ``_dtensor`` or ``c10d`` collective, summed per kind under the
    reference's keys (``all-gather``, ``all-reduce``, ``reduce-scatter``,
    ``all-to-all``, ``collective-permute``).

Ops that DTensor runs on fake tensors to propagate shapes are skipped.
XLA's temporary-buffer size has no counterpart on meta tensors: the port
reports argument and output bytes (sums of local shards) and does not
measure temp.

The hardware constants are one NVIDIA H100 SXM5 (80 GB HBM3, 700 W), from
NVIDIA's datasheet: 989 TFLOP/s bf16 dense (tensor cores), 67 TFLOP/s f32
without tensor cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s per direction
(900 GB/s both ways).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..runtime import actctx

PEAK_FLOPS = 989e12       # bf16 dense, tensor cores
PEAK_FLOPS_F32 = 67e12    # f32, CUDA cores
HBM_BW = 3.35e12          # bytes/s
NVLINK_BW = 450e9         # bytes/s per direction
CARD = "NVIDIA H100 SXM5 80GB, 700 W"

# collective op name (any of the three namespaces) -> the reference's key
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
               "_dtensor")
# the in-place c10d ops write their result into their first argument
_INPLACE_OUT = ("c10d",)


def _flat(x, out=None) -> list:
    """The leaves of an op's arguments or results (tensors and scalars
    nested in tuples, lists and dicts), faster than a pytree walk."""
    out = [] if out is None else out
    if isinstance(x, (list, tuple)):
        for y in x:
            _flat(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _flat(y, out)
    else:
        out.append(x)
    return out


def _tensors(x) -> list:
    return [t for t in _flat(x) if isinstance(t, torch.Tensor)]


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class CostMode:
    """Counts a traced step's per-device cost (see the module docstring).

    ``with CostMode() as c: step(...)``; then ``c.flops``, ``c.bytes``,
    ``c.flops_global``, ``c.collectives`` (kind -> bytes) and
    ``c.events`` (kind, shape, dtype, bytes, role, module) of each
    collective; ``c.by_role`` sums the bytes each ``actctx`` role's
    redistribution issued;
    ``modules=True`` tags each event with the innermost ``nn.Module``
    running at the time (``ModTracker``; forward and backward)."""

    def __init__(self, *, modules: bool = False):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        outer = self
        self.flops = 0.0
        self.flops_global = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, int] = {}
        self.by_role: Dict[str, int] = {}
        self.events: list = []
        self._tracker = None
        if modules:
            from torch.distributed._tools.mod_tracker import ModTracker
            self._tracker = ModTracker()

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                packet = func.overloadpacket
                if any(issubclass(t, DTensor) for t in types):
                    if packet in flop_registry:
                        outer.flops_global += flop_registry[packet](
                            *args, **kwargs, out_val=None)
                    return NotImplemented
                out = outer._run(func, args, kwargs)
                if any(isinstance(t, FakeTensor) for t in
                       _tensors((args, kwargs, out))):
                    return out           # DTensor's shape propagation
                outer._local(func, packet, args, kwargs, out,
                             flop_registry)
                return out

        self._mode = _Mode()
        self._memo: Dict[Any, Any] = {}

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; a functional op on meta tensors
        whose inputs' metadata it has seen before gets fresh outputs of
        the metadata it gave then (meta kernels are Python for many ops,
        up to milliseconds a call, and a scan repeats the same few ops
        thousands of times)."""
        flat = _flat((args, kwargs))
        metas = [t.is_meta for t in flat if isinstance(t, torch.Tensor)]
        if func.is_view or func._schema.is_mutable or not metas or \
                not all(metas):
            return func(*args, **kwargs)
        key = (func, len(args), tuple(kwargs), tuple(
            (tuple(x.shape), x.stride(), x.dtype)
            if isinstance(x, torch.Tensor) else x for x in flat))
        try:
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            leaves, spec = tree_flatten(out)
            self._memo[key] = (spec, [
                (tuple(x.shape), x.stride(), x.dtype)
                if isinstance(x, torch.Tensor) else x for x in leaves])
            return out
        spec, leaves = hit
        return tree_unflatten([
            torch.empty_strided(x[0], x[1], dtype=x[2], device="meta")
            if isinstance(x, tuple) else x for x in leaves], spec)

    def _local(self, func, packet, args, kwargs, out, flop_registry):
        ns, _, name = func._schema.name.partition("::")
        if ns in _NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is None:
                return                   # wait_tensor, autograd wrappers
            res = args[0] if ns in _INPLACE_OUT else out
            nb = _nbytes(res)
            self.collectives[kind] = self.collectives.get(kind, 0) + nb
            role = actctx.active()
            if role:
                self.by_role[role] = self.by_role.get(role, 0) + nb
            first = next(iter(_tensors(res)), None)
            self.events.append(dict(
                kind=kind, bytes=nb, role=role,
                shape=tuple(first.shape) if first is not None else (),
                dtype=str(first.dtype) if first is not None else "",
                module=self._module()))
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)

    def totals(self) -> Dict[str, Any]:
        """flops, bytes, collectives (kind -> bytes) and flops_global."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": dict(self.collectives),
                "by_role": dict(self.by_role),
                "flops_global": float(self.flops_global)}

    def _module(self) -> str:
        if self._tracker is None:
            return ""
        parents = [p for p in self._tracker.parents if p != "Global"]
        name = max(parents, key=len) if parents else "Global"
        return name + (" (bw)" if self._tracker.is_bw else "")

    def __enter__(self):
        if self._tracker is not None:
            self._tracker.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        if self._tracker is not None:
            self._tracker.__exit__(*exc)
        return False


def collective_bytes(cost: CostMode) -> Dict[str, int]:
    """Output bytes of every collective of a traced step, per kind."""
    return dict(cost.collectives)


def model_flops(cfg, cell) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    n = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch  # decode: one token per sequence


def active_params(cfg) -> float:
    """Active parameter count (MoE counts top_k experts per token)."""
    d, v, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hd, h, kh = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * d
        dt_rank = s.dt_rank or (d + 15) // 16
        per = d * 2 * di + di * (dt_rank + 2 * s.state) + dt_rank * di \
            + di * d
        return emb + L * per
    attn = d * (h * hd) + 2 * d * (kh * hd) + (h * hd) * d
    if cfg.family == "moe":
        ffn = 3 * d * cfg.moe.d_ff_expert * cfg.moe.top_k + d * cfg.moe.n_experts
        return emb + L * (attn + ffn)
    ffn = 3 * d * cfg.d_ff
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        per = d * (2 * di + 2 * s.state + nh) + di * d
        groups = max(1, L // max(cfg.hybrid_period, 1))
        return emb + L * per + (attn + ffn)  # shared block counted once
    return emb + L * (attn + ffn)


def terms(flops: float, nbytes: float, coll: float) -> Dict[str, float]:
    return {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
            "collective": coll / NVLINK_BW}


def analyze(costs: Dict[str, Any], *, n_devices: int, cfg, cell,
            memory: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The reference's result keys from a traced step's costs
    (``CostMode.totals()``, or their extrapolation to full depth);
    ``memory`` holds the argument and output bytes per device."""
    flops_dev, bytes_dev = costs["flops"], costs["bytes"]
    coll = dict(costs["collectives"])
    coll_dev = float(sum(coll.values()))
    t = terms(flops_dev, bytes_dev, coll_dev)
    dominant = max(t, key=t.get)
    mf = model_flops(cfg, cell)
    mf_dev = mf / n_devices
    bound = max(t.values())
    return {
        "arch": cfg.name, "cell": cell.name, "devices": n_devices,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collectives": coll,
        "collective_bytes_by_role": dict(costs.get("by_role", {})),
        "terms_seconds": t,
        "dominant": dominant,
        "model_flops_global": mf,
        "flops_global_traced": costs["flops_global"],
        "useful_flops_ratio": mf_dev / flops_dev if flops_dev else 0.0,
        "roofline_mfu_bound": (mf_dev / PEAK_FLOPS) / bound if bound
        else 0.0,
        "memory_analysis": dict(memory or {},
                                not_measured=["temp_size_in_bytes"]),
        "hardware": CARD,
    }
