"""``input_specs()``: meta-tensor stand-ins and their placements for every
(arch × shape) cell (the reference's ``launch/inputs.py``): the shapes
and dtypes of a step's arguments, with no allocation."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..models import transformer as T
from ..models.config import ArchConfig, ShapeCell
from ..optim import adamw_init
from ..runtime import sharding as S

META = torch.device("meta")


class GradSpec(NamedTuple):
    """A role's forward layout and its gradient's, where they differ."""
    fwd: tuple
    grad: tuple


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def batch_sds(cfg: ArchConfig, cell: ShapeCell, *, decode: bool,
              dtype=torch.bfloat16) -> Dict[str, Any]:
    b, s = cell.global_batch, cell.seq_len
    t = 1 if decode else s
    if cell.kind == "train":
        if cfg.modality == "audio_stub":
            return {"frame_embeds": _sds((b, s, cfg.d_model), dtype),
                    "targets": _sds((b, s), torch.int32)}
        if cfg.modality == "vision_stub":
            li = min(s // 2, 2048)
            return {"patch_embeds": _sds((b, li, cfg.d_model), dtype),
                    "tokens": _sds((b, s - li), torch.int32),
                    "targets": _sds((b, s), torch.int32)}
        return {"tokens": _sds((b, s), torch.int32),
                "targets": _sds((b, s), torch.int32)}
    # serving
    if cfg.modality == "audio_stub":
        return {"frame_embeds": _sds((b, t, cfg.d_model), dtype)}
    if cfg.modality == "vision_stub" and not decode:
        li = min(t // 2, 2048)
        return {"patch_embeds": _sds((b, li, cfg.d_model), dtype),
                "tokens": _sds((b, t - li), torch.int32)}
    return {"tokens": _sds((b, t), torch.int32)}


def _dp_size(mesh) -> int:
    sizes = S.axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def input_specs(cfg: ArchConfig, cell: ShapeCell, mesh, *,
                dtype=torch.bfloat16):
    """Returns (kind, args, placements) for the cell's step function.

    kind: 'train' -> (params, opt_state, batch)
          'prefill'/'decode' -> (params, batch, cache, cache_len)

    ``params`` is an ``LM`` on meta (``init_params(device="meta")``), its
    placements ``{name: placements}``; the other arguments are (dicts of)
    meta tensors with placements of the same structure."""
    params = T.init_params(cfg, dtype=dtype, device=META)
    pshard = S.param_shardings(params, mesh)

    seq_axis = cell.global_batch < _dp_size(mesh)  # long-context: shard seq
    if cell.kind == "train":
        opt = adamw_init(params)
        oshard = S.opt_shardings(pshard, mesh)
        batch = batch_sds(cfg, cell, decode=False, dtype=dtype)
        bshard = S.batch_shardings(batch, mesh)
        return "train", (params, opt, batch), (pshard, oshard, bshard)

    decode = cell.kind == "decode"
    batch = batch_sds(cfg, cell, decode=decode, dtype=dtype)
    if seq_axis:
        bshard = {k: S.placements(S.P(), mesh) for k in batch}
    else:
        bshard = S.batch_shardings(batch, mesh)
    cache = T.init_cache(cfg, cell.global_batch, cell.seq_len, dtype=dtype,
                         device=META)
    cshard = S.cache_shardings(cache, mesh, seq_axis=seq_axis)
    clen = _sds((cell.global_batch,), torch.int32)
    clen_shard = S.placements(S.P(), mesh)
    return cell.kind, (params, batch, cache, clen), \
        (pshard, bshard, cshard, clen_shard)


def activation_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """Role -> spec: the reference's ``activation_roles`` bindings."""
    dp = S._dp(mesh)
    roles = {}
    if cell.kind in ("train", "prefill") and cfg.seq_parallel:
        # sequence parallelism for the inter-layer hidden state
        roles["hidden"] = S.P(dp, "model", None)
    elif cell.kind in ("train", "prefill"):
        roles["hidden"] = S.P(dp, None, None)
    if cfg.family == "moe":
        roles["moe_dispatch"] = S.P(dp, "model", None, None)
        if cfg.seq_parallel:
            # boundary pin needed only when tokens arrive seq-sharded
            roles["moe_predispatch"] = S.P(dp, None, None, None)
    return roles


def _rows_spec(cell: ShapeCell, mesh) -> tuple:
    """The batch over the data and model axes together where it divides
    them, else over the data axes alone (the model axis replicates)."""
    model = S.axis_sizes(mesh).get("model", 1)
    if cell.global_batch < _dp_size(mesh):
        return S.P(None, None, None)                 # seq_axis cells
    dp = S._dp(mesh)
    dp_axes = dp if isinstance(dp, tuple) else ((dp,) if dp else ())
    if cell.global_batch % (_dp_size(mesh) * model) == 0:
        return S.P(dp_axes + ("model",), None, None)
    return S.P(dp, None, None)


def dtensor_specs(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """Role -> spec for the places where DTensor, unlike XLA's GSPMD,
    cannot keep a layout (the port's departures; ``PERF.md`` records their
    collective bytes), each laid out by ``_rows_spec``:

      attn_heads : q, k, v [B, T, heads x hd] and the attention output,
                   their model sharding moved off the heads: DTensor
                   cannot view uneven shards as heads (a model axis that
                   does not divide the query or KV heads), nor, in some
                   versions (torch 2.11), flatten the batch with a
                   sharded KV-head dim in the GQA einsums;
      moe_route  : the MoE routing's per-row sort (no sharding rule for
                   ``argsort`` and ``searchsorted``);
      ssm_scan   : the SSM scans' step loop;
      layer_in   : each sub-layer's normed input and the final normed
                   state, batch over the data axes: gathered over a
                   sequence-parallel hidden state's sequence (its
                   gradient reduce-scattered back) before a projection
                   flattens batch and sequence into a matmul's rows,
                   which DTensor refuses for a sharded sequence; partial
                   sums reduced;
      layer_out  : each sub-layer's output: reduce-scattered onto the
                   sequence-parallel hidden state (its gradient gathered
                   over the sequence before the projection's backward),
                   or reduced onto the batch layout;
      logits     : each loss chunk's logits, vocab gathered (DTensor's
                   masked gather over a sharded vocab fails), their
                   gradient back on the vocab shards;
      embed      : the vision stub's token embeddings, reduced over the
                   vocab shards (batch over the data axes) before they
                   are joined to the patch embeddings (DTensor cannot
                   concatenate its masked partial sums)."""
    rows = _rows_spec(cell, mesh)
    roles = {}
    if cfg.family != "ssm":
        roles["attn_heads"] = rows
    if cfg.family == "moe":
        roles["moe_route"] = rows
    if cfg.family in ("ssm", "hybrid"):
        roles["ssm_scan"] = rows
    batch = S.P(S._dp(mesh) if cell.global_batch >= _dp_size(mesh)
                else None, None, None)
    if cell.kind in ("train", "prefill") and cfg.seq_parallel:
        seq = activation_specs(cfg, cell, mesh)["hidden"]
        roles["layer_in"] = GradSpec(batch, seq)
        roles["layer_out"] = GradSpec(seq, batch)
    else:
        roles["layer_in"] = roles["layer_out"] = batch
    if cell.kind == "train":
        roles["logits"] = GradSpec(batch, S.P(batch[0], None, "model"))
    if cfg.modality == "vision_stub":
        roles["embed"] = batch
    return roles


def activation_roles(cfg: ArchConfig, cell: ShapeCell, mesh) -> dict:
    """Role -> ``(mesh, placements)`` bindings for
    ``repro_torch.runtime.actctx``: the reference's roles, then the
    port's own (``dtensor_specs``)."""
    out = {r: (mesh, S.placements(s, mesh))
           for r, s in activation_specs(cfg, cell, mesh).items()}
    for r, s in dtensor_specs(cfg, cell, mesh).items():
        specs = s if isinstance(s, GradSpec) else (s,)
        out[r] = (mesh, *(S.placements(x, mesh) for x in specs))
    return out
