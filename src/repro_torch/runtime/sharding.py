"""Logical-axis sharding rules (the reference's ``runtime/sharding.py``):
specs per mesh for the parameters, the optimizer state, the batch and the
decode caches, and their DTensor placements.

Strategy, as the reference's:
  * FSDP over ``data``: every weight matrix shards its d_model-sized axis
    over the data axis for storage; the step gathers it on use and
    reduce-scatters its gradient.
  * TP over ``model``: heads / ffn / vocab / experts axes.
  * ``pod`` (multi-pod mesh) is pure DP: the batch shards over it,
    parameters are replicated across pods.

A spec is a tuple with, per tensor dim, the mesh-axis name, a tuple of
names (that dim shards over those mesh dims, major first), or ``None``
(``P(...)`` below builds one, as ``jax.sharding.PartitionSpec`` does;
``()`` replicates). ``placements(spec, mesh)`` turns it into the
``Shard``/``Replicate`` list that ``distribute_tensor`` takes for a
``DeviceMesh`` whose dim names are the axis names. ``_RULES`` and
``spec_for`` are the reference's, verbatim; they match the reference's
parameter paths (``blocks/attn/wq``), which ``param_specs`` derives from
the port's names (``blocks.3.attn.wq``). The port's weights are per layer,
with no leading layer-stack dim; the rules apply to trailing dims, so the
specs are the reference's with that dim dropped.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import torch

from ..convert import _ref_path


def P(*axes) -> tuple:
    """A spec: one entry per tensor dim (trailing dims may be left out)."""
    return tuple(axes)


# (path regex, candidate spec builders) — d = data axis, m = model axis.
# Candidates are tried in order; the first whose assigned dims all divide
# the axis sizes wins (e.g. 40-expert MoE cannot shard experts 16-way, so
# EP falls back to sharding the expert FFN dim instead).
# Specs are given per *trailing* dims (ignoring a leading layer-stack dim,
# which is always unsharded).
_RULES: Tuple[Tuple[str, Tuple[Tuple[Optional[str], ...], ...]], ...] = (
    # embeddings / lm head: vocab over model, d_model over data
    (r"embed$", (("m", "d"),)),
    (r"lm_head$", (("d", "m"),)),
    # attention
    (r"attn/w[qkv]$", (("d", "m"),)),
    (r"attn/wo$", (("m", "d"),)),
    (r"attn/b[qkv]$", (("m",), (None,))),
    # dense mlp
    (r"mlp/w_(gate|up)$", (("d", "m"),)),
    (r"mlp/w_down$", (("m", "d"),)),
    # moe: experts over model (EP); fallback = TP inside each expert
    (r"moe/router$", (("d", None),)),
    (r"moe/w_(gate|up)$", (("m", "d", None), (None, "d", "m"))),
    (r"moe/w_down$", (("m", None, "d"), (None, "m", "d"))),
    # mamba: channel dims over model
    (r"mamba/in_proj$", (("d", "m"),)),
    (r"mamba/out_proj$", (("m", "d"),)),
    (r"mamba/x_bc$", (("m", None),)),
    (r"mamba/dt_proj$", ((None, "m"),)),
    (r"mamba/conv_w$", ((None, "m"),)),
    (r"mamba/(conv_b|dt_bias|a_log|d_skip|norm_scale)$", (("m",), (None,))),
    # norms: replicated
    (r"(ln1|ln2|final_norm|norm_scale)$", ((None,),)),
)


def spec_for(path: str, shape, *, data_axis, model_axis,
             axis_sizes) -> tuple:
    ndim = len(shape)
    for pat, candidates in _RULES:
        if not re.search(pat, path):
            continue
        for axes in candidates:
            spec = [None] * ndim
            trail = len(axes)
            off = ndim - trail
            use = axes[-ndim:] if off < 0 else axes
            off = max(off, 0)
            ok = True
            for i, a in enumerate(use):
                name = data_axis if a == "d" else (
                    model_axis if a == "m" else None)
                if name is None:
                    continue
                if shape[off + i] % axis_sizes.get(name, 1) != 0:
                    ok = False
                    break
                spec[off + i] = name
            if ok:
                return P(*spec)
        return P()  # no candidate divides: replicate
    return P()  # replicate


# ------------------------------------------------------------- the mesh

def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp(mesh):
    """The batch axes: ``("pod", "data")`` jointly, ``"data"``, or None."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def placements(spec, mesh) -> list:
    """``distribute_tensor``'s placements for ``spec`` on ``mesh``: for
    each mesh dim, ``Shard(d)`` where tensor dim ``d`` names that axis
    (alone or in a tuple), else ``Replicate()``. A dim named by a tuple
    shards over those mesh dims in mesh order, which is the tuple's
    major-to-minor order for every spec these rules make."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec}: mesh axis {name!r} on dims "
                             f"{dims}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


# ----------------------------------------------------------- parameters

def _tree_paths(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _tree_paths(v, path)
        else:
            yield path, v


def _set(tree, path, value):
    *head, leaf = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[leaf] = value


def param_specs(params, mesh) -> dict:
    """Specs for a model's parameters, or for a ``{name: tensor}`` dict
    of them (AdamW's moments), ``{port name: spec}`` by the reference's
    path of each name; or, for a nested dict in the reference's tree
    (layers stacked: ``blocks/attn/wq`` is [L, D, H·hd], as a checkpoint
    holds it), the same nested dict of specs."""
    names = mesh.mesh_dim_names
    kw = dict(data_axis="data" if "data" in names else None,
              model_axis="model" if "model" in names else None,
              axis_sizes=axis_sizes(mesh))
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    if any(isinstance(v, dict) for v in params.values()):
        out = {}
        for path, t in _tree_paths(params):
            _set(out, path, spec_for(path, tuple(t.shape), **kw))
        return out
    return {n: spec_for("/".join(_ref_path(n)[0]), tuple(t.shape), **kw)
            for n, t in params.items()}


def param_shardings(params, mesh) -> dict:
    """``param_specs`` with each spec as its placements."""
    def conv(x):
        return ({k: conv(v) for k, v in x.items()} if isinstance(x, dict)
                else placements(x, mesh))
    return conv(param_specs(params, mesh))


# ---------------------------------------------------------------- batch

def batch_spec(mesh) -> tuple:
    """Batch dim over (pod, data) jointly."""
    return P(_dp(mesh))


def batch_shardings(batch, mesh) -> dict:
    bs = placements(batch_spec(mesh), mesh)
    return {k: bs for k in batch}


# --------------------------------------------------------------- caches

def cache_specs(cache, mesh, *, seq_axis: bool = False) -> dict:
    """Decode-cache specs, keyed by cache entry name.

      k/v  : [L, B, S, KH, D] — batch over DP, KV heads over model; with
             ``seq_axis=True`` (long-context, batch=1) the sequence dim
             shards over ``data`` instead (context parallelism).
      conv : [L, B, W-1, C]   — channels over model.
      ssm  : [L, B, C, N] or [L, B, H, P, N] — channels/heads over model.
    """
    dp = _dp(mesh)
    model_size = axis_sizes(mesh).get("model", 1)

    def one(name, x):
        nd = x.dim()
        bdim = None if seq_axis else dp
        if name in ("k", "v"):
            # KV heads over model when divisible, else sequence over model
            # (GQA archs with few KV heads); long-context additionally
            # shards the sequence over data (seq_axis).
            kh = x.shape[3]
            sdim = dp if seq_axis else None
            if kh % model_size == 0:
                return P(None, bdim, sdim, "model", None)
            if seq_axis:
                return P(None, bdim, ("data", "model")
                         if "data" in mesh.mesh_dim_names else "model",
                         None, None)
            return P(None, bdim, "model", None, None)
        if name in ("k_scale", "v_scale"):   # [L, B, S, KH]
            kh = x.shape[3]
            if kh % model_size == 0:
                return P(None, bdim, dp if seq_axis else None, "model")
            return P(None, bdim, "model", None)
        if name == "conv":
            return P(None, bdim, None, "model")
        if name == "ssm":
            if nd == 5:                      # [L, B, H, P, N]
                return P(None, bdim, "model", None, None)
            return P(None, bdim, "model", None)
        return P()

    return {n: one(n, x) for n, x in cache.items()}


def cache_shardings(cache, mesh, *, seq_axis: bool = False) -> dict:
    return {n: placements(s, mesh)
            for n, s in cache_specs(cache, mesh, seq_axis=seq_axis).items()}


# ------------------------------------------------------------ distribute

def distribute(tree, shardings, mesh):
    """``distribute_tensor`` of every tensor of a ``{name: tensor}`` dict
    (or a tensor) onto its placements in ``shardings``."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, shardings)
    return {k: distribute_tensor(v, mesh, shardings[k])
            for k, v in tree.items()}


def distribute_params_(model, mesh, shardings=None):
    """Replace every parameter of ``model`` by a DTensor parameter on
    ``mesh`` (``param_shardings`` unless ``shardings`` is given), keeping
    ``requires_grad``. Returns the model."""
    from torch.distributed.tensor import distribute_tensor
    shardings = shardings or param_shardings(model, mesh)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, shardings[name]),
            requires_grad=p.requires_grad))
    return model


def opt_shardings(pshard: dict, mesh) -> dict:
    """AdamW state placements: the moments as the parameters, the step
    replicated."""
    return {"mu": pshard, "nu": pshard,
            "step": placements(P(), mesh)}


def distribute_opt_state(state: dict, pshard: dict, mesh) -> dict:
    o = opt_shardings(pshard, mesh)
    return {"mu": distribute(state["mu"], o["mu"], mesh),
            "nu": distribute(state["nu"], o["nu"], mesh),
            "step": distribute(state["step"], o["step"], mesh)}
