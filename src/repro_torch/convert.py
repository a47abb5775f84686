"""Carry state and weights between the reference package and the port.

``params_from_numpy`` builds the port's ``LM`` (any family) from the
reference's parameter tree (``models.transformer.init_params``) as numpy
arrays, with its layer-stacked ``blocks``, so both packages compute with
the same weights; ``params_to_numpy`` is the way back, and
``numpy_params`` draws such a tree with numpy alone. The optimizer state
goes both ways too (``opt_state_to_numpy`` / ``opt_state_from_numpy``: the
reference's ``{"mu", "nu", "step"}`` with ``mu`` and ``nu`` shaped as the
parameter tree), so a training checkpoint (``{"params", "opt"}``) written
by either package restores in the other; ``template_tree`` /
``opt_state_template`` give such a restore its structure without copying
off the device, and ``load_params_`` / ``load_opt_state_`` copy the
restored tree into a live model and state in place. A port parameter
``blocks.<i>.<path>`` is layer ``i`` of the reference's stacked
``blocks/<path>``; every other name is the reference's path with ``.``
for ``/``.

The DiLi protocol's counterpart of carrying weights across is a shard's
state. ``*_to_numpy`` turns a state — the port's tensors, or the
reference's arrays — into nested dicts of numpy arrays keyed by field
name; ``shard_state_from_numpy`` / ``bg_table_from_numpy`` build the
port's tensors on a device from such dicts. The reference's uint32 ref
columns (``pool.nxt``, ``pool.newloc``, ``registry.subhead``,
``registry.subtail``, ``BgTable.sh_star``/``st_star``) become their int32
bit patterns (``.view(np.int32)``); every other leaf keeps its dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bg.fsm import BgState
from .models.config import ArchConfig
from .models.ssm import dt_rank
from .models.transformer import LM
from .optim import adamw_init
from .core.types import (Blocks, Pool, Registry, ReplicaSlots, RepSessions,
                         ShardState, resolve_device)

_NESTED = {"pool": Pool, "registry": Registry, "blk": Blocks,
           "rep": RepSessions, "rslots": ReplicaSlots}


def to_numpy(tree):
    """A nested NamedTuple of arrays or tensors as nested dicts of numpy
    arrays (uint32 leaves as their int32 bit patterns)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_numpy(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    arr = np.array(tree)
    return arr.view(np.int32) if arr.dtype == np.uint32 else arr


shard_state_to_numpy = to_numpy
bg_table_to_numpy = to_numpy


def _leaf(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype not in (np.int32, np.bool_):
        raise TypeError(f"unexpected leaf dtype {arr.dtype}")
    # np.array keeps 0-d leaves 0-d (ascontiguousarray would not)
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def _build(cls, d, device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(*(_build(_NESTED[f], d[f], device) if f in _NESTED
                 and cls is ShardState else _leaf(d[f], device)
                 for f in cls._fields))


def shard_state_from_numpy(d: dict, device="cuda") -> ShardState:
    """A port ``ShardState`` on ``device`` from nested numpy dicts."""
    return _build(ShardState, d, resolve_device(device))


def bg_table_from_numpy(d: dict, device="cuda") -> BgState:
    """A port ``BgTable`` on ``device`` from a dict of numpy arrays."""
    return _build(BgState, d, resolve_device(device))


def _ref_path(name: str):
    """(reference path, layer or None) of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ["blocks"] + parts[2:], int(parts[1])
    return parts, None


def _get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set_path(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def named_to_tree(named: dict) -> dict:
    """The reference's nested parameter tree, numpy, layers stacked, from
    ``{port name: tensor or array}`` (in layer order, as
    ``named_parameters`` yields them)."""
    tree, stacks = {}, {}
    for name, x in named.items():
        arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
        path, layer = _ref_path(name)
        if layer is None:
            _set_path(tree, path, arr.copy())
        else:
            stacks.setdefault(tuple(path), []).append(arr)
    for path, arrs in stacks.items():
        _set_path(tree, path, np.stack(arrs))
    return tree


def tree_to_named(tree: dict, names) -> dict:
    """``{port name: numpy array}`` for ``names`` from the reference's
    nested parameter tree (the inverse of ``named_to_tree``)."""
    out = {}
    for name in names:
        path, layer = _ref_path(name)
        arr = np.asarray(_get_path(tree, path))
        out[name] = arr if layer is None else arr[layer]
    return out


def params_to_numpy(model: LM) -> dict:
    """The reference's parameter tree (numpy) holding ``model``'s
    weights."""
    return named_to_tree(dict(model.named_parameters()))


def _host_dtype(t: torch.Tensor) -> np.dtype:
    # a checkpoint holds bfloat16 leaves as float32 (``checkpoint._host``)
    if t.dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=t.dtype).numpy().dtype


def template_tree(named: dict) -> dict:
    """``named_to_tree``'s structure, shapes and dtypes for
    ``{port name: tensor}``, with leaves that hold one element each
    (zero-stride views): a restore template that copies nothing off the
    device."""
    tree, stacks = {}, {}
    for name, t in named.items():
        path, layer = _ref_path(name)
        leaf = (tuple(t.shape), _host_dtype(t))
        if layer is None:
            _set_path(tree, path, np.broadcast_to(np.zeros((), leaf[1]),
                                                  leaf[0]))
        else:
            stacks.setdefault(tuple(path), [0, leaf])[0] += 1
    for path, (n, (shape, dt)) in stacks.items():
        _set_path(tree, list(path), np.broadcast_to(np.zeros((), dt),
                                                    (n, *shape)))
    return tree


@torch.no_grad()
def _load_named_(named: dict, tree: dict, what: str) -> None:
    for name, arr in tree_to_named(tree, named).items():
        dst = named[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: {name} shape {arr.shape} "
                             f"vs {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, order="C")))


def load_params_(model: LM, tree: dict) -> LM:
    """Copy the reference's parameter tree (numpy) into ``model``'s
    weights in place."""
    _load_named_(dict(model.named_parameters()), tree, "load_params_")
    return model


def params_from_numpy(tree: dict, cfg: ArchConfig, *, dtype=None,
                      device="cuda") -> LM:
    """A port ``LM`` of ``cfg``'s family on ``device`` from the
    reference's parameter tree as nested dicts of numpy arrays:
    ``embed`` [V, D], ``final_norm``, optional ``lm_head`` and
    ``shared`` (hybrid), and ``blocks`` with a leading layer axis
    (``ln1``, then ``attn``, ``ln2`` and ``mlp`` or ``moe`` — experts
    [L, E, D, F] — or ``mamba``). ``dtype`` defaults to the tree's; the
    leaves the reference keeps in f32 (the router, ``a_log``...) stay
    f32."""
    if dtype is None:
        dtype = torch.from_numpy(
            np.zeros((0,), np.asarray(tree["embed"]).dtype)).dtype
    return load_params_(LM(cfg, dtype=dtype, device=device), tree)


def numpy_params(cfg: ArchConfig, seed: int) -> dict:
    """Weights of ``cfg``'s family in the reference's parameter tree
    (layers stacked), f32, drawn by numpy from ``seed``: each matrix
    Normal(0, 1/fan_in), the embedding Normal(0, 1/d_model), norm scales
    1 + 0.1 Normal, biases 0.02 Normal, and the SSM blocks' fixed inits
    (``a_log``, ``dt_bias``, ``d_skip``) jittered by 0.1 Normal — one set
    of weights for both packages. The attention families draw the
    attention weights, the embedding, the norms, then the FFN, the final
    norm and the head, in that order (the constants recorded from these
    weights depend on it)."""
    rng = np.random.default_rng(seed)
    n, d = cfg.n_layers, cfg.d_model

    def w(*shape, scale=None):
        scale = shape[-2] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def near(value, *shape, scale=0.1):
        return (value + scale * rng.standard_normal(shape)).astype(
            np.float32)

    def attn(*lead):
        q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
        a = {"wq": w(*lead, d, q), "wk": w(*lead, d, kv),
             "wv": w(*lead, d, kv), "wo": w(*lead, q, d)}
        if cfg.qkv_bias:
            a |= {"bq": w(*lead, q, scale=0.02),
                  "bk": w(*lead, kv, scale=0.02),
                  "bv": w(*lead, kv, scale=0.02)}
        return a

    def mlp(*lead):
        f = cfg.d_ff
        return {"w_gate": w(*lead, d, f), "w_up": w(*lead, d, f),
                "w_down": w(*lead, f, d)}

    if cfg.family in ("ssm", "hybrid"):
        tree = {"embed": w(cfg.vocab, d, scale=d ** -0.5)}
        s = cfg.ssm
        di = s.expand * d
        if s.version == 1:
            r = dt_rank(cfg)
            mamba = {"in_proj": w(n, d, 2 * di),
                     "conv_w": w(n, s.conv_width, di),
                     "conv_b": w(n, di, scale=0.02),
                     "x_bc": w(n, di, r + 2 * s.state),
                     "dt_proj": w(n, r, di),
                     "dt_bias": near(-4.6, n, di),
                     "a_log": near(np.log(np.arange(1, s.state + 1)), n, di,
                                   s.state),
                     "d_skip": near(1.0, n, di),
                     "out_proj": w(n, di, d)}
        else:
            nh = di // s.head_dim
            mamba = {"in_proj": w(n, d, 2 * di + 2 * s.state + nh),
                     "conv_w": w(n, s.conv_width, di + 2 * s.state),
                     "conv_b": w(n, di + 2 * s.state, scale=0.02),
                     "a_log": near(np.log(np.linspace(1.0, 16.0, nh)), n,
                                   nh),
                     "dt_bias": near(-4.6, n, nh),
                     "d_skip": near(1.0, n, nh),
                     "norm_scale": near(1.0, n, di),
                     "out_proj": w(n, di, d)}
        tree["blocks"] = {"ln1": near(1.0, n, d), "mamba": mamba}
    else:
        blk = {"attn": attn(n)}
        tree = {"embed": w(cfg.vocab, d, scale=d ** -0.5)}
        blk |= {"ln1": near(1.0, n, d), "ln2": near(1.0, n, d)}
        if cfg.family == "moe":
            m = cfg.moe
            e, f = m.n_experts, m.d_ff_expert
            blk["moe"] = {"router": w(n, d, e), "w_gate": w(n, e, d, f),
                          "w_up": w(n, e, d, f), "w_down": w(n, e, f, d)}
        else:
            blk["mlp"] = mlp(n)
        tree["blocks"] = blk
    tree["final_norm"] = near(1.0, d)
    if not cfg.tie_embeddings:
        tree["lm_head"] = w(d, cfg.vocab)
    if cfg.family == "hybrid":
        tree["shared"] = {"ln1": near(1.0, d), "attn": attn(),
                          "ln2": near(1.0, d), "mlp": mlp()}
    return tree


def opt_state_to_numpy(state: dict) -> dict:
    """The reference's AdamW state tree (numpy) from the port's
    (``optim.adamw_init``)."""
    return {"mu": named_to_tree(state["mu"]),
            "nu": named_to_tree(state["nu"]),
            "step": state["step"].detach().cpu().numpy().astype(np.int32)}


def opt_state_template(state: dict) -> dict:
    """``opt_state_to_numpy``'s structure with ``template_tree`` leaves."""
    return {"mu": template_tree(state["mu"]),
            "nu": template_tree(state["nu"]),
            "step": np.zeros((), np.int32)}


def load_opt_state_(state: dict, tree: dict) -> dict:
    """Copy the reference's AdamW state tree into the port's ``state``
    (``optim.adamw_init``) in place."""
    for k in ("mu", "nu"):
        _load_named_(state[k], tree[k], "load_opt_state_")
    state["step"].fill_(int(np.asarray(tree["step"])))
    return state


def opt_state_from_numpy(tree: dict, model: LM) -> dict:
    """The port's AdamW state for ``model`` (on its device) from the
    reference's state tree."""
    return load_opt_state_(adamw_init(model), tree)
