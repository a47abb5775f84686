"""The packed-block refresh (``core/blocks.py::refresh_blocks``) and its
kernel, ``kernels.ops.refresh_walk``.

On the CPU the port's refresh runs the plain lock-step walk
(``kernels/ref.py::refresh_walk_ref``); it is held against the reference's
``repro.core.blocks.refresh_blocks`` bit for bit on crafted shard states
(``chip_smoke.refresh_case``), one case per way a dirty row's walk ends,
and each case must end its rows as built (valid bits, steps, the
``refresh_steps`` count). The CUDA kernel is compared with the plain
version by the ``gpu`` tests at the end, on the card, at small shapes, at
the main path's shape (``chip_smoke.RW_CELL``), on a second card where
there is one, and through ``refresh_blocks`` (one launch, no host read).
The reference is imported inside the test that uses it, so the ``gpu``
tests also run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_refresh_walk.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import timing
from repro_torch.core import blocks as TBL
from repro_torch.core import types as TT
from repro_torch.kernels import ops as TK

from torch_parity import assert_trees_equal


def _load_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()

# the CPU cases: M entries of C columns, N pool nodes, NC counter slots
SHAPE = dict(m=48, c=8, n=2048, nc=16, max_scan=40)


def tensors(args, device="cpu"):
    """``refresh_case``'s arrays as the wrapper's tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in args.items()}


def _cfg_kw(args):
    return dict(num_shards=2, pool_capacity=SHAPE["n"],
                max_sublists=SHAPE["m"], max_ctrs=SHAPE["nc"],
                max_scan=args["max_scan"], batch_size=8, mailbox_cap=32,
                block_cap=SHAPE["c"])


def _port_state(args, device="cpu"):
    """The crafted case as a port state on ``device``, and its config."""
    cfg = TT.DiLiConfig(**_cfg_kw(args))
    st = TT.init_shard(cfg, args["me"], device=device)
    t = tensors(args, device)
    st = st._replace(
        pool=st.pool._replace(key=t["key"], nxt=t["nxt"], ctr=t["ctr"],
                              newloc=t["newloc"]),
        stct=t["stct"],
        registry=st.registry._replace(subhead=t["subhead"],
                                      subtail=t["subtail"], ctr=t["reg_ctr"],
                                      size=t["size"]),
        blk=TT.Blocks(keys=t["keys"], idx=t["idx"], valid=t["valid"]))
    return st, cfg


def _ref_state(args):
    """The crafted case as a reference state, and its config."""
    jnp = pytest.importorskip("jax.numpy")
    JT = pytest.importorskip("repro.core.types")
    cfg = JT.DiLiConfig(**_cfg_kw(args))
    st = JT.init_shard(cfg, args["me"])

    def ref(name):
        return jnp.asarray(args[name].view(np.uint32))

    st = st._replace(
        pool=st.pool._replace(key=jnp.asarray(args["key"]), nxt=ref("nxt"),
                              ctr=jnp.asarray(args["ctr"]),
                              newloc=ref("newloc")),
        stct=jnp.asarray(args["stct"]),
        registry=st.registry._replace(subhead=ref("subhead"),
                                      subtail=ref("subtail"),
                                      ctr=jnp.asarray(args["reg_ctr"]),
                                      size=jnp.asarray(args["size"])),
        blk=JT.Blocks(keys=jnp.asarray(args["keys"]),
                      idx=jnp.asarray(args["idx"]),
                      valid=jnp.asarray(args["valid"])))
    return st, cfg


@pytest.mark.parametrize("rule", SMOKE.RW_RULES + ("all",))
def test_refresh_blocks_matches_reference(rule):
    """The port's refresh equals the reference's on a state whose dirty
    rows all end by ``rule`` (or by every rule in turn), beside clean
    rows, rows that fail the gate and rows past the registry's size; the
    rows end as built, and the span counts the longest walk."""
    JBL = pytest.importorskip("repro.core.blocks")
    rules = SMOKE.RW_RULES if rule == "all" else (rule,)
    args, want = SMOKE.refresh_case(**SHAPE, rules=rules,
                                    seed=SMOKE.RW_RULES.index(rules[-1]))
    assert any(r == rules[-1] for r in want["rule"])
    ref_st, jcfg = _ref_state(args)
    port_st, tcfg = _port_state(args)
    assert_trees_equal(ref_st, port_st, "input state")

    out_ref = JBL.refresh_blocks(ref_st, args["me"], jcfg)
    t = timing.PhaseTimer("cpu")
    with t("refresh_blocks"):
        out = TBL.refresh_blocks(port_st, args["me"], tcfg)
    assert_trees_equal(out_ref.blk, out.blk, "blk")
    assert_trees_equal(ref_st, port_st, "input state after")   # unwritten
    np.testing.assert_array_equal(out.blk.valid.numpy(), want["valid"])
    assert t.counts["refresh_blocks", "refresh_steps"] == \
        want["steps"].max()
    assert ("refresh_blocks", "host_reads") not in t.counts     # the CPU


def test_refresh_walk_plain_steps_per_row():
    """The plain version's per-row steps are each walk's own length."""
    args, want = SMOKE.refresh_case(**SHAPE, seed=11)
    keys, idx, valid, steps = TK.refresh_walk(**tensors(args))
    np.testing.assert_array_equal(steps.numpy(), want["steps"])
    np.testing.assert_array_equal(valid.numpy(), want["valid"])
    walked = want["steps"] > 0
    assert walked.sum() > 0
    # rows that do not walk keep their old keys and indices
    for got, old in ((keys, args["keys"]), (idx, args["idx"])):
        np.testing.assert_array_equal(got.numpy()[~walked], old[~walked])


def _bad_input(case):
    args = tensors(SMOKE.refresh_case(**SHAPE, seed=1)[0])
    if case == "dtype":
        args["key"] = args["key"].long()
    elif case == "valid_dtype":
        args["valid"] = args["valid"].to(torch.int32)
    elif case == "shape":
        args["idx"] = args["idx"][:, :-1].contiguous()
    elif case == "size_shape":
        args["size"] = args["size"].reshape(1)
    elif case == "pool_shape":
        args["nxt"] = args["nxt"][:-1]
    elif case == "device":
        args["stct"] = args["stct"].to("meta")
    elif case == "contiguous":
        args["keys"] = args["keys"].t().contiguous().t()
    elif case == "tensor":
        args["subtail"] = args["subtail"].tolist()
    elif case == "me":
        args["me"] = 2**31
    elif case == "empty":
        args["keys"] = args["keys"][:, :0]
        args["idx"] = args["idx"][:, :0]
    return args


@pytest.mark.parametrize("case,error", [
    ("dtype", TypeError), ("valid_dtype", TypeError), ("shape", ValueError),
    ("size_shape", ValueError), ("pool_shape", ValueError),
    ("device", ValueError), ("contiguous", ValueError),
    ("tensor", TypeError), ("me", ValueError), ("empty", ValueError)])
def test_refresh_walk_wrapper_checks_inputs(case, error):
    before = TK.refresh_walk.launches
    with pytest.raises(error, match="refresh_walk"):
        TK.refresh_walk(**_bad_input(case))
    assert TK.refresh_walk.launches == before


# ------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc for "
                    "sm_90a and runs only on the GPU")
    return torch.device("cuda:0")


def _vs_plain(args, want):
    """One kernel call against the plain version on the same card: keys,
    idx, valid and per-row steps bit for bit, as the case was built; one
    launch counted; the inputs unwritten."""
    before = {k: v.clone() for k, v in args.items()
              if isinstance(v, torch.Tensor)}
    n0 = TK.refresh_walk.launches
    got = TK.refresh_walk(**args)
    assert TK.refresh_walk.launches == n0 + 1
    ref = TK.refresh_walk_ref(**args)
    torch.cuda.synchronize()
    for name, a, b in zip(("keys", "idx", "valid", "steps"), got, ref):
        assert a.device == args["key"].device, name
        assert a.dtype == b.dtype and torch.equal(a, b), name
    np.testing.assert_array_equal(got[2].cpu().numpy(), want["valid"])
    np.testing.assert_array_equal(got[3].cpu().numpy(), want["steps"])
    for k, v in before.items():
        assert torch.equal(args[k], v), f"{k} was written"


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rule", SMOKE.RW_RULES + ("all",))
def test_cuda_refresh_walk_matches_plain(cuda_device, rule, seed):
    rules = SMOKE.RW_RULES if rule == "all" else (rule,)
    args, want = SMOKE.refresh_case(**SHAPE, rules=rules, seed=seed)
    _vs_plain(tensors(args, cuda_device), want)


@pytest.mark.gpu
def test_cuda_refresh_walk_cell_shape(cuda_device):
    """M 16,384, C 160, a 2**21-node pool: ~190 dirty rows, every rule."""
    args, want = SMOKE.refresh_case(**SMOKE.RW_CELL, seed=5)
    _vs_plain(tensors(args, cuda_device), want)


@pytest.mark.gpu
def test_cuda_refresh_walk_wide_rows(cuda_device):
    """C 2,000 stages 64 KB a block (above the default 48 KB of shared
    memory); C 8,000 is more than a block holds, and raises."""
    args, want = SMOKE.refresh_case(64, 2000, 1 << 16, 64, 2100, seed=2)
    _vs_plain(tensors(args, cuda_device), want)
    args, _ = SMOKE.refresh_case(8, 8000, 1 << 15, 8, 8, seed=2)
    with pytest.raises(RuntimeError, match="refresh_walk launch failed"):
        TK.refresh_walk(**tensors(args, cuda_device))


@pytest.mark.gpu
def test_cuda_refresh_walk_on_second_card(cuda_device):
    """Inputs on cuda:1 while cuda:0 is current: the launch goes there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    args, want = SMOKE.refresh_case(**SMOKE.RW_CELL, seed=9)
    with torch.cuda.device(0):
        _vs_plain(tensors(args, torch.device("cuda:1")), want)


@pytest.mark.gpu
def test_cuda_refresh_blocks_one_launch_no_host_read(cuda_device):
    """Untimed, ``refresh_blocks`` is one launch and no synchronising
    read; under a span it reads the longest walk once."""
    args, want = SMOKE.refresh_case(**SHAPE, seed=4)
    st, tcfg = _port_state(args, cuda_device)
    n0 = TK.refresh_walk.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = TBL.refresh_blocks(st, args["me"], tcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert TK.refresh_walk.launches == n0 + 1
    np.testing.assert_array_equal(out.blk.valid.cpu().numpy(), want["valid"])
    t = timing.PhaseTimer(cuda_device)
    with t("refresh_blocks"):
        TBL.refresh_blocks(st, args["me"], tcfg)
    assert t.counts["refresh_blocks", "refresh_steps"] == want["steps"].max()
    assert t.counts["refresh_blocks", "host_reads"] == 1

