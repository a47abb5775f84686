"""Shard placement of the port's SPMD path (``core.distributed.placement``
and ``ShardMapBackend``'s per-shard state), port only.

On the CPU: the placement rule; the cards a ``PhaseTimer`` waits for;
every leaf of shard ``s`` and its inbox on ``placement[s]`` after a few
rounds; and the balance commands on shard ``s`` leaving every other
shard's tensors as the same objects. The stacked round the
``tests/test_torch_distributed*.py`` parity tests call runs the placed
round with every shard on one device, so those tests hold the placed
round to the reference. A ``gpu`` test spreads the round over the cards
present (two or more) against all shards on ``cuda:0``, and launches
``hybrid_search`` on a card that is not the current one.
"""
import importlib.util

import pytest
import torch

import torch_spmd as W
from torch_parity import named_leaves
from repro_torch.api import ShardMapBackend
from repro_torch.core import distributed as D
from repro_torch.core import messages as M
from repro_torch.core.sim import Cluster
from repro_torch.core.types import DiLiConfig, OP_INSERT, tree_map
from repro_torch.timing import PhaseTimer

CFG = DiLiConfig(**W.SCRIPT_CFG)


def _leaves(tree):
    return [x for _, x in named_leaves(tree)]


# ---------------------------------------------------------- placement rule

def test_placement_takes_an_explicit_list():
    devs = D.placement(CFG, devices=["cpu", "cpu", torch.device("cpu"),
                                     "cpu"])
    assert devs == [torch.device("cpu")] * 4


@pytest.mark.parametrize("n", [3, 5])
def test_placement_of_the_wrong_length_raises(n):
    with pytest.raises(ValueError, match="one per shard"):
        D.placement(CFG, devices=["cpu"] * n)


def test_placement_on_the_cpu():
    assert D.placement(CFG, "cpu") == [torch.device("cpu")] * 4


def test_placement_folds_shards_onto_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert D.placement(CFG, "cuda") == [cuda[0], cuda[1], cuda[2], cuda[0]]
    assert D.placement(CFG, "cuda:2") == [cuda[2]] * 4
    assert D.placement(CFG, devices=["cuda:1", "cuda:1", "cpu",
                                     "cuda:0"]) == \
        [cuda[1], cuda[1], torch.device("cpu"), cuda[0]]


@pytest.mark.parametrize("kw", [dict(device="cuda"),
                                dict(device="cuda:1"),
                                dict(devices=["cpu", "cpu", "cuda", "cpu"])])
def test_placement_on_cuda_without_a_card_raises(monkeypatch, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.placement(CFG, **kw)


# ------------------------------------------------------------ placed round

def placed_rounds(devices) -> list:
    """``torch_spmd.routed_run``'s 38 rounds through the placed round,
    shard ``s`` on ``devices[s]``: per-round digests of all nine outputs,
    the per-shard trees restacked on the host as the stacked call
    returns them."""
    P = W.pkg("torch")
    feeds, _ = W.script_feed(P)
    sim = Cluster(CFG, device="cpu")
    states = [tree_map(lambda x: x.to(d), st)
              for st, d in zip(sim.states, devices)]
    bgs = [tree_map(lambda x: x.to(d), bg) for bg, d in zip(sim.bgs, devices)]
    inbox = [torch.zeros((4 * W.CAP_PAIR, P.M.FIELDS), dtype=torch.int32,
                         device=d) for d in devices]
    rnd = D.make_dili_round(CFG, cap_pair=W.CAP_PAIR, placed=True)
    rounds = []
    for client in feeds:
        out = rnd(states, bgs, inbox, torch.as_tensor(client))
        states, bgs, inbox = out.states, out.bgs, out.inbox
        for s, d in enumerate(devices):
            assert all(x.device == d for x in _leaves((states[s], bgs[s],
                                                       inbox[s])))
        host = [[tree_map(torch.Tensor.cpu, t) for t in x]
                for x in (states, bgs, inbox)]
        st, bg = D.stack_states(host[0], host[1])
        rounds.append(W.output_digests(
            out._replace(states=st, bgs=bg, inbox=torch.stack(host[2]))))
    return rounds


@pytest.mark.parametrize("device, want", [
    ("cpu", []),
    ("cuda", [torch.device("cuda")]),
    (["cpu"] * 4, []),
    ([torch.device("cuda", i) for i in (0, 1, 0, 1)],
     [torch.device("cuda", 0), torch.device("cuda", 1)]),
])
def test_phase_timer_synchronizes_only_its_cards(device, want):
    timer = PhaseTimer(device)
    assert timer.devices == want
    assert timer.sync == bool(want)


# ---------------------------------------------------------- ShardMapBackend

def _loaded_backend(cfg=CFG):
    """Forty keys on shard 0 and six rounds."""
    backend = ShardMapBackend(cfg, devices=["cpu"] * 4)
    backend.submit(0, [OP_INSERT] * 40, list(range(5, 205, 5)))
    for _ in range(6):
        backend.step()
    return backend


def test_backend_keeps_each_shard_on_its_device():
    backend = _loaded_backend()
    assert backend.placement == [torch.device("cpu")] * 4
    assert len(backend._states) == len(backend._bgs) == 4
    assert len(backend._inbox) == 4
    for s, dev in enumerate(backend.placement):
        for x in _leaves((backend._states[s], backend._bgs[s],
                          backend._inbox[s])):
            assert x.device == dev
        assert tuple(backend._inbox[s].shape) == (backend.in_cap, M.FIELDS)


def _ids(backend, s):
    return [id(x) for x in _leaves((backend._states[s], backend._bgs[s]))]


@pytest.mark.parametrize("cmd", ["split", "move", "merge", "replicate"])
def test_balance_commands_touch_only_their_shard(cmd):
    cfg = DiLiConfig(**W.REPLICA_CFG) if cmd == "replicate" else CFG
    backend = _loaded_backend(cfg)
    if cmd == "merge":
        big = max(backend.sublists(0), key=lambda e: e["size"])
        backend.split(0, big["keymax"],
                      backend.middle_item(0, big["head_idx"]))
        while not backend.quiescent():
            backend.step()
    owned = [e for e in backend.sublists(0) if e["owner"] == 0]
    before = {s: _ids(backend, s) for s in range(4)}
    if cmd == "split":
        e = owned[0]
        ok = backend.split(0, e["keymax"],
                           backend.middle_item(0, e["head_idx"]))
    elif cmd == "move":
        ok = backend.move(0, owned[0]["keymax"], 2)
    elif cmd == "merge":
        ok = backend.merge(0, owned[0]["keymax"], owned[1]["keymax"])
    else:
        ok = backend.replicate(0, owned[0]["keymax"], 1)
    assert ok
    for s in (1, 2, 3):
        assert _ids(backend, s) == before[s], f"shard {s} was touched"
    assert _ids(backend, 0) != before[0]


# --------------------------------------------------------------- the cards

@pytest.fixture
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards, found {n}: spreads the "
                    f"shards over cards")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.gpu
def test_spread_round_equals_one_card(cards):
    spread = [cards[s % len(cards)] for s in range(4)]
    assert placed_rounds(spread) == placed_rounds([cards[0]] * 4)


@pytest.mark.gpu
def test_hybrid_search_on_a_card_that_is_not_current(cards):
    from repro_torch.kernels import ops as K
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", W.ROOT / "chip_smoke.py")
    SMOKE = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(SMOKE)

    keymin, blocks, q = (torch.from_numpy(a) for a in
                         SMOKE.hs_edge_case(64, 32, 4096, seed=7))
    want = K.hybrid_search_ref(keymin, blocks, q)
    dev = cards[-1]
    with torch.cuda.device(cards[0]):
        n0 = K.hybrid_search.launches
        got = K.hybrid_search(keymin.to(dev), blocks.to(dev), q.to(dev))
        torch.cuda.synchronize(dev)
    assert K.hybrid_search.launches == n0 + 1
    assert all(x.device == dev for x in got)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
