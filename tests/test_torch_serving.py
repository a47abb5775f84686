"""The port's paged serving path against the reference on the CPU, f32,
with the reference's weights carried across by ``repro_torch.convert``.

S1  ``paged_decode_step`` (``use_kernel`` on and off) against the
    reference's on identical inputs, with a ``-1`` sentinel row: logits
    within 1e-4, the new tokens' K/V written where the reference writes
    them (within 1e-5: f32 projections summed in another order), every
    other page cell — the sentinel row's target included — unchanged.
S2  A whole ``ServingEngine`` run on one DiLi shard, idle sequences
    padding the page index past the balancer's split threshold, with
    ``step(rebalance=True)`` healing the snapshot by RANGE and by rescan:
    greedy tokens, every page table handed to the decode step, the
    manager's ``_table``, the sublists and the DiLi stats equal the
    reference's, and the run really split and healed.
S2b The chip smoke's serving run (``chip_smoke.SERVE``: 8 live requests of
    256-512 prompt tokens, 32 parked sequences, page size 16, 24 steps,
    a rebalance every 4th, the parked index settled over the shards
    first in the migrating modes) over a two-shard DiLi page index, with
    the smoke-size Qwen2-0.5B: the port's static, rescan and range modes
    give the reference's static tokens, the range runs' DiLi stats and
    Move commands equal the reference's, and page-index sublists moved
    between the shards during the decode steps. (The reference's own
    range run loses page slots on delegated INSERTs; see the test.)
S3  The guards: ``PagePoolExhausted``, ``BatchOverflow``, double
    allocation, ``free_seq`` recycling, the sentinel and the
    never-allocated ``KeyError``; entry points default to CUDA.
S4  The engine serves the dense text family only, as the reference's
    really does (ROADMAP Queue 3 item 6): a moe or vlm smoke config, or
    the int8 KV cache, raises ``ValueError`` at construction (the
    reference fails with a ``KeyError`` inside admission or a decode
    step for moe and vlm and, with ``kv_quant``, decodes its int8 codes
    as floats).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro.serving import paged as JP
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from repro_torch.serving import paged as TP

ARCH = "qwen2_5_3b"


@pytest.fixture(scope="module")
def models():
    cfg_j = j_smoke(ARCH)
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    cfg_t = get_smoke_config(ARCH)
    params_t = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


# ------------------------------------------------------------------ S1

@pytest.mark.parametrize("use_kernel", [True, False])
def test_paged_decode_step_matches_reference(models, use_kernel):
    cfg_j, params_j, cfg_t, params_t = models
    rng = np.random.default_rng(4)
    ps, n_pages, pp = 4, 24, 5
    shape = (cfg_j.n_layers, n_pages, ps, cfg_j.n_kv_heads, cfg_j.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    slots = rng.permutation(n_pages)[:3 * pp].reshape(3, pp).astype(np.int32)
    pt = slots.copy()
    seq = np.asarray([9, 14, 6], np.int32)
    pt[1, 14 // ps] = -1        # stale snapshot at the write page: masked
    pt[2, 3:] = -1              # tail sentinels, behind the length mask
    toks = rng.integers(0, cfg_j.vocab, (3, 1)).astype(np.int32)

    lj, kj, vj = JP.paged_decode_step(
        params_j, cfg_j, jnp.asarray(toks), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pt), jnp.asarray(seq), page_size=ps,
        use_kernel=use_kernel)
    k_t, v_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lt, k_out, v_out = TP.paged_decode_step(
        params_t, cfg_t, torch.from_numpy(toks).long(), k_t, v_t, pt, seq,
        page_size=ps, use_kernel=use_kernel)
    assert k_out is k_t and v_out is v_t           # updated in place
    err = float(np.abs(lt.numpy() - np.asarray(lj)).max())
    print(f"paged_decode_step use_kernel={use_kernel}: max |logits port - "
          f"reference| = {err:.2e}")
    assert err <= 1e-4
    written = np.zeros(shape[1:3], bool)
    for b in (0, 2):
        written[pt[b, seq[b] // ps], seq[b] % ps] = True
    for got, ref, before in ((k_t, kj, kp), (v_t, vj, vp)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[:, ~written], ref[:, ~written])
        np.testing.assert_array_equal(got[:, ~written], before[:, ~written])
        np.testing.assert_allclose(got[:, written], ref[:, written],
                                   atol=1e-5)
        assert not np.array_equal(got[:, written], before[:, written])


# ------------------------------------------------------------------ S2

def _engine_run(pkg, models, refresh_mode, use_kernel):
    cfg_j, params_j, cfg_t, params_t = models
    ps, prompt_len, max_new, idle, max_batch = 4, 12, 8, 16, 2
    pages = (prompt_len + max_new + ps - 1) // ps
    num_pages = (max_batch + idle + 2) * pages
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg_j.vocab, prompt_len).astype(np.int32)
               for _ in range(max_batch)]
    if pkg == "jax":
        eng = JE.ServingEngine(cfg_j, params_j, page_size=ps,
                               num_pages=num_pages, max_batch=max_batch,
                               refresh_mode=refresh_mode,
                               use_kernel=use_kernel)
        req_cls = JE.Request
    else:
        eng = TE.ServingEngine(cfg_t, params_t, page_size=ps,
                               num_pages=num_pages, max_batch=max_batch,
                               refresh_mode=refresh_mode,
                               use_kernel=use_kernel, device="cpu")
        req_cls = TE.Request
    tables = []
    snap = eng.kv.page_table

    def recording(*a, **k):
        out = snap(*a, **k)
        tables.append(np.asarray(out).tolist())
        return out

    eng.kv.page_table = recording
    for sid in range(max_batch, max_batch + idle):
        eng.kv.alloc_pages(sid, pages)
    reqs = [req_cls(seq_id=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.admit(r)
    trace = []
    step = 0
    while eng.active:
        eng.step(rebalance=step % 2 == 1)
        trace.append((dict(eng.kv._table), eng.kv.backend.sublists(0)))
        step += 1
    return dict(tokens=[list(r.out) for r in reqs], tables=tables,
                trace=trace, stats=dict(eng.kv.backend.stats),
                free=sorted(eng.kv.free_slots),
                allocated=dict(eng.kv._allocated))


@pytest.mark.parametrize("refresh_mode,use_kernel",
                         [("range", True), ("rescan", False)])
def test_serving_engine_matches_reference(models, refresh_mode, use_kernel):
    ref = _engine_run("jax", models, refresh_mode, use_kernel=False)
    got = _engine_run("torch", models, refresh_mode, use_kernel)
    assert got["tokens"] == ref["tokens"]
    assert got["tables"] == ref["tables"]
    assert got["trace"] == ref["trace"]
    assert got["stats"] == ref["stats"]
    assert got["free"] == ref["free"]
    assert got["allocated"] == ref["allocated"]
    # non-vacuous: the index split under the decode, and the heal ran
    assert max(len(subs) for _, subs in got["trace"]) > 1
    if refresh_mode == "range":
        assert got["stats"]["range_hits"] > 0
    assert all(len(t) == 8 for t in got["tokens"])


# ------------------------------------------------------------------ S2b

def _smoke_serve(pkg, cfg, params, mode):
    """``chip_smoke._serve_mode``'s sequence on the CPU: park the idle
    sequences, settle the index (not in static), admit the live ones,
    one warm step, then ``steps`` steps with a rebalance every
    ``rebalance_every``-th (not in static)."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    serve = smoke.SERVE
    ps, live, idle = serve["page_size"], serve["live"], serve["idle"]
    pages = -(-(serve["prompt_hi"] + serve["max_new"]) // ps)
    mod, extra = (JE, {}) if pkg == "jax" else (TE, dict(device="cpu"))
    eng = mod.ServingEngine(cfg, params, page_size=ps,
                            num_pages=(live + idle + 2) * pages,
                            max_batch=live, dili_shards=2,
                            refresh_mode="rescan" if mode == "static"
                            else mode, **extra)
    moves = []
    move = eng.kv.backend.move
    eng.kv.backend.move = lambda s, k, t: moves.append((s, k, t)) or \
        move(s, k, t)
    for sid in range(live, live + idle):
        eng.kv.alloc_pages(sid, pages)
    if mode != "static":
        smoke.settle_index(eng)
    settled = len(moves)
    reqs = [mod.Request(seq_id=i, prompt=p, max_new=serve["max_new"])
            for i, p in enumerate(smoke.serve_requests(cfg.vocab))]
    for r in reqs:
        eng.admit(r)
    eng.step()
    every = serve["rebalance_every"]
    for st in range(serve["steps"]):
        eng.step(rebalance=mode != "static" and st % every == every - 1)
    return dict(tokens=[list(r.out) for r in reqs], moves=moves,
                live_moves=len(moves) - settled,
                stats=dict(eng.kv.backend.stats),
                owners=sorted({e["owner"] for e in
                               eng.kv.backend.sublists(0)}))


def test_two_shard_serving_matches_reference():
    cfg_j = j_smoke("qwen2_0_5b").replace(attn_q_chunk=512)
    params_j = JT.init_params(cfg_j, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    cfg_t = get_smoke_config("qwen2_0_5b").replace(attn_q_chunk=512)
    params_t = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t, device="cpu")
    ref = {m: _smoke_serve("jax", cfg_j, params_j, m)
           for m in ("static", "range")}
    got = {m: _smoke_serve("torch", cfg_t, params_t, m)
           for m in ("static", "rescan", "range")}
    for m, run in got.items():
        assert run["tokens"] == ref["static"]["tokens"], m
    # the DiLi protocol is the reference's, Move for Move
    assert got["range"]["stats"] == ref["range"]["stats"]
    assert got["range"]["moves"] == ref["range"]["moves"]
    # the reference's migrating run decodes other tokens: admission after
    # the settle delegates INSERTs to the shard that owns the range, and
    # its forwarded op row drops the page slot (ROADMAP, Queue 3)
    assert ref["range"]["tokens"] != ref["static"]["tokens"]
    for m in ("rescan", "range"):
        assert got[m]["live_moves"] > 0 and got[m]["owners"] == [0, 1], m
    assert not got["static"]["moves"]


# ------------------------------------------------------------------ S3

def test_manager_guards(models):
    cfg_t = models[2]
    kv = TP.PagedKVManager(cfg_t, num_pages=3, page_size=4, device="cpu")
    s00 = kv.alloc_page(0, 0)
    kv.alloc_page(0, 1)
    with pytest.raises(RuntimeError, match="double allocation"):
        kv.alloc_page(0, 1)
    assert len(kv.free_slots) == 1            # the refused slot came back
    kv.alloc_page(1, 0)
    with pytest.raises(TP.PagePoolExhausted):
        kv.alloc_page(1, 1)
    with pytest.raises(TP.PagePoolExhausted):
        kv.alloc_pages(2, 1)
    pt = kv.page_table([0, 1], [2, 1])
    assert pt.dtype == np.int32 and pt.shape == (2, 2)
    assert pt[0, 0] == s00 and pt[1, 1] == -1  # padding past seq 1's count
    kv._table.pop(TP.page_key(0, 1))         # stale snapshot: sentinel
    assert kv.page_table([0], [2])[0, 1] == -1
    with pytest.raises(KeyError):             # never allocated: refuse
        kv.page_table([2], [1])
    kv.refresh_seq(0)                         # one RANGE heals seq 0
    assert kv.page_table([0], [2])[0, 1] >= 0
    kv.free_seq(0, 3)                         # page 2 was never allocated
    assert sorted(kv.free_slots) == sorted({0, 1, 2} - {kv._table[
        TP.page_key(1, 0)]})
    assert TP.page_key(0, 0) not in kv._allocated
    assert kv.alloc_pages(3, 2) and len(kv.free_slots) == 0


def test_batch_overflow(models):
    cfg_t, params_t = models[2], models[3]
    eng = TE.ServingEngine(cfg_t, params_t, page_size=4, num_pages=16,
                           max_batch=1, device="cpu")
    rng = np.random.default_rng(0)
    eng.admit(TE.Request(0, rng.integers(0, 64, 5).astype(np.int32), 3))
    with pytest.raises(TE.BatchOverflow):
        eng.admit(TE.Request(1, rng.integers(0, 64, 5).astype(np.int32), 3))
    with pytest.raises(ValueError):
        TE.ServingEngine(cfg_t, params_t, refresh_mode="bogus",
                         device="cpu")


def test_serving_entry_points_default_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg_t, params_t = models[2], models[3]
    for make in (lambda: TT.init_params(cfg_t),
                 lambda: TT.init_cache(cfg_t, 1, 8),
                 lambda: TP.PagedKVManager(cfg_t, num_pages=4, page_size=4),
                 lambda: TE.ServingEngine(cfg_t, params_t)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


@pytest.mark.parametrize("shards", ["1", "2"])
def test_launch_serve_smoke_on_cpu(capsys, shards):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                "--max-new", "3", "--dili-shards", shards, "--rebalance"])
    out = capsys.readouterr().out
    assert "seq 1: generated" in out


# ------------------------------------------------------------------ S4

@pytest.mark.parametrize("arch,kw,match", [
    ("granite_moe_3b_a800m", {}, "'moe'.*Queue 3 item 6"),
    ("llava_next_mistral_7b", {}, "'vlm'.*Queue 3 item 6"),
    ("qwen2_0_5b", {"kv_quant": True}, "kv_quant")])
def test_serving_engine_refuses_what_it_cannot_serve(arch, kw, match):
    cfg = get_smoke_config(arch).replace(**kw)
    params = TT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match=match):
        TE.ServingEngine(cfg, params, page_size=8, num_pages=16,
                         max_batch=2, device="cpu")
