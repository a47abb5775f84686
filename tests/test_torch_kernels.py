"""The port's ``hybrid_search`` against the reference, bit for bit.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the reference's Pallas kernel (interpret mode, as the reference's
own tests run it) and the reference's jnp oracle, on the shapes and edge
cases of ``tests/test_kernels.py`` plus the fig3a main-path shape. The
kernel's 32-ary registry search is modelled here in numpy, step for step
as ``csrc/hybrid_search.cu`` writes it, and held against searchsorted.
The CUDA kernel itself is compared with the plain version by the ``gpu``
tests at the end, which run on the card and skip elsewhere: the main
path's shapes and the edge cases of ``chip_smoke.hs_edge_case`` (ties,
pads, the full-block-all-less row, sentinel queries, odd ``C`` and
misaligned rows on the scalar sweep), bit for bit and repeatably. The
reference is imported inside the tests that use it, so the ``gpu`` tests
also run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TK

INT_MIN = np.iinfo(np.int32).min
INT_MAX = np.iinfo(np.int32).max


def _load_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()


def make_registry(rng, m, c, coverage=0.7):
    """Random sorted registry + per-sublist sorted key blocks (the
    generator of ``tests/test_kernels.py``), as numpy."""
    bounds = np.sort(rng.choice(np.arange(0, 10_000, 7), m, replace=False))
    bounds[0] = -1
    keymin = bounds.astype(np.int32)
    blocks = np.full((m, c), INT_MAX, np.int32)
    for i in range(m):
        lo = int(bounds[i]) + 1
        hi = int(bounds[i + 1]) if i + 1 < m else lo + 500
        span = np.arange(lo, max(hi, lo + 1))
        take = np.sort(rng.permutation(span)[:int(c * coverage)])
        blocks[i, :take.size] = take
    return keymin, blocks


def queries_for(rng, blocks, b):
    present = blocks.ravel()
    present = present[present != INT_MAX]
    q_hit = rng.choice(present, b // 2)
    q_miss = rng.integers(0, 10_500, b - b // 2)
    return np.concatenate([q_hit, q_miss]).astype(np.int32)


def port(keymin, blocks, q):
    slot, found = TK.hybrid_search(torch.from_numpy(keymin),
                                   torch.from_numpy(blocks),
                                   torch.from_numpy(q))
    assert slot.dtype == torch.int32 and found.dtype == torch.bool
    return slot.numpy(), found.numpy()


def reference(keymin, blocks, q, tile_q=128):
    """(kernel, oracle) outputs of the reference package."""
    jnp = pytest.importorskip("jax.numpy")
    JK = pytest.importorskip("repro.kernels.ops")
    args = (jnp.asarray(keymin), jnp.asarray(blocks), jnp.asarray(q))
    slot, found = JK.hybrid_search(*args, tile_q=tile_q, interpret=True)
    slot_r, found_r = JK.hybrid_search_ref(*args)
    return ((np.asarray(slot), np.asarray(found)),
            (np.asarray(slot_r), np.asarray(found_r)))


def assert_matches_reference(keymin, blocks, q, tile_q=128):
    slot, found = port(keymin, blocks, q)
    for s_r, f_r in reference(keymin, blocks, q, tile_q):
        np.testing.assert_array_equal(slot, s_r)      # tolerance 0
        np.testing.assert_array_equal(found, f_r)
    return slot, found


@pytest.mark.parametrize("m,c,b", [(8, 32, 128), (32, 128, 256),
                                   (128, 128, 128), (64, 256, 512)])
def test_hybrid_search_matches_reference(m, c, b):
    rng = np.random.default_rng(m * 1000 + c)
    keymin, blocks = make_registry(rng, m, c)
    q = queries_for(rng, blocks, b)
    slot, found = assert_matches_reference(keymin, blocks, q, tile_q=b // 2)
    # every hit's slot holds the queried key
    np.testing.assert_array_equal(blocks.ravel()[slot[found]], q[found])


def test_hybrid_search_full_block_all_less():
    """A full block whose keys are all < q reports pos == C (slot ==
    entry*C + C), checked against hand-computed expectations."""
    c = 8
    keymin = np.asarray([-1, 50], np.int32)
    blocks = np.full((2, c), INT_MAX, np.int32)
    blocks[0] = np.arange(10, 10 + c)        # full block: 10..17
    blocks[1, :3] = [60, 70, 80]
    q = np.asarray([49, 18, 75, 60, 60, 60, 60, 60], np.int32)
    slot, found = assert_matches_reference(keymin, blocks, q, tile_q=8)
    np.testing.assert_array_equal(found, [False, False, False, True,
                                          True, True, True, True])
    assert slot[0] == 0 * c + c
    assert slot[1] == 0 * c + c
    assert slot[2] == 1 * c + 2
    assert slot[3] == 1 * c + 0


def test_hybrid_search_sentinel_query_never_found():
    """q == INT32_MAX equals every pad cell; the wrapper masks ``found``."""
    c = 8
    keymin = np.asarray([-1, 50], np.int32)
    blocks = np.full((2, c), INT_MAX, np.int32)
    blocks[0, :4] = [10, 20, 30, 40]
    q = np.asarray([INT_MAX, INT_MAX, 30], np.int32)
    _, found = assert_matches_reference(keymin, blocks, q, tile_q=8)
    np.testing.assert_array_equal(found, [False, False, True])
    # the plain twin masks the same way
    _, found_ref = TK.hybrid_search_ref(torch.from_numpy(keymin),
                                        torch.from_numpy(blocks),
                                        torch.from_numpy(q))
    np.testing.assert_array_equal(found_ref.numpy(), found)


@pytest.mark.parametrize("b,tile_q", [(3, 8), (100, 64), (129, 128)])
def test_hybrid_search_ragged_batch(b, tile_q):
    """The port has no tile: any B goes straight through."""
    rng = np.random.default_rng(b)
    keymin, blocks = make_registry(rng, 8, 32)
    q = rng.integers(0, 10_500, b).astype(np.int32)
    slot, found = assert_matches_reference(keymin, blocks, q, tile_q=tile_q)
    assert slot.shape == (b,) and found.shape == (b,)


def test_hybrid_search_fig3a_shape():
    """The main path's shape: M=256 registry entries, C=160 keys per
    block, 128 probe lanes, with ST_KEY padding rows past the live
    registry prefix as the runtime has them."""
    rng = np.random.default_rng(3)
    keymin, blocks = make_registry(rng, 200, 160, coverage=0.6)
    keymin = np.concatenate([keymin, np.full(56, INT_MAX, np.int32)])
    blocks = np.concatenate([blocks, np.full((56, 160), INT_MAX, np.int32)])
    q = queries_for(rng, blocks, 128)
    q[:4] = [INT_MAX, INT_MAX - 1, -(2**31) + 1, 0]
    assert_matches_reference(keymin, blocks, q)


def test_hybrid_search_wrapper_checks_inputs():
    """The wrapper raises on what the kernel does not take, and counts
    launches only for the CUDA kernel."""
    keymin = torch.tensor([-1, 50], dtype=torch.int32)
    blocks = torch.full((2, 8), INT_MAX, dtype=torch.int32)
    q = torch.tensor([5, 60], dtype=torch.int32)
    before = TK.hybrid_search.launches
    TK.hybrid_search(keymin, blocks, q)
    assert TK.hybrid_search.launches == before    # CPU: plain version
    with pytest.raises(TypeError):
        TK.hybrid_search(keymin.long(), blocks, q)
    with pytest.raises(ValueError):
        TK.hybrid_search(keymin, blocks.t(), q)               # not contiguous
    with pytest.raises(ValueError):
        TK.hybrid_search(keymin[:1], blocks, q)               # M mismatch
    with pytest.raises(ValueError):
        TK.hybrid_search(keymin, blocks[0], q)                # not 2-D


@pytest.mark.parametrize("which", [0, 1, 2])
def test_hybrid_search_wrapper_rejects_non_tensors(which):
    """Any argument that is not a tensor raises TypeError, queries too."""
    args = [torch.tensor([-1, 50], dtype=torch.int32),
            torch.full((2, 8), INT_MAX, dtype=torch.int32),
            torch.tensor([5, 60], dtype=torch.int32)]
    args[which] = args[which].tolist()
    with pytest.raises(TypeError, match="must be a tensor"):
        TK.hybrid_search(*args)


def test_hybrid_search_empty_rows():
    """Rows of width C = 0 are refused with ValueError before anything
    runs (``test_cuda_kernel_empty_rows`` on the card)."""
    keymin = torch.tensor([-1, 50, INT_MAX], dtype=torch.int32)
    blocks = torch.empty((3, 0), dtype=torch.int32)
    q = torch.tensor([INT_MIN, 5, 60, INT_MAX], dtype=torch.int32)
    with pytest.raises(ValueError, match="empty"):
        TK.hybrid_search(keymin, blocks, q)


def search_32ary(keymin, q):
    """numpy model of the kernel's registry search (the step block in
    ``csrc/hybrid_search.cu``), one query per row of 32 lanes. Returns
    (entry, steps taken by the query that took the most)."""
    m = keymin.shape[0]
    km = keymin.astype(np.int64)
    q = q.astype(np.int64)
    lo = np.zeros(q.shape, np.int64)
    hi = np.full(q.shape, m, np.int64)
    lane = np.arange(32)[None, :]
    steps = 0
    while (hi > lo).any():
        span = hi - lo
        s = np.where(span > 0, (span - 1) // 32 + 1, 1)
        nvalid = span // s
        valid = lane < nvalid[:, None]
        idx = np.where(valid, lo[:, None] + (lane + 1) * s[:, None] - 1, 0)
        lt = valid & (km[idx] < q[:, None])
        k = lt.sum(axis=1)                          # popc(ballot)
        hi = np.where(k < nvalid, lo + (k + 1) * s - 1, hi)
        lo = lo + k * s
        steps += 1
    return np.maximum(lo - 1, 0), steps


def _sorted_keymin(rng, m, pad):
    """Sorted int32[m] with ties (drawn from a pool a third the size,
    INT32_MIN among them) and ``pad`` INT32_MAX entries at the end."""
    live = m - pad
    pool = np.append(rng.integers(INT_MIN, INT_MAX, max(1, live // 3)),
                     INT_MIN)
    return np.concatenate([np.sort(rng.choice(pool, live)),
                           np.full(pad, INT_MAX)]).astype(np.int32)


@pytest.mark.parametrize("m", [1, 2, 31, 32, 33, 255, 256, 1023, 1024,
                               1025, 16384])
def test_search_32ary_model_matches_searchsorted(m):
    """The kernel's 32-ary step arithmetic gives searchsorted's entry (the
    last i with keymin[i] < q, clamped into [0, M-1]) on sorted keymin with
    ties and pads, at the int32 extremes, at every keymin value and its
    neighbours, in at most ceil(log32 M) steps (one for M = 1)."""
    rng = np.random.default_rng(m)
    max_steps = max(1, next(d for d in range(8) if 32 ** d >= m))
    for pad in sorted({0, m // 4, m - 1, m}):
        keymin = _sorted_keymin(rng, m, pad)
        near = keymin.astype(np.int64)[:, None] + np.arange(-1, 2)
        q = np.unique(np.clip(np.concatenate(
            [near.ravel(), [INT_MIN, INT_MAX - 1, INT_MAX]]),
            INT_MIN, INT_MAX)).astype(np.int32)
        entry, steps = search_32ary(keymin, q)
        want = np.clip(np.searchsorted(keymin, q, side="left") - 1, 0, m - 1)
        np.testing.assert_array_equal(entry, want)
        assert 1 <= steps <= max_steps
        # the port's plain twin gives the same entry: one pad column, so
        # pos == 0 and slot == entry
        slot, _ = TK.hybrid_search(torch.from_numpy(keymin),
                                   torch.full((m, 1), INT_MAX,
                                              dtype=torch.int32),
                                   torch.from_numpy(q))
        np.testing.assert_array_equal(slot.numpy(), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc for "
                    "sm_90a and runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,c,b", [(8, 32, 3), (256, 160, 128),
                                   (16384, 160, 4096)])
def test_cuda_kernel_matches_plain(cuda_device, m, c, b):
    """The hand-written kernel against the plain version on the card."""
    rng = np.random.default_rng(m + b)
    keymin, blocks = make_registry(rng, min(m, 1400), c)
    if keymin.shape[0] < m:
        pad = m - keymin.shape[0]
        keymin = np.concatenate([keymin, np.full(pad, INT_MAX, np.int32)])
        blocks = np.concatenate([blocks,
                                 np.full((pad, c), INT_MAX, np.int32)])
    q = queries_for(rng, blocks, b)
    args = [torch.from_numpy(a).to(cuda_device) for a in (keymin, blocks, q)]
    before = TK.hybrid_search.launches
    slot, found = TK.hybrid_search(*args)
    torch.cuda.synchronize()
    assert TK.hybrid_search.launches == before + 1
    slot_r, found_r = TK.hybrid_search_ref(*args)
    assert torch.equal(slot, slot_r) and torch.equal(found, found_r)


@pytest.mark.gpu
@pytest.mark.parametrize("c", SMOKE.HS_EDGE_C)
@pytest.mark.parametrize("m", SMOKE.HS_EDGE_M)
def test_cuda_kernel_edge_cases(cuda_device, m, c):
    """Bit for bit with the plain version at every batch size of the edge
    grid; three calls are bitwise equal and count three launches."""
    bs = SMOKE.HS_EDGE_B
    keymin, blocks, q = SMOKE.hs_edge_case(m, c, max(bs), seed=m + c)
    keymin, blocks = (torch.from_numpy(a).to(cuda_device)
                      for a in (keymin, blocks))
    for b in bs:
        qb = torch.from_numpy(q[:b]).to(cuda_device)
        before = TK.hybrid_search.launches
        outs = [TK.hybrid_search(keymin, blocks, qb) for _ in range(3)]
        torch.cuda.synchronize()
        assert TK.hybrid_search.launches == before + 3
        slot_r, found_r = TK.hybrid_search_ref(keymin, blocks, qb)
        for slot, found in outs:
            assert slot.dtype == torch.int32 and found.dtype == torch.bool
            assert torch.equal(slot, slot_r), (m, c, b)
            assert torch.equal(found, found_r), (m, c, b)


@pytest.mark.gpu
def test_cuda_kernel_misaligned_rows(cuda_device):
    """Rows that do not start on a 16-byte boundary (C % 4 == 0, storage
    offset of one int) take the scalar sweep and give the same answers."""
    m, c = 256, 160
    keymin, blocks, q = SMOKE.hs_edge_case(m, c, 4096, seed=7)
    flat = torch.empty(m * c + 1, dtype=torch.int32, device=cuda_device)
    shifted = flat[1:].view(m, c)
    shifted.copy_(torch.from_numpy(blocks).to(cuda_device))
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    args = (torch.from_numpy(keymin).to(cuda_device), shifted,
            torch.from_numpy(q).to(cuda_device))
    slot, found = TK.hybrid_search(*args)
    slot_r, found_r = TK.hybrid_search_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(slot, slot_r) and torch.equal(found, found_r)


@pytest.mark.gpu
def test_cuda_kernel_empty_rows(cuda_device):
    """C = 0 on the card: ValueError, as on the CPU, and no launch."""
    keymin = torch.tensor([-1, 50, INT_MAX], dtype=torch.int32,
                          device=cuda_device)
    blocks = torch.empty((3, 0), dtype=torch.int32, device=cuda_device)
    q = torch.tensor([INT_MIN, 5, 60, INT_MAX], dtype=torch.int32,
                     device=cuda_device)
    before = TK.hybrid_search.launches
    with pytest.raises(ValueError, match="empty"):
        TK.hybrid_search(keymin, blocks, q)
    assert TK.hybrid_search.launches == before
