"""The port's ``hybrid_search`` against the reference, bit for bit.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the reference's Pallas kernel (interpret mode, as the reference's
own tests run it) and the reference's jnp oracle, on the shapes and edge
cases of ``tests/test_kernels.py`` plus the fig3a main-path shape. The
CUDA kernel itself is compared with the plain version by the ``gpu``
test at the end, which runs on the card and skips elsewhere. The
reference is imported inside the tests that use it, so the ``gpu`` test
also runs where JAX is not installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TK

INT_MAX = np.iinfo(np.int32).max


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
