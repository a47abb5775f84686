"""The port's ``paged_attention`` against the reference.

On the CPU the port's wrapper runs its plain twin (``kernels/ref.py``),
held against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) at the reference's three test shapes in
f32 and bf16 (atol 2e-5 / 2e-2, rtol 2e-2: the two sum in different
orders, and bf16 rounds at other places), plus the padding-page
invariance and the edge lengths (``seq_len`` 0, one page, past the
table). The CUDA kernel is compared with the twin by the ``gpu`` tests at
the end, which run on the card and skip elsewhere: the test shapes, the
edge lengths, lengths on the boundaries of the kernel's page splits,
ragged splits, the largest tiles, and bitwise repeatability::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_paged_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TK
from repro_torch.kernels import paged_attention as PA

SHAPES = [(4, 8, 2, 64, 8, 16),
          (2, 16, 16, 128, 4, 32),   # MHA
          (8, 4, 1, 64, 16, 8)]      # MQA
TOL = {"f32": dict(atol=2e-5, rtol=2e-2), "bf16": dict(atol=2e-2, rtol=2e-2)}
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_case(b, h, kh, d, pages, ps, seed=None):
    """The reference test's inputs, as numpy f32 (cast per dtype later)."""
    rng = np.random.default_rng(b * 100 + h if seed is None else seed)
    pool = pages * 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = (rng.standard_normal((pool, ps, kh, d)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((pool, ps, kh, d)) * 0.3).astype(np.float32)
    pt = rng.integers(0, pool, (b, pages)).astype(np.int32)
    sl = rng.integers(1, pages * ps + 1, (b,)).astype(np.int32)
    return q, kp, vp, pt, sl


def port_args(case, dt, device="cpu"):
    q, kp, vp, pt, sl = case
    return ([torch.from_numpy(x).to(device=device, dtype=TORCH_DT[dt])
             for x in (q, kp, vp)]
            + [torch.from_numpy(x).to(device) for x in (pt, sl)])


def reference(case, dt, ps):
    """(Pallas kernel in interpret mode, jnp oracle) outputs, f32 numpy."""
    import jax.numpy as jnp
    from repro.kernels import ops as JK
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    q, kp, vp, pt, sl = case
    args = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
            jnp.asarray(pt), jnp.asarray(sl))
    out = JK.paged_attention(*args, page_size=ps, interpret=True)
    ref = JK.paged_attention_ref(*args, page_size=ps)
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("b,h,kh,d,pages,ps", SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_attention_matches_reference(b, h, kh, d, pages, ps, dt):
    case = make_case(b, h, kh, d, pages, ps)
    out = TK.paged_attention(*port_args(case, dt), page_size=ps)
    assert out.dtype == TORCH_DT[dt] and out.shape == (b, h, d)
    got = out.float().numpy()
    for ref in reference(case, dt, ps):
        np.testing.assert_allclose(got, ref, **TOL[dt])


def _padding_case():
    rng = np.random.default_rng(0)
    b, h, kh, d, pages, ps, pool = 2, 4, 2, 32, 4, 8, 12
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pool, ps, kh, d)).astype(np.float32)
    vp = rng.standard_normal((pool, ps, kh, d)).astype(np.float32)
    seq = np.asarray([9, 17], np.int32)
    pt1 = rng.integers(0, pool, (b, pages)).astype(np.int32)
    # scramble only the fully-masked tail pages
    pt2 = pt1.copy()
    pt2[0, 2:] = (pt2[0, 2:] + 5) % pool
    pt2[1, 3:] = (pt2[1, 3:] + 3) % pool
    return (q, kp, vp, pt1, seq), (q, kp, vp, pt2, seq), ps


def test_paged_attention_ignores_padding_pages():
    c1, c2, ps = _padding_case()
    o1 = TK.paged_attention(*port_args(c1, "f32"), page_size=ps)
    o2 = TK.paged_attention(*port_args(c2, "f32"), page_size=ps)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6)
    np.testing.assert_allclose(o1.numpy(), reference(c1, "f32", ps)[0],
                               **TOL["f32"])


# one small shape (B, H, KH, D, pages, page size) for the edge lengths
EDGE_SHAPE = (6, 8, 2, 32, 4, 8)


def edge_lens(pages, ps):
    """No token (the reference's softmax is uniform over every named
    position: the mean of V), one token, one full page, one past it, the
    full table, and a length past the table (every position counts)."""
    return [0, 1, ps, ps + 1, pages * ps, pages * ps + 5]


def _edge_case(seed=7):
    b, h, kh, d, pages, ps = EDGE_SHAPE
    q, kp, vp, pt, _ = make_case(b, h, kh, d, pages, ps, seed=seed)
    return (q, kp, vp, pt, np.asarray(edge_lens(pages, ps), np.int32)), ps


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_attention_edge_lengths_match_reference(dt):
    case, ps = _edge_case()
    got = TK.paged_attention(*port_args(case, dt), page_size=ps)
    got = got.float().numpy()
    for ref in reference(case, dt, ps):
        np.testing.assert_allclose(got, ref, **TOL[dt])
    # seq_len 0: the mean of V over every named position, per KV head
    q, kp, vp, pt, _ = case
    b, h, kh, d, pages, _ = EDGE_SHAPE
    vmean = vp[pt[0]].reshape(pages * ps, kh, d).mean(0)
    np.testing.assert_allclose(got[0], np.repeat(vmean, h // kh, 0),
                               **TOL[dt])


@pytest.mark.parametrize("pp,units,sms,want", [
    (34, 16, 132, (17, 2)),      # the serving shape: 272 blocks
    (8, 8, 132, (8, 1)),         # more SMs than pages x units
    (35, 16, 132, (12, 3)),      # the last split holds 2 pages
    (34, 100, 132, (3, 12)),
    (34, 132, 132, (1, 34)),     # the units fill the card: no merge
    (1, 4, 132, (1, 1)),
    (4096, 200, 132, (4, 1024)),  # one split may hold 1024 pages
    (0, 4, 132, (1, 1)),
])
def test_split_pages_plan(pp, units, sms, want):
    n_split, per = PA.split_pages(pp, units, sms)
    assert (n_split, per) == want
    if pp:
        # every split holds a page, and the splits cover the table
        assert (n_split - 1) * per < pp <= n_split * per
        assert per <= PA.MAX_SPLIT_PAGES


@pytest.mark.parametrize("groups,want", [(1, 1), (4, 4), (7, 7), (8, 8),
                                         (11, 1), (12, 6), (14, 7), (16, 8),
                                         (32, 8)])
def test_block_heads(groups, want):
    assert PA.block_heads(groups) == want


def test_paged_attention_wrapper_checks_inputs():
    case = make_case(2, 4, 2, 32, 4, 8, seed=0)
    q, kp, vp, pt, sl = port_args(case, "f32")
    with pytest.raises(ValueError, match="page_size"):
        TK.paged_attention(q, kp, vp, pt, sl, page_size=16)
    with pytest.raises(ValueError, match="query heads"):
        TK.paged_attention(q[:, :3].contiguous(), kp, vp, pt, sl,
                           page_size=8)
    with pytest.raises(ValueError, match="head dim"):
        TK.paged_attention(q[..., :24].contiguous(),
                           kp[..., :24].contiguous(),
                           vp[..., :24].contiguous(), pt, sl, page_size=8)
    with pytest.raises(TypeError):
        TK.paged_attention(q, kp.to(torch.bfloat16), vp, pt, sl,
                           page_size=8)
    with pytest.raises(TypeError):
        TK.paged_attention(q, kp, vp, pt.long(), sl, page_size=8)
    with pytest.raises(ValueError, match="contiguous"):
        TK.paged_attention(q.transpose(0, 1), kp, vp, pt, sl, page_size=8)
    big = torch.zeros((2, 66, 2, 32))
    with pytest.raises(ValueError, match="page size"):
        TK.paged_attention(q, big, big, pt, sl, page_size=66)
    wide = torch.zeros((2, 33 * 2, 32))
    with pytest.raises(ValueError, match="query heads"):
        TK.paged_attention(wide, kp, vp, pt, sl, page_size=8)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built with nvcc for "
                    "sm_90a and runs only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,d,pages,ps", SHAPES + [
    (8, 14, 2, 64, 34, 16)])                 # Qwen2-0.5B serving shape
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_matches_twin(cuda_device, b, h, kh, d, pages, ps, dt):
    case = make_case(b, h, kh, d, pages, ps)
    args = port_args(case, dt, cuda_device)
    before = TK.paged_attention.launches
    out = TK.paged_attention(*args, page_size=ps)
    torch.cuda.synchronize()
    assert TK.paged_attention.launches == before + 1
    ref = TK.paged_attention_ref(*args, page_size=ps)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dt])


@pytest.mark.gpu
def test_cuda_kernel_ignores_padding_pages(cuda_device):
    c1, c2, ps = _padding_case()
    o1 = TK.paged_attention(*port_args(c1, "f32", cuda_device), page_size=ps)
    o2 = TK.paged_attention(*port_args(c2, "f32", cuda_device), page_size=ps)
    torch.testing.assert_close(o1, o2, atol=1e-6, rtol=0)


def _on_card_vs_twin(case, dt, ps, device):
    args = port_args(case, dt, device)
    out = TK.paged_attention(*args, page_size=ps)
    torch.cuda.synchronize()
    ref = TK.paged_attention_ref(*args, page_size=ps)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dt])
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_edge_lengths(cuda_device, dt):
    case, ps = _edge_case()
    _on_card_vs_twin(case, dt, ps, cuda_device)


def _split_plan(b, h, kh, pp, device):
    """(splits, pages per split) of a launch on this card."""
    return PA.plan(b, h, kh, pp, PA.sm_count(device))[1:]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_split_boundaries(cuda_device, dt):
    """The last live position on the first or the last position of a
    split, and a length that ends exactly where a split starts."""
    b, h, kh, d, pages, ps = 6, 8, 2, 64, 34, 16
    n_split, per = _split_plan(b, h, kh, pages, cuda_device)
    assert n_split > 1
    lens = []
    for i in (1, n_split - 2):
        start, end = i * per * ps, min((i + 1) * per, pages) * ps
        lens += [start + 1, end, start]
    q, kp, vp, pt, _ = make_case(b, h, kh, d, pages, ps, seed=3)
    _on_card_vs_twin((q, kp, vp, pt, np.asarray(lens, np.int32)), dt, ps,
                     cuda_device)


@pytest.mark.gpu
def test_cuda_kernel_ragged_and_single_page_splits(cuda_device):
    """PP not a multiple of the split count (a short last split), and a
    table of one page."""
    b, h, kh, d, ps = 8, 14, 2, 64, 16
    pages = next(pp for pp in range(5, 200)
                 if _split_plan(b, h, kh, pp, cuda_device)[0] > 1
                 and pp % _split_plan(b, h, kh, pp, cuda_device)[0])
    for pp in (pages, 1):
        q, kp, vp, pt, _ = make_case(b, h, kh, d, pp, ps, seed=pp)
        lens = np.asarray([0, 1, ps, pp * ps, pp * ps + 5, 3, ps + 1,
                           max(pp * ps - 1, 1)], np.int32)
        for dt in ("f32", "bf16"):
            _on_card_vs_twin((q, kp, vp, pt, lens), dt, ps, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_largest_tiles(cuda_device, dt):
    """S = 64, D = 256: the tiles exceed 48 KB of shared memory (f32 ones
    no longer fit twice, so the kernel single-buffers)."""
    case = make_case(3, 8, 2, 256, 3, 64, seed=11)
    q, kp, vp, pt, _ = case
    lens = np.asarray([1, 3 * 64, 100], np.int32)
    _on_card_vs_twin((q, kp, vp, pt, lens), dt, 64, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kh,d,pages,ps", [
    (4, 32, 1, 64, 6, 16),      # G = 32: four blocks of 8 heads per KV head
    (3, 32, 2, 128, 5, 16),     # G = 16
    (2, 22, 2, 64, 3, 32)])     # G = 11: eleven blocks of one head
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_kernel_head_blocks(cuda_device, b, h, kh, d, pages, ps, dt):
    q, kp, vp, pt, _ = make_case(b, h, kh, d, pages, ps, seed=5)
    lens = np.resize(np.asarray([0, 1, pages * ps, 17], np.int32), b)
    _on_card_vs_twin((q, kp, vp, pt, lens), dt, ps, cuda_device)


@pytest.mark.gpu
def test_cuda_kernel_is_deterministic(cuda_device):
    """The splits are merged in a fixed order: two calls on the same
    inputs are bitwise equal."""
    case = make_case(8, 14, 2, 64, 34, 16)
    args = port_args(case, "f32", cuda_device)
    o1 = TK.paged_attention(*args, page_size=16)
    o2 = TK.paged_attention(*args, page_size=16)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
