"""The port's ``paged_attention`` against the reference.

On the CPU the port's wrapper runs its plain twin (``kernels/ref.py``),
held against the reference's Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) at the reference's three test shapes in
f32 and bf16 (atol 2e-5 / 2e-2, rtol 2e-2: the two sum in different
orders, and bf16 rounds at other places), plus the padding-page
invariance. The CUDA kernel is compared with the twin by the ``gpu`` tests
at the end, which run on the card and skip elsewhere::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_paged_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TK

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
