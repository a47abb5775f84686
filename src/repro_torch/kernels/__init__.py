"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

``ops.hybrid_search`` launches ``csrc/hybrid_search.cu`` (built for
``sm_90a`` at first use) on CUDA tensors and runs ``ref.hybrid_search_ref``
on CPU tensors. ``paged_attention`` is not ported yet (ROADMAP Queue 2).
"""
from . import ops, ref  # noqa: F401
