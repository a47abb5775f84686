"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

``ops.hybrid_search``, ``ops.refresh_walk`` and ``ops.paged_attention``
launch ``csrc/hybrid_search.cu``, ``csrc/refresh_walk.cu`` and
``csrc/paged_attention.cu`` (built for ``sm_90a`` at first use by
``build.py``) on CUDA tensors and run their plain twins in ``ref.py`` on
CPU tensors.
"""
from . import ops, ref  # noqa: F401
