"""repro_torch: the DiLi reproduction on PyTorch and CUDA (NVIDIA Hopper).

A port of ``repro`` (JAX + Pallas), held against it bit for bit. It
imports neither ``jax`` nor ``repro``. Entry points (``Cluster``,
``LocalBackend``, ``DiLiClient``, ``local_client``) take ``device=`` and
run on ``"cuda"`` unless the caller passes ``device="cpu"``.

Subpackages:
  api      — DiLiClient futures API + LocalBackend
  core     — the DiLi protocol: state, round, background Split, balancer
  kernels  — hand-written Hopper kernels (hybrid_search) + plain twins
  data     — YCSB workload generators
  convert  — carry a reference run's state into the port and back
"""
