"""Public client API of the port (DESIGN.md §9).

    from repro_torch.api import DiLiClient, LocalBackend

    backend = LocalBackend(DiLiConfig(...))        # device="cuda" by default
    # or ShardMapBackend(DiLiConfig(...)): the SPMD round, same surface
    client = DiLiClient(backend, balance=Balancer(backend))
    fut = client.insert(42)
    client.drain()
    assert fut.result()
"""
from .backend import Backend, LocalBackend, ShardMapBackend
from .client import DiLiClient, RegistryCache, local_client
from .futures import BatchResult, OpFuture, RangeResult

__all__ = ["Backend", "BatchResult", "DiLiClient", "LocalBackend",
           "OpFuture", "RangeResult", "RegistryCache", "ShardMapBackend",
           "local_client"]
