"""Public client API of the port (DESIGN.md §9).

    from repro_torch.api import DiLiClient, LocalBackend

    backend = LocalBackend(DiLiConfig(...))        # device="cuda" by default
    client = DiLiClient(backend, balance=Balancer(backend))
    fut = client.insert(42)
    client.drain()
    assert fut.result()
"""
from .backend import LocalBackend
from .client import DiLiClient, RegistryCache, local_client
from .futures import BatchResult, OpFuture, RangeResult

__all__ = ["BatchResult", "DiLiClient", "LocalBackend", "OpFuture",
           "RangeResult", "RegistryCache", "local_client"]
