"""DiLi core of the port: the data structure and the round protocol."""
from . import (balancer, batch_apply, bg, blocks, host, membership,  # noqa: F401
               messages, ops, oracle, refs, registry, shard, sim, traverse,
               types)
