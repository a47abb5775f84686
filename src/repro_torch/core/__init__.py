"""DiLi core of the port: the data structure and the round protocol."""
from . import (balancer, batch_apply, bg, blocks, distributed,  # noqa: F401
               host, membership, messages, ops, oracle, refs, registry,
               shard, sim, traverse, types)
