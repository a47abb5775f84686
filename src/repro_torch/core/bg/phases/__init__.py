"""Per-phase step functions of the background engine (one module per op).

Every phase function shares the signature::

    (h, s, me, slot_id, outbox, count, cfg) -> (outbox, count)

``h`` is the round's ``HostShard``, ``s`` one slot's fields as a dict
(both updated in place); ``slot_id`` is stamped into outgoing move/switch
messages so their acks come back to the right slot.
"""
from . import merge, move, split  # noqa: F401
