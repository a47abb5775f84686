"""Message records for the round-based distributed runtime.

A message is a row of ``FIELDS`` int32 lanes. Refs are int32 bit patterns
in the port (see ``refs``), so ``ref2i``/``i2ref`` are identities. The
serial pass builds a round's outbox on the host, so ``empty_outbox``,
``push`` and ``make_row`` work on numpy rows; ``push``/``push_many`` write
into the outbox in place and return it with the new count.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- kinds
MSG_NONE = 0
MSG_OP = 1              # client operation (fresh or delegated)        §5.2
MSG_RESULT = 2          # response routed back to the client's shard
MSG_REP_INSERT = 3      # RepInsertAfter replicate                     §5.4
MSG_REP_DELETE = 4      # RepDelete replicate                          §5.4
MSG_ACK_INSERT = 5      # InsertReplayResponse                         L264
MSG_ACK_DELETE = 6      # RemoveReplayResponse                         L266
MSG_MOVE_SH = 7         # MoveSH                                       L215
MSG_MOVE_SH_ACK = 8
MSG_MOVE_ITEM = 9       # MoveItem                                     L240
MSG_MOVE_ACK = 10
MSG_SWITCH_ST = 11      # SwitchST                                     L272
MSG_SWITCH_ST_ACK = 12
MSG_REG_SPLIT = 13      # RegisterSublist broadcast after Split        L159
MSG_SWITCH_SERVER = 14  # SwitchServer registry update broadcast       L285
MSG_REG_MERGED = 15     # RegisterMergedSublist broadcast              L360
MSG_MOVE_ITEMS = 16     # MoveItem batch member (DESIGN.md §10)
MSG_NET_ACK = 17        # transport-level ack; a no-op in shard_round
MSG_EPOCH = 18          # membership-epoch announcement (DESIGN.md §13)
MSG_REPLICA_DELTA = 19  # read-replication image delta (DESIGN.md §15)
MSG_REPLICA_INSTALL = 20
MSG_REPLICA_DROP = 21
MSG_RANGE = 22          # range-scan segment cursor (DESIGN.md §16)
MSG_RANGE_ITEM = 23
N_KINDS = 24

# ---------------------------------------------------------------- layout
F_KIND = 0
F_DST = 1
F_SRC = 2
F_A = 3        # op kind / flag / result value
F_KEY = 4
F_REF1 = 5     # primary ref
F_SID = 6      # item identity: origin shard id
F_TS = 7       # item identity: logical timestamp / client slot
F_X1 = 8
F_X2 = 9
F_X3 = 10
F_X4 = 11
F_VAL = 12     # item payload value
F_SLOT = 13    # background slot id
F_SEQ = 14     # transport sequence number (0 on direct routing)
FIELDS = 15

MSG_DTYPE = np.int32


def ref2i(ref):
    """Refs already are int32 bit patterns in the port."""
    return ref


def i2ref(i):
    return i


def empty_outbox(cap: int):
    """(buffer[cap, FIELDS], count) — MSG_NONE rows are padding."""
    return np.zeros((cap, FIELDS), MSG_DTYPE), 0


def push(outbox, count, row, do=True):
    """Append ``row`` when ``do``. ``count`` counts every attempted push,
    so it can exceed the capacity; rows past the cap are not stored and
    the final count is the overflow signal the routing layer raises on."""
    if do:
        if count < outbox.shape[0]:
            outbox[count] = row
        count += 1
    return outbox, count


def push_many(outbox, count, rows, do):
    """Append every ``rows[i]`` where ``do[i]``, in order; rows past the cap
    are masked out (the reference drops them with ``mode="drop"``)."""
    do = np.asarray(do, bool)
    cap = outbox.shape[0]
    idx = count + np.cumsum(do.astype(np.int64)) - 1
    keep = do & (idx < cap)
    outbox[idx[keep]] = np.asarray(rows)[keep]
    return outbox, count + int(do.sum())


def make_row(kind, dst, src, *, a=0, key=0, ref1=0, sid=0, ts=0,
             x1=0, x2=0, x3=0, x4=0, val=0, slot=0, seq=0):
    return np.array([kind, dst, src, a, key, ref1, sid, ts, x1, x2, x3, x4,
                     val, slot, seq], MSG_DTYPE)
