"""Reliable transport + deterministic nemesis (DESIGN.md §11).

Layout, as in the reference (numpy on the host, no device work):

* ``transport`` — per-(src,dst) sequence lanes, dedup windows,
  cumulative acks, bounded retransmit ring: exactly-once in-order
  delivery over a lossy wire;
* ``nemesis``   — the seeded adversary (drop/dup/reorder/delay,
  partitions, per-link overrides, crash plans), a pure function of
  ``(seed, NemesisConfig)``;
* ``digest``    — state / round-trace fingerprints for replay checks.

``core.sim.Cluster(nemesis=...)`` routes through one ``Transport``; with
no nemesis the direct routing path is untouched.
"""
from .digest import state_digest, trace_digest, trace_entry  # noqa: F401
from .nemesis import (CrashPlan, LinkFaults, Nemesis,  # noqa: F401
                      NemesisConfig, Partition)
from .transport import Transport, TransportOverflow  # noqa: F401
