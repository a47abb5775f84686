"""The control of ``correct``: the plain sorted set put in the program's
place, with one of the configuration's guarantees broken, driven by the
same loop and judged by the same reference. It has to come out not
correct; the benchmark's own runs never run it.

Two breaks, each a step that would tempt a faster index:
- ``stale``: FINDs answered from the set as it stood one round earlier,
  as from a read replica one round behind (what replication's staleness
  allows): not linearizable wherever a key changed in the round before.
  Under a read-only mix nothing changes, and it reads correct there.
- ``filter``: FINDs answered by an approximate membership filter that
  says "present" for 1% of absent keys, without asking the index.

    python3 dili_bench/control.py --workload dili_1srv.ycsb_a \\
        --break stale --seed 7 --rounds 60

runs the control at the cell's own size (its keys, key space, clients and
mix) for ``--rounds`` window rounds, and prints the numbers compared.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dili_bench.reference import SortedSet  # noqa: E402
from dili_bench.ycsb import OP_FIND  # noqa: E402

BREAKS = ("stale", "filter")


def _filter_hit(key: int) -> bool:
    return (key * 2654435761) % (1 << 32) % 100 == 0


class BrokenSet:
    """A backend stand-in: every op fed to a round is answered in it, in
    feed order, by one sorted set, except FINDs, as ``mode`` breaks them."""

    def __init__(self, servers: int, mode: str):
        if mode not in BREAKS:
            raise ValueError(f"break {mode!r} not in {BREAKS}")
        self.n = servers
        self.mode = mode
        self.set = SortedSet()
        self.before = set()
        self.queue: List[list] = [[] for _ in range(servers)]
        self.next_id = 0
        self.stats = {"rounds": 0}

    def submit(self, s, kinds, keys, values=None):
        ids = list(range(self.next_id, self.next_id + len(kinds)))
        self.next_id += len(kinds)
        self.queue[s].extend(zip(ids, kinds, keys))
        return ids

    def step(self):
        stale, self.before = self.before, set(self.set.keys)
        comps = []
        for s in range(self.n):
            for op_id, kind, key in self.queue[s]:
                if kind != OP_FIND:
                    val = self.set.apply(kind, key)
                elif self.mode == "stale":
                    val = int(key in stale)
                else:
                    val = int(key in self.set.keys or _filter_hit(key))
                comps.append((op_id, val, s))
            self.queue[s] = []
        self.stats["rounds"] += 1
        return comps

    def quiescent(self) -> bool:
        return not any(self.queue)

    def sublists(self, s):
        return [dict(owner=s, switched=False, head_idx=0)] if s == 0 else []

    def shard_chain(self, s, head_idx):
        return self.set.sorted()


def run(conf: dict, mix: dict, seed: int, mode: str, rounds: int) -> dict:
    """The control's numbers compared at ``conf``/``mix``'s size."""
    from dili_bench import drive
    from dili_bench.run import judge

    def make(conf, devices, spans):
        return BrokenSet(conf["servers"], mode), None

    rec = drive.run(conf, mix, seed, 0.0, False, ["cpu"] * conf["servers"],
                    time.perf_counter(), make=make, window_rounds=rounds)
    correct, attempted, failed, cmp, _ = judge(rec)
    return dict(correct=correct, attempted=attempted, failed=failed,
                compared={k: v for k, (v, _) in cmp.items()},
                window_ops=rec["window_ops"])


def main(argv=None) -> int:
    from dili_bench import spec
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--break", dest="mode", choices=BREAKS, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, required=True)
    args = p.parse_args(argv)
    _, conf, mix = spec.cell(spec.benchmark(), args.workload)
    out = run(conf, mix, args.seed, args.mode, args.rounds)
    print(json.dumps(dict(workload=args.workload, mode=args.mode,
                          seed=args.seed, rounds=args.rounds, **out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
