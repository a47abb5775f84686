"""Perf probe: the collectives of one (arch, shape, mesh) cell by bytes
(the reference's ``launch/perfprobe.py``).

Prints the top collectives of one traced step at a probe depth, each
with its shape and the module that issued it — the innermost
``nn.Module`` running at the time, forward or backward (``CostMode``'s
module tracking), where the reference reads the HLO's ``op_name``
metadata.

Usage:
  python -m repro_torch.launch.perfprobe --arch qwen2-72b --shape train_4k
"""
from __future__ import annotations

import argparse
import collections

from ..configs import get_config
from ..models.config import shape_by_name
from .dryrun import _trace_cell
from .mesh import production_mesh


def breakdown(events, top=15):
    """(rows, counts): the ``top`` (kind, shape, module) keys by total
    bytes, and how many collectives each key summed."""
    agg = collections.Counter()
    meta = collections.Counter()
    for e in events:
        key = (e["kind"], f"{e['dtype']}{list(e['shape'])}"[:60],
               e["module"][:90])
        agg[key] += e["bytes"]
        meta[key] += 1
    return agg.most_common(top), meta


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=2, help="probe depth")
    ap.add_argument("--model-size", type=int, default=16,
                    help="logical model-axis size (256/model = data)")
    ap.add_argument("--override", default="",
                    help="comma k=v ArchConfig overrides, e.g. "
                         "attn_q_chunk=1024,remat=False")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cpu without a card)")
    args = ap.parse_args(argv)

    over = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        over[k] = eval(v)  # noqa: S307 - trusted CLI
    cfg = get_config(args.arch).replace(n_layers=args.layers, **over)
    cell = shape_by_name(args.shape)
    with production_mesh(multi_pod=args.multi_pod,
                         model_size=args.model_size,
                         device_type=args.device) as mesh:
        kind, cost, _ = _trace_cell(cfg, cell, mesh, modules=True)
    print(f"probe {args.arch} x {args.shape} L={args.layers} kind={kind} "
          f"overrides={over}")
    print(f"  flops/dev={cost.flops:.4e}  bytes/dev={cost.bytes:.4e}")
    rows, counts = breakdown(cost.events)
    total = sum(cost.collectives.values())
    print(f"  collective total/dev: {total:.4e} bytes")
    for (ck, shape, mod), nbytes in rows:
        print(f"   {nbytes/1e6:10.1f}MB x{counts[(ck, shape, mod)]:3d} "
              f"{ck:18s} {shape:45s} {mod}")


if __name__ == "__main__":
    main()
