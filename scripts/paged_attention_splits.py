#!/usr/bin/env python3
"""Device time of the ``paged_attention`` kernel for each split plan.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/paged_attention_splits.py

At ``chip_smoke.py``'s serving shape (Qwen2-0.5B: B=8, H=14, KH=2, D=64,
S=16, PP=34, f32) the kernel runs with each plan of (splits, pages per
split), for three sets of lengths: the serving phase's prompt lengths,
one page per sequence, and the full table. Each plan's output is first
held against the plain twin (atol 2e-5, rtol 2e-2). One line per set of
lengths gives the device time per call (``torch.profiler``, every device
operation of the call) of each plan, and marks the plan that
``split_pages`` picks; the last line is the card's name and power limit.
From the columns: one split walking all 34 pages gives the time of a page
step, and the one-page lengths give the fixed cost of the split merge.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANS = ((34, 1), (17, 2), (12, 3), (9, 4), (7, 5), (4, 9), (1, 34))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_attention_splits: needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attention as PA

    b, h, kh, d, ps = C.SERVE["live"], 14, 2, 64, C.SERVE["page_size"]
    pp = -(-(C.SERVE["prompt_hi"] + C.SERVE["max_new"]) // ps)
    picked = PA.plan(b, h, kh, pp, PA.sm_count(torch.device("cuda")))[1:]
    serve = [len(p) for p in C.serve_requests(get_config("qwen2_0_5b").vocab)]
    for name, lens in (("serving", serve), ("one_page", [ps] * b),
                       ("full", [pp * ps] * b)):
        args = C._paged_case(b, h, kh, d, pp, ps, torch.float32, seed=1,
                             lens=lens)
        twin = K.paged_attention_ref(*args, page_size=ps)
        row = []
        for plan in PLANS:
            out = PA.launch(*args, splits=plan)
            torch.cuda.synchronize()
            C.check(torch.allclose(out, twin, **C.PAGED_TOL["f32"]),
                    f"{name} {plan}: kernel != twin")
            ms = C.device_ms(lambda: PA.launch(*args, splits=plan))
            mark = "*" if plan == picked else ""
            row.append(f"{plan[0]}x{plan[1]}{mark} {ms * 1e3:.3f}")
        print(f"{name} (us per call, splits x pages, * = split_pages): "
              + "; ".join(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
