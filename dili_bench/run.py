"""One run of one benchmark cell of the PyTorch and CUDA DiLi port.

    python3 dili_bench/run.py --workload dili_1srv.ycsb_a --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout that holds ``src/repro_torch``. The run loads
the configuration's keys from ``--seed``, settles the balancer, warms up
with the cell's own mix, then drives the servers for ``--seconds`` (see
``drive.py``); after the window it drains, settles again, reads every
server's keys and holds every answer against the plain sorted set
(``reference.py``). With ``--trace 0`` it reports the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py``. The last line of standard output is the result, a
JSON object; the numbers compared with the reference, each beside its
limit, close standard error and the result line. Without a CUDA card, or
with fewer than the cell asks for, it fails and prints no result; so it
does if JAX or the JAX package is loaded when the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
THREADS = 1


def pick_core(cores, env) -> int:
    """The core a run keeps to, among ``cores``, the ones it was given: the
    last for the first card ``CUDA_VISIBLE_DEVICES`` names (or for no such
    setting), the one before it for the next card, and so on, so that runs
    on different cards of one host take different cores."""
    cores = sorted(cores)
    first = env.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    card = int(first) if first.isdigit() else 0
    return cores[-1 - card % len(cores)]


def pin_to_one_core() -> int:
    """Keeps the process, and the threads it starts later, on one core:
    the program is host-bound, and a run that may move between cores
    spread twice as wide on the H100's host (PERF.md, chip call 10)."""
    core = pick_core(os.sched_getaffinity(0), os.environ)
    os.sched_setaffinity(0, {core})
    return core


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), required=True)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        p.error("--seed must be >= 0 and --seconds > 0")
    return args


def compared(verdict: dict, drained: bool) -> dict:
    """The numbers held against the reference, each with its limit: every
    one is a count that a correct run leaves at 0."""
    return {"unanswered": [verdict["unanswered"], 0],
            "error_answers": [verdict["error_answers"], 0],
            "nonlinear_keys": [verdict["nonlinear_keys"], 0],
            "stray_keys": [verdict["stray_keys"], 0],
            "not_drained": [int(not drained), 0]}


def judge(rec: dict):
    """``(correct, attempted, failed, compared)`` of a run's record."""
    from dili_bench import reference
    import numpy as np
    h = rec["history"]
    verdict = reference.check(h["kind"], h["key"], h["submitted"],
                              h["answered"], h["res"], rec["final_sets"])
    cmp = compared(verdict, rec["drained"])
    due = rec["due"]
    wrong = (h["answered"] < 0) | ~np.isin(h["res"], (0, 1)) \
        | np.isin(h["key"], verdict["bad_keys"])
    correct = all(v <= lim for v, lim in cmp.values())
    return correct, int(due.sum()), int((due & wrong).sum()), cmp, verdict


def result(bench: dict, workload: str, trace: bool, rec: dict,
           device: dict, correct: bool, attempted: int, failed: int,
           cmp: dict) -> dict:
    """The result line: the contract's keys, then ``compared`` last."""
    from dili_bench import spec
    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dict(device)}
    if trace:
        prof = rec["profile"]
        out["device"]["busy_s"] = prof["busy_s"]
        out["device"]["window_s"] = prof["wall_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["compared"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in cmp.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    core = pin_to_one_core()
    from dili_bench import spec
    bench = spec.benchmark()
    entry, conf, mix = spec.cell(bench, args.workload)
    chips = entry["chips"]
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program, {src / 'repro_torch'}, is not in this "
              f"checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.set_num_threads(THREADS)
    torch.cuda.init()
    devices = [f"cuda:{s % chips}" for s in range(conf["servers"])]
    cards = sorted(set(devices))
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)

    from functools import partial
    from dili_bench import drive, profiling
    rec = drive.run(conf, mix, args.seed, args.seconds, bool(args.trace),
                    devices, T_START,
                    profile_window=partial(profiling.profile_window,
                                           devices=devices))
    peak = max(torch.cuda.max_memory_allocated(d) for d in cards)
    gc.collect()
    torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    correct, attempted, failed, cmp, verdict = judge(rec)
    t_judge = time.perf_counter() - t_judge
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    out = result(bench, args.workload, bool(args.trace), rec, device,
                 correct, attempted, failed, cmp)

    info = dict(core=core, rounds=rec["rounds"],
                load_rounds=rec["load_rounds"],
                settle_rounds=rec["settle_rounds"],
                load_s=rec["load_s"], load_settle_s=rec["load_settle_s"],
                after_window_s=rec["after_window_s"], judge_s=t_judge,
                window_rounds=rec["window_rounds"],
                window_ops=rec["window_ops"], stats=rec["stats"],
                window_host_s=rec["host_s"],
                ops=int(rec["history"]["kind"].size),
                undecided_keys=verdict["undecided_keys"],
                bad_keys=verdict["bad_keys"][:10],
                reference_keys=verdict["reference_keys"])
    if args.trace:
        info.update(timer_rounds=rec["timer_rounds"], spans=rec["spans"],
                    profile={k: v for k, v in rec["profile"].items()
                             if k not in ("device_ops", "idle_gaps")})
    print("info " + json.dumps(info), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for k, (v, lim) in cmp.items():
        print(f"compared {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
