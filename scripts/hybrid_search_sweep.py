#!/usr/bin/env python3
"""Device time of ``hybrid_search``'s two row sweeps, vector and scalar.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 scripts/hybrid_search_sweep.py

The kernel (``src/repro_torch/kernels/csrc/hybrid_search.cu``) loads a row
with 16-byte vector loads when C % 4 == 0 and the rows are 16-byte
aligned, and with 4-byte scalar loads otherwise. This builds the source
as it is and a copy whose launcher always takes the scalar sweep, holds
both against the plain twin bit for bit at ``chip_smoke.py``'s three
``hybrid_search`` shapes (C = 160), and times them in turns (vector,
scalar, scalar, vector, three times over) with ``torch.profiler``, the
kernel's device time per call. One line per shape gives every time and
the two means; the last line is the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"fig3a": (200, 256, 160, 128), "scale_path": (8000, 16384, 160, 128),
          "scale": (8000, 16384, 160, 4096)}
VEC_TEST = "const bool vec = c % 4 == 0 &&"


def _scalar_library():
    """The kernel's source with the vector sweep never chosen, built and
    loaded with the shipped library's C signature."""
    from repro_torch.kernels import build as B
    from repro_torch.kernels import hybrid_search as HS
    src = (B.CSRC / "hybrid_search.cu").read_text()
    if VEC_TEST not in src:
        sys.exit("hybrid_search_sweep: the launcher's sweep choice "
                 f"({VEC_TEST!r}) is not in the source")
    B.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=B.BUILD_DIR))
    cu = tmp / "hybrid_search_scalar.cu"
    cu.write_text(src.replace(VEC_TEST, "const bool vec = false &&"))
    lib = tmp / "libhybrid_search_scalar.so"
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).hybrid_search_launch
    fn.argtypes, fn.restype = HS._SYMBOLS["hybrid_search_launch"]
    return fn


def _launcher(fn):
    import torch

    def launch(keymin, blocks, queries):
        m, c = blocks.shape
        b = queries.shape[0]
        out = torch.empty((5 * b,), dtype=torch.uint8, device=queries.device)
        err = fn(keymin.data_ptr(), blocks.data_ptr(), queries.data_ptr(),
                 out.data_ptr(), out.data_ptr() + 4 * b, m, c, b,
                 torch._C._cuda_getCurrentRawStream(queries.device.index))
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out[:4 * b].view(torch.int32), out[4 * b:].view(torch.bool)
    return launch


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("hybrid_search_sweep: needs a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import hybrid_search as HS
    from repro_torch.kernels import ops as K

    paths = {"vector": _launcher(HS._fn()),
             "scalar": _launcher(_scalar_library())}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for name, (m_live, m, c, b) in SHAPES.items():
        km, bl = C._registry(rng, m_live, m, c)
        q = C._queries(rng, bl, b)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (km, bl, q)]
        assert args[1].data_ptr() % 16 == 0
        want = K.hybrid_search_ref(*args)
        for path, launch in paths.items():
            got = launch(*args)
            torch.cuda.synchronize()
            C.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"{name}: the {path} sweep != the plain twin")
        times = {p: [] for p in paths}
        for _ in range(3):
            for p in ("vector", "scalar", "scalar", "vector"):
                times[p].append(C.device_ms(
                    lambda: paths[p](*args), name="hybrid_search_kernel"))
        print(f"{name} (M={m}, C={c}, B={b}), us per call: " + "; ".join(
            f"{p} " + ", ".join(f"{t * 1e3:.3f}" for t in ts)
            + f" (mean {statistics.mean(ts) * 1e3:.3f})"
            for p, ts in times.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
