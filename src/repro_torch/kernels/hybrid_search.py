"""Build and launch the Hopper ``hybrid_search`` kernel (``csrc/hybrid_search.cu``).

The source is compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a plain-C shared library and loaded with
``ctypes`` — seconds to build, where a source that includes PyTorch's
headers takes minutes. The library goes to ``build/kernels/`` at the root
of the checkout (listed in ``.gitignore``), named by a hash of the source,
so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import: the CPU tests import this module on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "hybrid_search.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of this process's build, None if reused


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the hybrid_search kernel is "
                           "built from source on a machine with the CUDA "
                           "toolkit")
    return path


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhybrid_search-{digest[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet.
    Returns its path. ``verbose`` adds ``-Xptxas -v`` and prints nvcc's
    report (registers, shared memory, spills)."""
    global build_seconds
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = pathlib.Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp_out), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp_out, out)   # atomic: a concurrent build races safely
    build_seconds = time.perf_counter() - t0
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.hybrid_search_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
                [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def levels(m: int) -> int:
    """Binary-search steps over M registry entries (as the TPU kernel)."""
    return max(1, math.ceil(math.log2(max(m, 2))))


def launch(keymin: torch.Tensor, blocks: torch.Tensor,
           queries: torch.Tensor):
    """Launch on the current CUDA stream. Inputs are validated by the
    public wrapper (``kernels/ops.py``); outputs are allocated here."""
    lib = _load()
    m, c = blocks.shape
    b = queries.shape[0]
    slot = torch.empty((b,), dtype=torch.int32, device=queries.device)
    found = torch.empty((b,), dtype=torch.bool, device=queries.device)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    err = lib.hybrid_search_launch(
        keymin.data_ptr(), blocks.data_ptr(), queries.data_ptr(),
        slot.data_ptr(), found.data_ptr(), m, c, b, levels(m), stream)
    if err != 0:
        raise RuntimeError(f"hybrid_search launch failed: cudaError {err}")
    return slot, found
