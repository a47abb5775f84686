"""Build the port's CUDA sources into plain-C shared libraries.

Each kernel source under ``csrc/`` is compiled at first use with ``nvcc
-gencode arch=compute_90a,code=sm_90a`` into its own shared library and
loaded with ``ctypes`` — seconds to build, where a source that includes
PyTorch's headers takes minutes. The libraries go to ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. The build writes to a temporary file and renames it into place, so
two processes building the same library race safely.

Nothing here runs at import: the CPU tests import the kernel modules on
machines without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict = {}
# wall time of this process's build of each library (absent if reused)
build_seconds: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` is built to, named by source + flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` if this source has not been built yet.
    Returns the library's path. ``verbose`` rebuilds with ``-Xptxas -v``
    and prints nvcc's report (registers, shared memory, spills)."""
    out = library_path(name)
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = pathlib.Path(tmp) / out.name
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp_out), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp_out, out)   # atomic: a concurrent build races safely
    build_seconds[name] = time.perf_counter() - t0
    return out


def load(name: str, symbols: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process.
    ``symbols`` maps each C entry point to its ``(argtypes, restype)``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for sym, (argtypes, restype) in symbols.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
    return lib
