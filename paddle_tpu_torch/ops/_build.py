"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface. On
first use it is compiled by nvcc for Hopper (``sm_90a``) into a shared
library under ``paddle_tpu_torch/_build/`` (git-ignored; the file name
carries a hash of the source and flags, so an edited source rebuilds)
and loaded with ctypes. Pointers and the CUDA stream cross as
``ctypes.c_void_p``; every C entry point returns ``cudaGetLastError()``
and the wrapper raises when it is not 0 (``ops/_launch.py``).

There is no fallback: a missing nvcc or a failed build raises. Build
all sources at once (one nvcc process each, in parallel) with
`build_all`; `load` builds a single one on demand.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("quant_ops", "lowp")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ on first use")


def _target(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(name):
    """nvcc one source into its library (atomic rename); returns the
    library path and nvcc's diagnostics (ptxas -v lines included)."""
    src, out = _target(name)
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {src.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


def build_all(names=SOURCES):
    """Compile every source concurrently (one nvcc each). Returns
    ``{name: nvcc diagnostics}``."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = dict(zip(names, pool.map(_compile, names)))
    return {name: log for name, (_path, log) in results.items()}


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _log = _compile(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib

