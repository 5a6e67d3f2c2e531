"""Build and load the package's CUDA sources (nvcc -> shared library ->
ctypes), at first use.

Each library is compiled from `csrc/<name>.cu` for sm_90a into
`_build/lib<name>-<hash>.so`, where the hash covers the source and the
flags: a changed source builds anew, an unchanged one loads the existing
library. The build writes to a temporary name and renames it into place,
so concurrent first uses never load a half-written file. What ptxas says
of each kernel (registers, shared memory, spills) is kept beside the
library and in `ptxas_log`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()
build_seconds: dict = {}      # name -> seconds spent in nvcc (0.0: cached)
ptxas_log: dict = {}          # name -> nvcc's stderr of the build (ptxas -v)


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of hslam_tpu_torch "
                       "need the CUDA toolkit to build")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
            with open(so + ".ptxas.txt", "w") as f:
                f.write(proc.stderr)
            os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
        with open(so + ".ptxas.txt") as f:
            ptxas_log[name] = f.read()
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
