"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root at
first use, then loaded with ``ctypes``. The library's file name carries a
hash of its source, so an edited source is rebuilt and a stale library is
never loaded. Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if no
    library of this source exists yet."""
    lib = _LOADED.get(name)
    if lib is None:
        source = CSRC / f"{name}.cu"
        digest = hashlib.sha1(source.read_bytes() + " ".join(
            NVCC_FLAGS).encode()).hexdigest()[:12]
        target = BUILD_DIR / f"lib{name}-{digest}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        lib = _LOADED[name] = ctypes.CDLL(str(target))
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
