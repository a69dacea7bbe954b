"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/`` at the repository root at
first use, then loaded with ``ctypes``; :func:`load_all` compiles
several sources in parallel. The library's file name carries a hash of its
source and of every local header it includes (``#include "x.cuh"``), so an
edited source or header is rebuilt and a stale library is never loaded.
The compiler's report (``-Xptxas -v``: each kernel's registers, spills and
shared memory) of a build in this process is kept for :func:`report`.
Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception. The libraries link
no ``libcuda``: a kernel that needs one of its entry points (the TMA
tensor maps' ``cuTensorMapEncodeTiled``) looks it up at run time with
``cudaGetDriverEntryPoint``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_LOADED: dict = {}
_REPORTS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, recursively,
    in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def report(name: str) -> str:
    """The compiler's output of ``name``'s build in this process ("" if its
    library was found already built)."""
    return _REPORTS.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if no
    library of this source and its headers exists yet."""
    lib = _LOADED.get(name)
    if lib is None:
        source = CSRC / f"{name}.cu"
        target = _target(name)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n"
                                   f"{proc.stdout}{proc.stderr}")
            _REPORTS[name] = proc.stdout + proc.stderr
            os.replace(tmp, target)
        lib = _LOADED[name] = ctypes.CDLL(str(target))
    return lib


def load_all(names) -> list:
    """:func:`load` of every name, each in its own thread, so that their
    ``nvcc`` runs all start together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load, names))


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
