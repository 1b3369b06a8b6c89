"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry ``<name>_launch`` (and may have
more, ``<entry>_launch``, for the same kernel's other modes) and compiles
on its own into ``_build/<name>-<digest>.so`` inside the package, at first
use, for ``sm_90a`` (Hopper). The digest covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and
a stale library is never loaded. Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_entries: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on PATH or under /usr/local/cuda")
    return nvcc


def _library(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict:
    """Compile each named kernel that has no up-to-date library, one nvcc
    process per source, all started together. Returns {name: nvcc output}
    for the ones compiled (ptxas register and spill report included);
    raises with the compiler's output if any build fails."""
    jobs = []
    for name in names:
        src, lib = _library(name)
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, lib))
    logs, failed = {}, []
    for name, proc, tmp, lib in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:  # atomic: a concurrent build never sees half a file
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def entry(name: str, argtypes, source: str | None = None):
    """The loaded ``<name>_launch`` C function of ``csrc/<source>.cu``
    (``source`` defaults to ``name``; built first if needed), with its
    argument types set and an int (cudaError_t) result."""
    source = source or name
    with _lock:
        fn = _entries.get(name)
        if fn is None:
            build([source])
            fn = getattr(ctypes.CDLL(_library(source)[1]), name + "_launch")
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[name] = fn
    return fn
