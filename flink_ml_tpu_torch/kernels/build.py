"""Build and load the port's hand-written CUDA kernels.

Each ``kernels/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``kernels/build/`` (listed in
``.gitignore``): one ``nvcc`` process per source, all started together.
A library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.  ``nvcc``
runs with ``-Xptxas=-v``; its report (registers, shared memory, spills)
is kept beside each library as ``<name>.log``.

Nothing here runs at import: the CPU tests import every module on
machines with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all",
           "load_library", "nvcc_path", "build_log"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA toolkit is needed to build the "
        "port's kernels")


def _source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _target(name: str) -> str:
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    # headers shared between sources count toward every library's hash
    for hdr in sorted(os.listdir(CSRC_DIR)):
        if hdr.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, hdr), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> Optional[str]:
    """The ``nvcc`` report of the library last built for ``name``."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every stale library in ``names`` (default: every source in
    ``csrc/``), all ``nvcc`` processes at once; returns the wall seconds.
    Each compiles to a private temporary name and is renamed into place,
    so a concurrent process never loads a half-written library."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                       if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        target = _target(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, _source(name)]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, target, tmp, proc in procs:
        try:
            log, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out\n{log}")
            continue
        with open(target[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed.  Cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_target(name))
        _LOADED[name] = lib
    return lib
