"""Build and load the port's hand-written CUDA kernels.

Each ``kernels/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Every library builds and loads through an
:class:`~flink_ml_tpu_torch.kernels.aot.ExecutableCache`
(:func:`library_cache`): the configured cache root
(``FrameworkConfig.aot_cache_path``, env ``FLINK_ML_TPU_AOT_CACHE_PATH``)
where one is set, else ``kernels/build/`` (listed in ``.gitignore``), so
a bare checkout builds what it runs.  A library's key digests its source,
the shared ``.cuh`` headers and :data:`NVCC_FLAGS` with the environment
fingerprint (torch, CUDA, nvcc, the card), so an edited source, a new
toolchain or another card builds anew and a stale library is never
loaded; an entry whose bytes fail their manifest is quarantined and
rebuilt, never loaded.  ``nvcc`` runs with ``-Xptxas=-v``; its report
(registers, shared memory, spills) is kept in the entry as
``lib<name>.log``.  A failed build raises.

Nothing here runs at import: the CPU tests import every module on
machines with no ``nvcc`` and no card.

Thread-safe: serving launches kernels from its serve thread and from a
deploy thread warming the next generation at the same time, so the
first use of a library builds and loads it under one process-wide lock
(one ``nvcc`` however many threads arrive), and :func:`count_launch`
adds to the ops modules' launch counters under another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build_all",
           "load_library", "library_cache", "nvcc_path", "nvcc_runs",
           "build_log", "count_launch"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
#: the cache root when none is configured
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: loaded libraries by (cache root, name)
_LOADED: Dict[Tuple[str, str], ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_CACHE_LOCK = threading.Lock()
_CACHES: Dict[str, object] = {}
_NVCC_RUNS = [0]


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


def _source_hash(name: str) -> str:
    """Digest of ``csrc/<name>.cu``, every shared ``.cuh`` header and
    :data:`NVCC_FLAGS`: the library's identity before the environment."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    for hdr in sorted(os.listdir(CSRC_DIR)):
        if hdr.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, hdr), "rb") as f:
                h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_cache():
    """The cache the libraries build and load through: the configured
    root (``aot.active_cache()``), else one rooted at :data:`BUILD_DIR`."""
    from .aot import ExecutableCache, active_cache

    cache = active_cache()
    if cache is not None:
        return cache
    root = BUILD_DIR
    with _CACHE_LOCK:
        cache = _CACHES.get(root)
        if cache is None:
            cache = _CACHES[root] = ExecutableCache(root)
    return cache


def _key(name: str, cache) -> str:
    return cache.key_for("library", name, _source_hash(name))


def _payload(name: str) -> str:
    return f"lib{name}.so"


def _target(name: str) -> str:
    """Where the committed library for ``name`` lives in
    :func:`library_cache` (whether or not it is built yet)."""
    cache = library_cache()
    return os.path.join(cache.entry_dir(_key(name, cache)), _payload(name))


def build_log(name: str) -> Optional[str]:
    """The ``nvcc`` report of the library built for ``name``."""
    path = _target(name)[:-3] + ".log"
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def nvcc_runs() -> int:
    """``nvcc`` processes this process has started."""
    return _NVCC_RUNS[0]


def _start_nvcc(name: str, out_dir: str) -> subprocess.Popen:
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o",
           os.path.join(out_dir, _payload(name)), _source(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    with _COUNT_LOCK:
        _NVCC_RUNS[0] += 1
    return proc


def _finish_nvcc(name: str, out_dir: str, proc: subprocess.Popen
                 ) -> Optional[str]:
    """Wait for ``proc``, keep its report as ``lib<name>.log``; returns
    None, or the failure's text."""
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        return f"{name}: nvcc timed out\n{out}"
    with open(os.path.join(out_dir, f"lib{name}.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        return f"{name}: nvcc exited {proc.returncode}\n{out}"
    return None


def _build_one(name: str, out_dir: str) -> str:
    """``build`` callable of the cache: one nvcc into ``out_dir``."""
    failure = _finish_nvcc(name, out_dir, _start_nvcc(name, out_dir))
    if failure is not None:
        raise RuntimeError("kernel build failed:\n" + failure)
    return _payload(name)


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Build every library in ``names`` (default: every source in
    ``csrc/``) that :func:`library_cache` holds no valid entry for, all
    ``nvcc`` processes at once, and commit each; returns the wall
    seconds.  Each builds in a private tmp dir committed into place, so a
    concurrent process never loads a half-written library."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR)
                       if f.endswith(".cu"))
    cache = library_cache()
    t0 = time.perf_counter()
    procs: List[tuple] = []
    for name in names:
        key = _key(name, cache)
        if cache.entry_payload(key) is not None:
            continue
        tmp = cache.begin_entry(key)
        procs.append((name, key, tmp, _start_nvcc(name, tmp)))
    failures = []
    for name, key, tmp, proc in procs:
        failure = _finish_nvcc(name, tmp, proc)
        if failure is not None:
            failures.append(failure)
            shutil.rmtree(tmp, ignore_errors=True)
            continue
        path = cache.commit_entry(key, tmp, _payload(name), label=name,
                                  seconds=time.perf_counter() - t0)
        if path.startswith(tmp + os.sep):
            shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` from
    :func:`library_cache`: its committed entry, else a live build that is
    committed first.  Memoised per process and cache root; concurrent
    first calls build once."""
    cache = library_cache()
    memo = (cache.root, name)
    lib = _LOADED.get(memo)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(memo)
            if lib is None:
                lib, _ = cache.load_or_build(
                    _key(name, cache), lambda out: _build_one(name, out),
                    label=name, load=lambda path: ctypes.CDLL(path))
                _LOADED[memo] = lib
    return lib


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]`` (an ops module's ``LAUNCHES``) under a
    lock: launches come from several threads when serving."""
    with _COUNT_LOCK:
        counts[name] += 1
