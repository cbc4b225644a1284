"""Build-and-load policy for the repo's native host libraries (``native/``).

A copy of the JAX package's ``utils/native_lib.py``: make runs once per
process on first load (a no-op when fresh, so ``.cpp`` edits are picked
up), a failed make is tolerated when a built ``.so`` exists, and ``None``
means no native path (callers keep their numpy fallback).  The library is
shared with the JAX package — both load ``native/build/lib{name}.so``.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

__all__ = ["load_native_lib", "NATIVE_DIR"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")

_MAKE_RAN = False

# The lock lives OUTSIDE native/build: `make clean` removes build/, and
# unlinking a held lock would let a second process compile concurrently.
_LOCK_PATH = os.path.join(NATIVE_DIR, ".make.lock")


def _run_make_locked() -> None:
    """make under an exclusive file lock, so concurrent processes never
    dlopen a half-written library."""
    with open(_LOCK_PATH, "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def load_native_lib(lib_name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load ``native/build/lib{lib_name}.so``;
    ``None`` means no native path.  Callers cache the result and declare
    their own symbol signatures."""
    global _MAKE_RAN
    so_path = os.path.join(NATIVE_DIR, "build", f"lib{lib_name}.so")
    if not _MAKE_RAN and os.path.exists(os.path.join(NATIVE_DIR,
                                                     "Makefile")):
        _MAKE_RAN = True
        try:
            _run_make_locked()
        except (OSError, subprocess.SubprocessError):
            if not os.path.exists(so_path):
                return None
    try:
        # shared lock around dlopen: a concurrent rebuild writes -o
        # straight onto this path
        with open(_LOCK_PATH, "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_SH)
            try:
                return ctypes.CDLL(so_path)
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)
    except OSError:
        return None
