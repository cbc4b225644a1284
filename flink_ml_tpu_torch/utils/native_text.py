"""ctypes binding for the native batch text hasher (native/texthash.cpp).

The pure-Python FNV-1a in ``models/feature/text.py`` loops per byte per
token in the interpreter; for corpus-scale HashingTF that loop IS the
featurization cost.  This binding concatenates all tokens into one buffer
and hands the whole batch to C++ (bit-identical hash values).  Every entry
point degrades to ``None`` when the toolchain/library is unavailable so
callers keep their pure-Python fallback.

A copy of the JAX package's ``utils/native_text.py``: it loads the same
``native/build/libtexthash.so`` through this package's
``utils/native_lib.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from .native_lib import load_native_lib

__all__ = ["fnv1a_batch", "hashing_tf", "native_available"]

_LIB = None
_LIB_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    lib = load_native_lib("texthash")
    if lib is not None:
        lib.th_fnv1a_batch.restype = None
        lib.th_fnv1a_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p]
        lib.th_hashing_tf.restype = None
        lib.th_hashing_tf.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _native_lib() is not None


def _pack(strings: Sequence) -> tuple:
    """Concatenate utf-8 encodings + (n+1,) int64 offsets.

    ASCII batches (the overwhelming case) take a one-join one-encode fast
    path where byte offsets equal character offsets; ``str.isascii`` is a
    C-speed scan, so neither branch encodes any string twice."""
    as_str = [str(s) for s in strings]
    joined = "".join(as_str)
    offsets = np.zeros(len(as_str) + 1, np.int64)
    if joined.isascii():              # byte len == char len
        data = joined.encode("utf-8")
        np.cumsum(np.fromiter(map(len, as_str), np.int64,
                              count=len(as_str)), out=offsets[1:])
    else:
        encoded = [s.encode("utf-8") for s in as_str]
        data = b"".join(encoded)
        np.cumsum(np.fromiter(map(len, encoded), np.int64,
                              count=len(encoded)), out=offsets[1:])
    return data, offsets


def fnv1a_batch(strings: Sequence) -> Optional[np.ndarray]:
    """64-bit FNV-1a of each string's utf-8 form; None when no native lib
    (caller falls back to the Python loop)."""
    lib = _native_lib()
    if lib is None:
        return None
    data, offsets = _pack(strings)
    out = np.empty(len(strings), np.uint64)
    lib.th_fnv1a_batch(data, offsets.ctypes.data, len(strings),
                       out.ctypes.data)
    return out


def hashing_tf(docs, m: int, binary: bool) -> Optional[np.ndarray]:
    """The full HashingTF document-term fill for ``docs`` (iterable of
    token lists) into an (n_docs, m) float64 matrix; None when no lib."""
    lib = _native_lib()
    if lib is None:
        return None
    tokens: List = []
    counts = np.empty(len(docs), np.int64)
    for i, doc in enumerate(docs):
        toks = np.ravel(np.asarray(doc, dtype=object))
        counts[i] = len(toks)
        tokens.extend(toks)
    data, offsets = _pack(tokens)
    out = np.zeros((len(docs), m), np.float64)
    lib.th_hashing_tf(data, offsets.ctypes.data, counts.ctypes.data,
                      len(docs), m, 1 if binary else 0, out.ctypes.data)
    return out
