"""The durable cache of the port's compiled artifacts: the ``nvcc``-built
kernel libraries and the autotuner's measured decisions.

Eager PyTorch compiles no program per call, so where the JAX package
caches serialized XLA executables, the port caches what it does compile:
each ``kernels/csrc/<name>.cu`` built by ``kernels/build.py`` into
``lib<name>.so``.  One cache root holds:

- ``exec/<key>/``: one committed entry per library, holding
  ``lib<name>.so``, its ``-Xptxas=-v`` report ``lib<name>.log`` and
  ``meta.json``.  Every entry speaks the durability contract of
  ``robustness/durability.py``: payload files -> ``manifest.json`` CRCs
  -> ``COMMITTED`` marker, all written into a tmp dir that is
  ``os.replace``d into place, so a crash mid-write never leaves a
  trusted half-entry.
- ``autotune/<key>/decision.json``: the decisions of
  ``kernels/autotune.py``, committed the same way.

**Keying.**  A library's key digests the hash of its source, the shared
``.cuh`` headers and ``NVCC_FLAGS`` (``build._source_hash``) together
with :func:`env_fingerprint`: torch's version, ``torch.version.cuda``,
``nvcc``'s release line, the card's name and compute capability, and
:data:`AOT_FORMAT`.  A new nvcc, torch or card misses instead of loading
a library built for another world.

**Fail-safe loads.**  Before ``ctypes.CDLL`` sees an entry, its
manifest is verified and its recorded fingerprint compared with this
process's.  A truncated, flipped, unmanifested or skewed entry is
QUARANTINED (``<key>.corrupt``), counted (``kernel_stats``'s ``aot``
block) and rebuilt live: it is never loaded, and never swapped for a
plain version either.  A failed build raises.

**Races.**  Several processes (the ranks of a process group) may build
one key at once: each builds into its own tmp dir, the first
``os.replace`` commits, and a later one fails on the committed directory
(``ENOTEMPTY``), verifies the winner's entry and loads that.

**dlopen keeps one handle a path.**  Once a process has loaded a library
from a path, ``ctypes.CDLL`` of that path returns the same handle even
after the file is rebuilt, so a check that must see a rebuilt library
runs in a process that has not loaded from that root (a child process,
as ``chip_smoke.py`` phase 51 does).
"""

from __future__ import annotations

import functools
import hashlib
import json
import logging
import os
import shutil
import subprocess
import threading
import time

from typing import Any, Callable, Dict, Optional, Tuple

__all__ = [
    "ExecutableCache",
    "active_cache",
    "aot_jit",
    "env_fingerprint",
    "plan_token",
    "reset_cache",
    "set_cache",
    "stable_repr",
]

log = logging.getLogger("flink_ml_tpu_torch.kernels")

#: bump when the entry layout or the key recipe changes: old entries
#: become fingerprint-skewed (quarantined on contact), never misread
AOT_FORMAT = 1

_EXEC_DIR = "exec"
_TUNE_DIR = "autotune"
_META = "meta.json"
_DECISION = "decision.json"

_FINGERPRINT: list = []
_FP_LOCK = threading.Lock()


def _nvcc_release() -> Optional[str]:
    """``nvcc --version``'s release line, or None without nvcc."""
    from .build import nvcc_path

    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=120).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    return out.strip() or None


def env_fingerprint() -> Dict[str, Any]:
    """The environment a built library is valid in: torch's version,
    ``torch.version.cuda``, nvcc's release line, the card's name and
    compute capability, and :data:`AOT_FORMAT`.  Part of every key's
    digest AND checked against an entry's meta on load.  Memoised per
    process; total on a machine with no card and no nvcc, where those
    fields are None."""
    if _FINGERPRINT:
        return dict(_FINGERPRINT[0])
    with _FP_LOCK:
        if not _FINGERPRINT:
            import torch

            device = capability = None
            try:
                if torch.cuda.is_available():
                    device = torch.cuda.get_device_name(0)
                    capability = "%d.%d" % torch.cuda.get_device_capability(0)
            except Exception:  # noqa: BLE001 — a broken driver: no card
                device = capability = None
            _FINGERPRINT.append({
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "nvcc": _nvcc_release(),
                "device": device,
                "capability": capability,
                "format": AOT_FORMAT,
            })
    return dict(_FINGERPRINT[0])


def _code_fingerprint(fn: Callable) -> str:
    """Stable digest of a function's bytecode, transitive over the
    module-level functions (and dicts of functions) it references by
    name, so editing a helper changes the digest of its callers.
    Address-carrying reprs are never hashed."""
    h = hashlib.sha256()
    seen: set = set()

    def feed_code(code) -> None:
        h.update(code.co_code)
        for const in code.co_consts:
            if isinstance(const, (int, float, str, bytes, bool,
                                  type(None))):
                h.update(repr(const).encode())
            elif hasattr(const, "co_code"):
                feed_code(const)
        h.update(repr(code.co_names).encode())

    def feed_fn(f) -> None:
        wrapped = getattr(f, "__wrapped__", None)
        if wrapped is not None:       # aot_jit / functools wrappers
            feed_fn(wrapped)
            return
        code = getattr(f, "__code__", None)
        if code is None:
            h.update(repr(getattr(f, "__qualname__",
                                  type(f).__qualname__)).encode())
            return
        if id(code) in seen:
            return
        seen.add(id(code))
        feed_code(code)
        g = getattr(f, "__globals__", {})
        for name in code.co_names:
            ref = g.get(name)
            if ref is None:
                continue
            if isinstance(ref, dict):
                for val in ref.values():
                    if callable(val):
                        feed_fn(val)
            elif callable(ref) and (hasattr(ref, "__code__")
                                    or hasattr(ref, "__wrapped__")):
                feed_fn(ref)

    feed_fn(fn)
    return h.hexdigest()[:16]


def stable_repr(obj: Any, _depth: int = 0, _seen: Optional[set] = None
                ) -> str:
    """An address-free ``repr`` for cache keys: objects render as their
    qualified class plus the stable repr of their instance state,
    functions as qualified name + bytecode digest, primitives and
    containers recursively.  A value that cannot be seen through (a
    cycle, or nesting past the depth bound) is poisoned with its
    process-local ``id``, so its key never matches anything another
    process persisted."""
    if isinstance(obj, (int, float, complex, str, bytes, bool,
                        type(None))):
        return repr(obj)
    if _depth > 6:
        return f"<unkeyed:{type(obj).__qualname__}:{id(obj)}>"
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return f"<unkeyed:cycle:{id(obj)}>"
    _seen = _seen | {id(obj)}
    if isinstance(obj, tuple):
        return "(" + ",".join(stable_repr(x, _depth + 1, _seen)
                              for x in obj) + ")"
    if isinstance(obj, list):
        return "[" + ",".join(stable_repr(x, _depth + 1, _seen)
                              for x in obj) + "]"
    if isinstance(obj, dict):
        items = sorted((stable_repr(k, _depth + 1, _seen),
                        stable_repr(v, _depth + 1, _seen))
                       for k, v in obj.items())
        return "{" + ",".join(f"{k}:{v}" for k, v in items) + "}"
    if isinstance(obj, type):
        return f"<class {obj.__module__}.{obj.__qualname__}>"
    if callable(obj) and hasattr(obj, "__qualname__"):
        return (f"<fn {getattr(obj, '__module__', '?')}."
                f"{obj.__qualname__}:{_code_fingerprint(obj)}>")
    r = repr(obj)
    if " at 0x" not in r:
        return r
    state = getattr(obj, "__dict__", None)
    return (f"<{type(obj).__module__}.{type(obj).__qualname__} "
            f"{stable_repr(state, _depth + 1, _seen) if state else ''}>")


def plan_token(plan: tuple) -> str:
    """Cross-process identity of a dispatch plan: per stage, the
    module-qualified function name, its bytecode digest and the static
    config (:func:`stable_repr`)."""
    parts = []
    for fn, static in plan:
        parts.append((f"{fn.__module__}.{fn.__qualname__}",
                      _code_fingerprint(fn), stable_repr(static)))
    return repr(parts)


def _digest(kind: str, token: str, shape_repr: str,
            fingerprint: Dict[str, Any]) -> str:
    blob = json.dumps({"kind": kind, "token": token, "shapes": shape_repr,
                       "env": fingerprint}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _load_cdll(path: str):
    import ctypes

    return ctypes.CDLL(path)


class ExecutableCache:
    """One cache root: ``exec/<key>`` library entries plus
    ``autotune/<key>`` decision entries, shared by every consumer in the
    process and by every process pointed at the root.

    An entry is built by a callable ``build(out_dir) -> payload``: it
    writes its files into the fresh directory ``out_dir`` and returns the
    name of the file to load (``lib<name>.so``).  Loads are memoised per
    process (``_loaded``)."""

    def __init__(self, root: str):
        self.root = root
        self._fingerprint = env_fingerprint()
        self._lock = threading.Lock()
        self._build_lock = threading.Lock()
        self._loaded: Dict[str, Any] = {}
        self._decisions: Optional[Dict[Tuple[str, str], Dict]] = None
        os.makedirs(os.path.join(root, _EXEC_DIR), exist_ok=True)
        os.makedirs(os.path.join(root, _TUNE_DIR), exist_ok=True)

    # -- keys ----------------------------------------------------------------
    @property
    def fingerprint(self) -> Dict[str, Any]:
        return dict(self._fingerprint)

    def key_for(self, kind: str, token: str, shape_repr: str) -> str:
        return _digest(kind, token, shape_repr, self._fingerprint)

    def entry_dir(self, key: str) -> str:
        return os.path.join(self.root, _EXEC_DIR, key)

    # -- the load-or-build protocol ------------------------------------------
    def load_or_build(self, key: str, build: Callable[[str], str], *,
                      label: str = "?",
                      load: Callable[[str], Any] = _load_cdll
                      ) -> Tuple[Any, str]:
        """Resolve ``key``: the in-process memo, else a verified entry on
        disk (an *aot hit*), else a live ``build`` (an *aot miss*) that is
        committed and then loaded.  Returns ``(loaded, source)`` with
        source in ``("memory", "aot", "compile")``.  A damaged entry is
        quarantined and rebuilt; a failed build raises."""
        from .registry import kernel_stats

        with self._lock:
            got = self._loaded.get(key)
        if got is not None:
            return got, "memory"
        with self._build_lock:
            with self._lock:       # raced another thread's miss path
                got = self._loaded.get(key)
            if got is not None:
                return got, "memory"
            t0 = time.perf_counter()
            got = self._load_entry(key, load)
            if got is not None:
                kernel_stats.record_aot(label, event="hit",
                                        seconds=time.perf_counter() - t0)
                source = "aot"
            else:
                tmp = self.begin_entry(key)
                t0 = time.perf_counter()
                try:
                    payload = build(tmp)
                except BaseException:
                    shutil.rmtree(tmp, ignore_errors=True)
                    raise
                path = self.commit_entry(key, tmp, payload, label=label,
                                         seconds=time.perf_counter() - t0)
                try:
                    got = load(path)
                finally:
                    if path.startswith(tmp + os.sep):
                        shutil.rmtree(tmp, ignore_errors=True)
                source = "compile"
            with self._lock:
                self._loaded[key] = got
            return got, source

    def forget_loaded(self) -> None:
        """Drop the in-process memo, so the next resolve goes to disk as
        a fresh process would (see the module note on dlopen)."""
        with self._lock:
            self._loaded.clear()

    # -- disk entries --------------------------------------------------------
    def entry_payload(self, key: str) -> Optional[str]:
        """The path of ``key``'s payload when a valid committed entry
        holds it, else None.  A damaged or skewed entry is quarantined
        (and counted) on the way."""
        from ..robustness.durability import CorruptStateError, verify_dir
        from .registry import kernel_stats

        entry = self.entry_dir(key)
        if not os.path.isdir(entry):
            return None
        try:
            verify_dir(entry, allow_legacy=False)
            with open(os.path.join(entry, _META)) as f:
                meta = json.load(f)
            if meta.get("fingerprint") != self._fingerprint:
                raise CorruptStateError(
                    f"{entry}: fingerprint {meta.get('fingerprint')!r} is "
                    f"not this process's {self._fingerprint!r} (version or "
                    "device skew)")
            path = os.path.join(entry, meta["payload"])
            if not os.path.isfile(path):
                raise CorruptStateError(f"{entry}: payload {path} missing")
            return path
        except (CorruptStateError, OSError, KeyError, TypeError,
                ValueError) as exc:
            log.warning("cache entry failed validation (%s); quarantining "
                        "and rebuilding", exc)
            kernel_stats.record_aot(key, event="quarantine")
            self._quarantine_entry(entry)
            return None

    def _load_entry(self, key: str, load: Callable[[str], Any]):
        from .registry import kernel_stats

        path = self.entry_payload(key)
        if path is None:
            return None
        try:
            return load(path)
        except OSError as exc:
            # CRC-valid bytes the loader refuses: the same degraded path
            log.warning("cache entry %s failed to load (%r); quarantining "
                        "and rebuilding", path, exc)
            kernel_stats.record_aot(key, event="quarantine")
            self._quarantine_entry(self.entry_dir(key))
            return None

    @staticmethod
    def _quarantine_entry(entry: str) -> None:
        from ..robustness.durability import quarantine

        try:
            quarantine(entry)
        except OSError:
            # a concurrent process quarantined or replaced it first: the
            # bad bytes are out of the path either way
            pass

    def begin_entry(self, key: str) -> str:
        """A fresh private tmp dir for building ``key``'s entry."""
        tmp = (f"{self.entry_dir(key)}.tmp.{os.getpid()}."
               f"{threading.get_ident()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        return tmp

    def commit_entry(self, key: str, tmp: str, payload: str, *,
                     label: str, seconds: float = 0.0) -> str:
        """Commit the built entry in ``tmp`` (counted as a miss of
        ``seconds``) as ``exec/<key>``; returns the path to load from.
        Another process committing the key first leaves its verified
        entry in place, and that is what loads.  A store that fails (a
        full or read-only volume) leaves the payload in ``tmp`` for this
        process (counted ``store_failed``)."""
        from ..robustness.durability import commit_dir
        from .registry import kernel_stats

        kernel_stats.record_aot(label, event="miss", seconds=seconds)
        final = self.entry_dir(key)
        try:
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump({"format": AOT_FORMAT, "label": label,
                           "key": key, "fingerprint": self._fingerprint,
                           "payload": payload,
                           "payload_bytes": os.path.getsize(
                               os.path.join(tmp, payload))},
                          f, indent=1, sort_keys=True)
            commit_dir(tmp)
            os.replace(tmp, final)
        except OSError as exc:
            if os.path.isdir(final):
                won = self.entry_payload(key)
                if won is not None:
                    shutil.rmtree(tmp, ignore_errors=True)
                    return won
            kernel_stats.record_aot(label, event="store_failed")
            log.warning("cache store of %s failed (%r); this process "
                        "loads its own build", label, exc)
            return os.path.join(tmp, payload)
        kernel_stats.record_aot(label, event="store")
        return os.path.join(final, payload)

    # -- autotune decisions (the same durable root) --------------------------
    def _decision_dir(self, key: str) -> str:
        return os.path.join(self.root, _TUNE_DIR, key)

    def _device(self) -> Dict[str, Any]:
        return {"device": self._fingerprint["device"]}

    def _decision_key(self, op: str, sig_repr: str) -> str:
        return _digest("autotune", f"{op}|{sig_repr}", "", self._device())

    def _load_decisions(self) -> Dict[Tuple[str, str], Dict]:
        """Scan every committed decision once per process; a damaged one
        is quarantined (searched again at its next encounter), a valid
        one recorded for another device is skipped."""
        from ..robustness.durability import (CorruptStateError, quarantine,
                                             verify_dir)
        from .registry import kernel_stats

        decisions: Dict[Tuple[str, str], Dict] = {}
        root = os.path.join(self.root, _TUNE_DIR)
        device = self._device()
        for name in sorted(os.listdir(root)):
            entry = os.path.join(root, name)
            if not os.path.isdir(entry) or ".corrupt" in name \
                    or ".tmp." in name:
                continue
            try:
                verify_dir(entry, allow_legacy=False)
                with open(os.path.join(entry, _DECISION)) as f:
                    dec = json.load(f)
                if dec.get("device") != device:
                    # another card's valid decision on a shared root: not
                    # ours to use, and not ours to destroy
                    continue
                decisions[(dec["op"], dec["sig"])] = dec
            except (CorruptStateError, KeyError, TypeError,
                    json.JSONDecodeError, OSError) as exc:
                log.warning("autotune decision %s failed validation (%r); "
                            "quarantining (searched again at its next "
                            "encounter)", entry, exc)
                kernel_stats.record_aot(name, event="quarantine")
                try:
                    quarantine(entry)
                except OSError:
                    pass
        return decisions

    def decisions(self) -> Dict[Tuple[str, str], Dict]:
        with self._lock:
            if self._decisions is None:
                self._decisions = self._load_decisions()
            return self._decisions

    def get_decision(self, op: str, sig_repr: str) -> Optional[Dict]:
        return self.decisions().get((op, sig_repr))

    def record_decision(self, decision: Dict) -> None:
        """Commit one measured decision durably and into the in-memory
        view (tmp -> commit -> ``os.replace``; a store that fails keeps
        the decision in this process only)."""
        from ..robustness.durability import commit_dir

        final = self._decision_dir(
            self._decision_key(decision["op"], decision["sig"]))
        tmp = f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            with open(os.path.join(tmp, _DECISION), "w") as f:
                json.dump(decision, f, indent=1, sort_keys=True)
            commit_dir(tmp)
            if os.path.isdir(final):       # a re-search replaces the old
                shutil.rmtree(final)
            os.replace(tmp, final)
        except OSError as exc:
            shutil.rmtree(tmp, ignore_errors=True)
            if not os.path.isdir(final):
                log.warning("autotune decision store for %s failed (%r); "
                            "kept in this process only",
                            decision.get("op"), exc)
        with self._lock:
            if self._decisions is None:
                self._decisions = self._load_decisions()
            self._decisions[(decision["op"], decision["sig"])] = decision


# ---------------------------------------------------------------------------
# the process-wide active cache (config-resolved, test-overridable)
# ---------------------------------------------------------------------------

_ACTIVE: list = []          # [] = unresolved; [None] = resolved, disabled
_ACTIVE_LOCK = threading.Lock()


def active_cache() -> Optional[ExecutableCache]:
    """The process's configured cache, resolved once from
    ``FrameworkConfig.aot_cache_path`` (env
    ``FLINK_ML_TPU_AOT_CACHE_PATH``); None when no root is configured.
    Without one the libraries still build through an
    :class:`ExecutableCache`, rooted at ``kernels/build/``
    (``build.library_cache``), and autotuning is off."""
    if not _ACTIVE:
        with _ACTIVE_LOCK:
            if not _ACTIVE:
                from ..utils.config import get_config

                path = get_config().aot_cache_path
                _ACTIVE.append(ExecutableCache(path) if path else None)
    return _ACTIVE[0]


def set_cache(cache: Optional[ExecutableCache]) -> None:
    """Pin (or disable, with None) the process cache."""
    with _ACTIVE_LOCK:
        _ACTIVE.clear()
        _ACTIVE.append(cache)


def reset_cache() -> None:
    """Forget the resolution, so the next :func:`active_cache` reads the
    config again."""
    with _ACTIVE_LOCK:
        _ACTIVE.clear()


def aot_jit(fun: Optional[Callable] = None, *, static_argnames=(),
            donate_argnums=()):
    """The JAX package's persistent-executable ``jit`` decorator, kept by
    name: there is no program to compile in eager torch, so it returns a
    wrapper that calls ``fun`` straight through (``__wrapped__`` is
    ``fun``); ``static_argnames`` and ``donate_argnums`` are accepted and
    ignored."""
    def wrap(f: Callable) -> Callable:
        @functools.wraps(f)
        def call(*args, **kwargs):
            return f(*args, **kwargs)

        return call

    return wrap if fun is None else wrap(fun)
