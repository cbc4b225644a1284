"""Registry autotuning: measured backend choices, persisted.

``registry.lookup`` picks among the entries that qualify by static
priority, a guess about the machine the process stands on.  This module
replaces the guess with a measurement, once per fleet:

- :func:`choose` times every candidate (one untimed warm-up call, then
  the best of ``repeats`` averages over ``iters`` calls, each fenced with
  ``torch.cuda.synchronize`` where the outputs are on the card), picks
  the fastest, and commits the decision to the cache root
  (``kernels/aot.py``, ``autotune/`` subdir, the libraries' durability
  contract).
- A recorded decision is honoured with no search by every later call in
  this process and by every later process pointed at the root:
  ``registry.lookup`` consults :func:`decided_backend` when several
  backends qualify.
- Decisions are keyed by ``(op, sig)`` and the card's name: a decision
  measured on one card never applies on another, and a decision recorded
  for another card is skipped (not quarantined: its owner still reads
  it).  A damaged decision is quarantined and searched again.
- With no cache root configured nothing is searched and every pick is
  the static priority's.

The port tunes one choice: GBT's histogram form
(``models/common/gbt.py::_maybe_autotune_hist``).  The KMeans kernels'
tiles are fixed in their sources, so the JAX package's measured block
pickers have nothing to tune here (``ops/kmeans.py``).

Accounting rides :data:`~flink_ml_tpu_torch.kernels.registry.kernel_stats`
(``tuned_ops``): what was tuned, what won, whether the decision was
measured or loaded, and what the search cost.
"""

from __future__ import annotations

import time

from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "choose",
    "decided_backend",
    "decided_choice",
    "enabled",
    "measure",
]


def enabled() -> bool:
    """True when a cache root is configured: a search with nowhere to
    persist its winner would be paid again by every process."""
    from .aot import active_cache

    return active_cache() is not None


def _sig_repr(sig: tuple) -> str:
    return repr(tuple(sig))


def get_decision(op: str, sig: tuple = ()) -> Optional[Dict]:
    """The recorded decision for ``(op, sig)`` on this card, or None
    (disabled, never measured, or measured on another card)."""
    from .aot import active_cache

    cache = active_cache()
    if cache is None:
        return None
    return cache.get_decision(op, _sig_repr(sig))


def decided_backend(op: str, sig: tuple = ()) -> Optional[str]:
    """The measured-best BACKEND for ``(op, sig)``: what
    ``registry.lookup`` consults when several entries qualify."""
    dec = get_decision(op, sig)
    if dec is not None and dec.get("kind") == "backend":
        return dec["choice"]
    return None


def decided_choice(op: str, sig: tuple = ()) -> Optional[str]:
    """The measured-best choice token of any kind."""
    dec = get_decision(op, sig)
    return dec["choice"] if dec is not None else None


def _fence(out) -> None:
    """Wait for the card where ``out`` (a tensor, or tensors nested in
    tuples, lists and dicts) lives on it; nothing on the CPU."""
    import torch

    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _fence(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _fence(v)


def measure(candidates: Dict[str, Callable[[], object]], *,
            iters: int = 3, repeats: int = 2) -> Dict[str, float]:
    """Wall-time each candidate thunk: one untimed warm-up call (library
    loads and first-use costs stay out of the ranking), then the best of
    ``repeats`` averages over ``iters`` fenced calls.  Returns
    ``{name: best_ms_per_call}``."""
    timings: Dict[str, float] = {}
    for name, thunk in candidates.items():
        _fence(thunk())
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = thunk()
            _fence(out)
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        timings[name] = best * 1e3
    return timings


def choose(op: str, sig: tuple,
           candidates: Dict[str, Callable[[], object]], *,
           kind: str = "backend", iters: int = 3, repeats: int = 2,
           probe: str = "") -> Tuple[str, Dict]:
    """Resolve ``(op, sig)`` to the measured-best candidate name.

    A recorded decision whose choice is still among ``candidates`` is
    returned with nothing run (source ``"cache"``, ``search_ms`` 0).
    Otherwise every candidate is measured (source ``"measured"``), the
    winner is persisted where a cache root is configured, and
    ``kernel_stats.tuned_ops`` records the decision either way.
    ``probe`` says what the thunks ran, so a reader of the decision can
    judge how far it carries."""
    from .aot import active_cache
    from .registry import kernel_stats

    cache = active_cache()
    dec = cache.get_decision(op, _sig_repr(sig)) if cache else None
    if dec is not None and dec.get("choice") in candidates:
        kernel_stats.record_autotune(op, sig, dec["choice"],
                                     kind=dec.get("kind", kind),
                                     source="cache", search_ms=0.0,
                                     timings=dec.get("timings_ms", {}))
        return dec["choice"], dec
    t0 = time.perf_counter()
    timings = measure(candidates, iters=iters, repeats=repeats)
    search_ms = (time.perf_counter() - t0) * 1e3
    choice = min(timings, key=timings.get)
    decision = {
        "format": 1,
        "op": op,
        "sig": _sig_repr(sig),
        "kind": kind,
        "choice": choice,
        "timings_ms": {k: round(v, 4) for k, v in timings.items()},
        "search_ms": round(search_ms, 2),
        "probe": probe,
        "device": cache._device() if cache else None,
    }
    if cache is not None:
        cache.record_decision(decision)
    kernel_stats.record_autotune(op, sig, choice, kind=kind,
                                 source="measured", search_ms=search_ms,
                                 timings=decision["timings_ms"])
    return choice, decision
