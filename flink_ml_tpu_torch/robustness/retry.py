"""Retry with classified exponential backoff.

The reference rides Flink's restart strategies (fixed-delay /
failure-rate) for transient task failures; this stack needs
the same distinction at its I/O seams: a flaky NFS read or a brief
relay drop should cost one backoff sleep, while a corrupt checkpoint or
a schema error must fail fast so the *recovery* layer (restore +
replay, :mod:`.supervisor`) — not a blind retry loop — handles it.

Classification contract (:func:`default_classify`):

| class | examples | retried? |
|---|---|---|
| deadline exceeded | :class:`DeadlineExceededError`, any exc with ``deadline_exceeded = True`` | **no** |
| marked transient | :class:`~.faults.InjectedTransientError`, any exc with ``transient = True`` | yes |
| connection/timeout | ``ConnectionError``, ``TimeoutError`` | yes |
| transient errnos | ``EAGAIN``/``EINTR``/``EIO``/``EBUSY``/``ETIMEDOUT``/``ECONNRESET`` | yes |
| everything else | ``ENOSPC``, corrupt state, ``ValueError``, crashes | no |

Deadline-exceeded outranks the timeout rule on purpose: a
hedged or requeued serving request that is already past its SLO
deadline must SHED — the answer is worthless to the caller now, and a
retry would burn survivor capacity exactly when a failover has made
capacity scarce.  :class:`DeadlineExceededError` subclasses
``TimeoutError`` so generic timeout handlers still catch it, but the
``deadline_exceeded`` marker is checked FIRST so no retry loop ever
resurrects it.

The backoff schedule is pure arithmetic over the attempt index
(``base * multiplier**i`` capped at ``max_delay`` — no RNG, no wall
clock), and ``sleep`` is injectable, so tests assert the exact schedule
under a fake clock.

A copy of the JAX package's ``robustness/retry.py`` (host-only): the same
policy gives the same backoff schedule in both packages.
"""

from __future__ import annotations

import errno
import time

from dataclasses import dataclass, field
from typing import Any, Callable, List

__all__ = ["DeadlineExceededError", "RetryPolicy", "RetryingIterator",
           "StreamRetryUnsupported", "default_classify", "retry_call",
           "TRANSIENT_ERRNOS"]

#: errno values worth one more try: the OS said "later", not "never".
TRANSIENT_ERRNOS = frozenset({
    errno.EAGAIN, errno.EINTR, errno.EIO, errno.EBUSY,
    errno.ETIMEDOUT, errno.ECONNRESET,
})


class DeadlineExceededError(TimeoutError):
    """A request blew past its SLO deadline (hedged/requeued serving
    traffic after a failover is the canonical producer).  Fatal, not
    retryable: the ``deadline_exceeded`` marker is classified BEFORE
    the generic-``TimeoutError``-is-retryable rule, because retrying an
    already-worthless answer burns survivor capacity exactly when a
    chip loss has made it scarce — the request must shed instead."""

    deadline_exceeded = True


def default_classify(exc: BaseException) -> bool:
    """True = retryable.  See the module-doc table."""
    if getattr(exc, "deadline_exceeded", False):
        # checked before everything: DeadlineExceededError IS a
        # TimeoutError, and the marker must outrank that retryable rule
        return False
    if getattr(exc, "transient", False):
        return True
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    if isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS:
        return True
    return False


@dataclass
class RetryPolicy:
    """Exponential backoff over classified errors.

    ``call(fn, *args)`` runs ``fn`` up to ``max_attempts`` times,
    sleeping ``delay(i)`` after retryable failure ``i``; a non-retryable
    error (or exhaustion) re-raises the underlying exception unchanged,
    so callers' except clauses keep seeing the real failure type.
    ``attempts``/``slept`` record the policy's lifetime totals (the
    observability hook prefetch stats and tests read)."""

    max_attempts: int = 4
    base_delay: float = 0.05
    multiplier: float = 2.0
    max_delay: float = 2.0
    classify: Callable[[BaseException], bool] = default_classify
    sleep: Callable[[float], None] = time.sleep
    attempts: int = 0
    retries: int = 0
    slept: List[float] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay < 0 or self.max_delay < 0:
            raise ValueError("delays must be non-negative")

    def delay(self, attempt: int) -> float:
        """Backoff after failed attempt ``attempt`` (0-based) — pure
        arithmetic, deterministic under test."""
        return min(self.base_delay * self.multiplier ** attempt,
                   self.max_delay)

    def call(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        for attempt in range(self.max_attempts):
            self.attempts += 1
            try:
                return fn(*args, **kwargs)
            except Exception as exc:  # noqa: BLE001 — classified below
                last = attempt == self.max_attempts - 1
                if last or not self.classify(exc):
                    raise
                self.retries += 1
                pause = self.delay(attempt)
                self.slept.append(pause)
                self.sleep(pause)
        raise AssertionError("unreachable")  # pragma: no cover


def retry_call(fn: Callable, *args: Any,
               policy: RetryPolicy = None, **kwargs: Any) -> Any:
    """Functional convenience: ``retry_call(f, x, policy=p)``."""
    return (policy or RetryPolicy()).call(fn, *args, **kwargs)


class StreamRetryUnsupported(RuntimeError):
    """A transient pull failure killed a bare-generator source, which
    cannot be re-iterated: the retried pull would read ``StopIteration``
    off the dead frame and silently truncate the stream — this loud
    error (deliberately NOT classified retryable) is the safe outcome.
    Wrap the raw object-shaped reader instead of a generator over it."""


class RetryingIterator:
    """Reader/iterator proxy whose pulls retry classified-transient
    errors under ``policy``.

    MUST wrap the RAW source, below any generator adapters — a generator
    that lets an exception propagate is dead forever.  Two recovery
    modes, chosen per failure:

    - the current iterator is a plain object iterator (``FaultySource``,
      any class with ``__next__``): it survived the raise, so the retry
      pulls the SAME iterator again;
    - the current iterator is a GENERATOR (e.g. the one
      ``DataCacheReader.__iter__`` returns): its frame is dead, so the
      retry re-iterates the inner object — cursor-backed readers resume
      exactly at the failed batch, because their cursor lives on the
      READER and only advances on a successful pull.  If the inner
      object IS the dead generator (a bare genexpr was wrapped), there
      is nothing to rebuild from and the pull fails loudly with
      :class:`StreamRetryUnsupported` — never a silent truncation.

    Non-iteration attributes (``seek``/``batch_rows``/``block_order``/
    ``epoch_varying``/...) delegate to the inner object, so the cursor
    and shuffle protocols the streaming fits probe for survive the wrap
    (direct protocol calls like ``read_batch()`` are NOT retried — only
    the iteration path is).
    """

    def __init__(self, inner: Any, policy: RetryPolicy):
        self._inner = inner
        self._policy = policy
        self._it = None

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def __iter__(self) -> "RetryingIterator":
        self._it = iter(self._inner)
        return self

    def _pull_once(self) -> Any:
        import types

        if self._it is None:
            self._it = iter(self._inner)
        try:
            return next(self._it)
        except StopIteration:
            raise
        except Exception as exc:
            if isinstance(self._it, types.GeneratorType):
                rebuilt = iter(self._inner)
                if rebuilt is self._it:
                    raise StreamRetryUnsupported(
                        "transient error inside a bare generator source "
                        f"({exc!r}); a generator cannot be re-iterated "
                        "after an exception — wrap the underlying "
                        "reader object, not a generator over it") from exc
                self._it = rebuilt
            raise

    def __next__(self) -> Any:
        return self._policy.call(self._pull_once)
