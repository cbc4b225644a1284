"""Fault injection and self-healing training (a port of the JAX package's
``robustness`` package).

- :mod:`.faults` — a seedable, deterministic :class:`FaultPlan` that
  injects transient read errors, torn/corrupted writes, ENOSPC and
  simulated crashes at chosen invocation indices of named scopes (same
  seed, same faults: every recovery test is reproducible);
- :mod:`.durability` — per-file CRC32 manifests + an atomic commit
  marker for checkpoint directories, so a torn or bit-flipped save is
  *detected* instead of silently restored;
- :mod:`.retry` — exponential-backoff :class:`RetryPolicy` with
  retryable-vs-fatal classification (deterministic schedule under an
  injected clock), adopted by the prefetch source pulls;
- :mod:`.supervisor` — :func:`resilient_fit`, the self-healing supervisor:
  on a recoverable failure it restores from the newest *valid*
  checkpoint (corrupt ones are quarantined), replays the source past the
  cursor and continues, bit for bit the uninterrupted run.

Everything here is host-only; the first three modules are copies of the
JAX package's.
"""


from .faults import (
    FaultPlan,
    InjectedChipDown,
    InjectedChipFlap,
    InjectedCrash,
    InjectedDiskFullError,
    InjectedJoin,
    InjectedPreemption,
    InjectedTransientError,
    corrupt_file,
    fault_point,
)
from .durability import (
    COMMIT_MARKER,
    MANIFEST_NAME,
    CorruptStateError,
    commit_dir,
    is_committed,
    quarantine,
    verify_dir,
    write_commit_marker,
    write_manifest,
)
from .retry import RetryPolicy, default_classify, retry_call
from .supervisor import RecoveryEvent, RecoveryReport, resilient_fit

__all__ = [
    "FaultPlan", "InjectedChipDown", "InjectedChipFlap",
    "InjectedCrash", "InjectedDiskFullError",
    "InjectedJoin", "InjectedPreemption",
    "InjectedTransientError", "corrupt_file", "fault_point",
    "COMMIT_MARKER", "MANIFEST_NAME", "CorruptStateError", "commit_dir",
    "is_committed",
    "quarantine", "verify_dir", "write_commit_marker", "write_manifest",
    "RetryPolicy", "default_classify", "retry_call",
    "RecoveryEvent", "RecoveryReport", "resilient_fit",
]
