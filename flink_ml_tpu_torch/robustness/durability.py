"""Validated, crash-consistent directory commits.

The checkpoint/WAL write path was already atomic at the *rename* level
(tmp dir -> ``os.replace``); what it lacked was a way to tell a GOOD
committed directory from a torn or bit-rotted one before trusting its
bytes with training state.  This module supplies the two missing
pieces, shared by ``iteration/checkpoint.py`` (and usable by any
directory-shaped artifact):

1. **Manifest**: ``manifest.json`` maps every payload file to its
   CRC32 (+ size).  Written LAST among the payload, so a manifest that
   validates proves the payload bytes are the ones the writer hashed.
2. **Commit marker**: an empty ``COMMITTED`` file written (and fsynced)
   after the manifest.  The commit protocol is therefore::

       write payload files -> write manifest -> fsync payload
       -> write COMMITTED -> fsync dir -> os.replace(tmp, final)

   A directory without the marker is a crash-interrupted write (never
   valid); a directory whose CRCs mismatch is torn/corrupt.  Either way
   :func:`verify_dir` raises :class:`CorruptStateError` naming the path
   and the first bad file — and :func:`quarantine` moves the directory
   aside (``<name>.corrupt``) so a newest->oldest scan falls back to
   the previous valid artifact instead of crashing on the bad one.

Directories written before manifests existed (``format`` absent) are
**legacy**: :func:`verify_dir` accepts them by default so old
checkpoints keep restoring; their payload errors surface at decode time
instead.

A copy of the JAX package's ``robustness/durability.py`` (host-only), so
a directory committed by either package validates in the other.
"""

from __future__ import annotations

import json
import logging
import os
import zlib

from typing import Dict, Iterable, Optional

from .faults import fault_point

__all__ = ["CorruptStateError", "MANIFEST_NAME", "COMMIT_MARKER",
           "file_crc32", "write_manifest", "write_commit_marker",
           "commit_dir", "is_committed", "verify_dir", "quarantine"]

MANIFEST_NAME = "manifest.json"
COMMIT_MARKER = "COMMITTED"

log = logging.getLogger("flink_ml_tpu_torch.robustness")


class CorruptStateError(IOError):
    """A durable artifact failed validation: partial (uncommitted),
    torn, or bit-rotted.  Subclasses ``IOError`` so existing diagnosable
    error handling (``persist._resolve_saved_class`` lineage) catches it
    uniformly."""


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _payload_files(dirpath: str) -> Iterable[str]:
    for name in sorted(os.listdir(dirpath)):
        if name in (MANIFEST_NAME, COMMIT_MARKER):
            continue
        if os.path.isfile(os.path.join(dirpath, name)):
            yield name


def write_manifest(dirpath: str,
                   files: Optional[Iterable[str]] = None) -> Dict:
    """Hash ``files`` (default: every regular file in ``dirpath``) and
    write ``manifest.json``.  Returns the manifest dict."""
    names = list(files) if files is not None else list(
        _payload_files(dirpath))
    manifest = {"format": 1, "files": {
        name: {"crc32": file_crc32(os.path.join(dirpath, name)),
               "bytes": os.path.getsize(os.path.join(dirpath, name))}
        for name in names}}
    # a torn manifest is SAFE here: the COMMITTED marker is written
    # after it, and verify_dir treats manifest-without-marker as
    # crashed-mid-commit (quarantined) — the marker, not an os.replace,
    # is this protocol's commit point.
    with open(os.path.join(dirpath, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def write_commit_marker(dirpath: str) -> None:
    """The last write of the commit protocol — its presence asserts the
    manifest (and everything it hashes) fully landed."""
    marker = os.path.join(dirpath, COMMIT_MARKER)
    # zero-byte marker: nothing to tear, fsync'd below — atomic by
    # content, no tmp+replace needed.
    with open(marker, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    dirfd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def is_committed(dirpath: str) -> bool:
    return os.path.exists(os.path.join(dirpath, COMMIT_MARKER))


def verify_dir(dirpath: str, *, allow_legacy: bool = True) -> None:
    """Validate the commit protocol for ``dirpath``; raise
    :class:`CorruptStateError` (naming path + first finding) on any
    violation.  Legacy directories (no manifest, no marker) pass when
    ``allow_legacy`` — pre-manifest saves must keep restoring."""
    manifest_path = os.path.join(dirpath, MANIFEST_NAME)
    has_manifest = os.path.exists(manifest_path)
    if not has_manifest and not is_committed(dirpath):
        if allow_legacy:
            return
        raise CorruptStateError(
            f"{dirpath}: no manifest and no commit marker (pre-manifest "
            "legacy save, or not a committed artifact)")
    if has_manifest and not is_committed(dirpath):
        raise CorruptStateError(
            f"{dirpath}: manifest present but no {COMMIT_MARKER} marker — "
            "the writer crashed mid-commit; this artifact was never valid")
    if not has_manifest:
        raise CorruptStateError(
            f"{dirpath}: commit marker present but {MANIFEST_NAME} is "
            "missing — the directory was tampered with or partially lost")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
        entries = manifest["files"]
    except (json.JSONDecodeError, KeyError, TypeError) as exc:
        raise CorruptStateError(
            f"{dirpath}: unreadable {MANIFEST_NAME} ({exc})") from exc
    for name, entry in entries.items():
        path = os.path.join(dirpath, name)
        if not os.path.exists(path):
            raise CorruptStateError(
                f"{dirpath}: manifest lists {name!r} but the file is "
                "missing")
        size = os.path.getsize(path)
        if size != entry["bytes"]:
            raise CorruptStateError(
                f"{dirpath}: {name!r} is {size} bytes, manifest says "
                f"{entry['bytes']} (torn write)")
        crc = file_crc32(path)
        if crc != entry["crc32"]:
            raise CorruptStateError(
                f"{dirpath}: {name!r} CRC32 {crc:#010x} != manifest "
                f"{entry['crc32']:#010x} (corrupted bytes)")


def commit_dir(dirpath: str, *, fault_scope: Optional[str] = None) -> None:
    """Run the tail of the commit protocol on a fully-written payload
    directory: manifest -> (fault injection seam) -> marker.  The fault
    seam sits BETWEEN hashing and the marker so an injected torn/flip
    fault produces exactly the committed-but-invalid artifact the
    validation layer exists to catch."""
    write_manifest(dirpath)
    if fault_scope is not None:
        # data faults damage the largest payload file (the one a real
        # torn write would statistically hit)
        target = max(_payload_files(dirpath),
                     key=lambda n: os.path.getsize(
                         os.path.join(dirpath, n)),
                     default=None)
        fault_point(fault_scope,
                    os.path.join(dirpath, target) if target else None)
    write_commit_marker(dirpath)


def quarantine(dirpath: str) -> str:
    """Move a failed-validation directory aside (``<name>.corrupt``,
    numbered on collision) so directory scans stop tripping on it while
    the bytes stay available for forensics.  Returns the new path."""
    base = dirpath.rstrip(os.sep) + ".corrupt"
    dest = base
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{base}{n}"
    os.rename(dirpath, dest)
    log.warning("quarantined corrupt artifact %s -> %s", dirpath, dest)
    return dest
