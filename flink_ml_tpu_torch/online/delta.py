"""Param-delta codec: the unit the train->serve publish protocol ships.

A port of the JAX package's ``online/delta.py``: the codec is host numpy
and byte for byte the JAX package's (the same keys, payloads and CRCs for
the same trees); only the tree walk is the port's own, in place of
``jax.tree_util``.

Successive generations of a continuously trained model are same-shape
param trees that differ in a (often small) subset of slots, so the
publish path ships a **delta**: per leaf, the changed element indices and
their NEW raw values.  Carrying raw new values (not arithmetic
differences) makes the codec **bit-exact by construction**:
``apply_delta(base, diff_params(base, new)) == new`` bitwise, including
NaN payloads and signed zeros — an f32 ``base + (new - base)`` would
re-round and break the served-bits == trained-bits contract.

Every update carries CRC32 digests of the base and result trees.
``apply_delta`` verifies BOTH: the base digest catches a delta applied
to the wrong generation (the consumer's copy drifted — e.g. a full
update was lost), the result digest catches a torn/corrupted payload.
Together they are the publish protocol's exactly-once teeth: a replayed
delta either reproduces the identical tree (digest no-op) or fails
loudly; it can never half-apply (application happens on a copy, swapped
in only after verification).

Change detection compares **raw bytes**, not values: ``NaN != NaN``
would mark every NaN slot changed forever, and ``-0.0 == 0.0`` would
miss a real bit flip.

**The tree walk.**  Dict keys in sorted order, list and tuple entries by
index, ``None`` an empty subtree, every other object a leaf: torch
tensors through ``.detach().cpu().numpy()``, anything else through
``np.asarray`` (0-d leaves stay 0-d).  A leaf's key is its path joined
with ``"/"`` — the JAX package's keys for the same nested containers.
"""

from __future__ import annotations

import zlib

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["ParamDelta", "FullUpdate", "DeltaShapeChanged",
           "DeltaBaseMismatch", "DeltaCorrupt", "tree_digest",
           "diff_params", "apply_delta", "flatten_params",
           "unflatten_params", "full_update", "SPARSE_DENSITY_THRESHOLD"]


class DeltaShapeChanged(ValueError):
    """Base and new trees differ in structure/shape/dtype — a delta
    cannot express this; the caller must fall back to a full publish
    (the registry load->warm->swap path)."""


class DeltaBaseMismatch(ValueError):
    """The consumer's base tree is not the generation this delta was
    diffed against; applying would produce garbage.  Heal by re-sending
    a full update."""


class DeltaCorrupt(ValueError):
    """Applying the delta did not reproduce the producer's result
    digest: the payload was torn or the codec's bit-exactness contract
    was violated.  Never serve this."""


#: Leaves whose changed fraction is below this encode sparsely
#: ((int64 index, value) pairs, 12 bytes/slot f32); denser leaves ship
#: the full buffer (4 bytes/slot) — the sparse form costs more past a
#: third of the slots, and the margin below that keeps the decision
#: stable for leaves hovering at the boundary.
SPARSE_DENSITY_THRESHOLD = 0.25


# -- tree <-> flat dict ------------------------------------------------------

def _walk(tree: Any, path: Tuple[str, ...],
          out: List[Tuple[Tuple[str, ...], Any]]) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _walk(tree[key], path + (str(key),), out)
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _walk(sub, path + (str(i),), out)
    else:
        out.append((path, tree))


def _leaves(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _walk(tree, (), out)
    return [("/".join(path), leaf) for path, leaf in out]


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_params(tree: Any) -> Dict[str, np.ndarray]:
    """Flatten a params tree (nested dicts/lists/tuples of arrays or
    tensors) to ``{"/"-joined path: contiguous np.ndarray}`` in
    deterministic key order — the codec's canonical form."""
    flat = {}
    for key, leaf in _leaves(tree):
        arr = _host(leaf)
        if not arr.flags["C_CONTIGUOUS"]:
            # NOTE: not ascontiguousarray unconditionally — it promotes
            # 0-d scalars to shape (1,), breaking shape fidelity
            arr = np.ascontiguousarray(arr)
        flat[key] = arr
    return flat


def _rebuild(template: Any, path: Tuple[str, ...],
             flat: Dict[str, np.ndarray]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {key: _rebuild(template[key], path + (str(key),), flat)
                for key in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(sub, path + (str(i),), flat)
                 for i, sub in enumerate(template)]
        return items if isinstance(template, list) else tuple(items)
    return flat["/".join(path)]


def unflatten_params(template: Any, flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild a tree shaped like ``template`` from the codec's flat
    dict (inverse of :func:`flatten_params` for same-structure trees)."""
    keys = [key for key, _ in _leaves(template)]
    missing = [k for k in keys if k not in flat]
    if missing or len(keys) != len(flat):
        raise DeltaShapeChanged(
            f"flat params keys {sorted(flat)} do not match the template's "
            f"{sorted(keys)}")
    return _rebuild(template, (), flat)


# -- digests ----------------------------------------------------------------

def _leaf_digest(arr: np.ndarray) -> int:
    header = f"{arr.dtype.str}:{arr.shape}".encode()
    return zlib.crc32(arr.tobytes(), zlib.crc32(header))


def tree_digest(tree: Any) -> int:
    """CRC32 over every leaf's dtype/shape/raw bytes in canonical path
    order — the generation fingerprint both publish digests use."""
    flat = tree if isinstance(tree, dict) and all(
        isinstance(v, np.ndarray) for v in tree.values()) \
        else flatten_params(tree)
    acc = 0
    for key in sorted(flat):
        acc = zlib.crc32(key.encode(), acc)
        acc = zlib.crc32(_leaf_digest(flat[key]).to_bytes(4, "little"), acc)
    return acc


# -- update payloads ---------------------------------------------------------

@dataclass(frozen=True)
class _LeafDelta:
    """One changed leaf: either the full new buffer (``idx is None``) or
    the changed flat indices + their new raw values."""
    idx: Optional[np.ndarray]     # int64 flat indices, or None = full
    values: np.ndarray            # new raw values (flat when sparse)

    @property
    def payload_bytes(self) -> int:
        n = 0 if self.idx is None else self.idx.size * self.idx.itemsize
        return n + self.values.size * self.values.itemsize


@dataclass(frozen=True)
class ParamDelta:
    """An incremental update: apply to the exact base generation only."""
    step: int                     # producer's train cursor at the cut
    base_digest: int
    new_digest: int
    leaves: Dict[str, _LeafDelta] = field(default_factory=dict)

    @property
    def payload_bytes(self) -> int:
        """Bytes this update would put on a wire (values + sparse
        indices; digests/headers are O(1))."""
        return sum(d.payload_bytes for d in self.leaves.values())

    @property
    def changed_leaves(self) -> List[str]:
        return sorted(self.leaves)


@dataclass(frozen=True)
class FullUpdate:
    """A full re-anchor: replaces the consumer's base outright (first
    publish, shape/schema change, dense delta, periodic re-anchor)."""
    step: int
    new_digest: int
    params: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def payload_bytes(self) -> int:
        return sum(a.size * a.itemsize for a in self.params.values())


def full_update(step: int, new: Any) -> FullUpdate:
    flat = flatten_params(new)
    return FullUpdate(step=step, new_digest=tree_digest(flat), params=flat)


def diff_params(base: Any, new: Any, step: int = 0,
                sparse_threshold: float = SPARSE_DENSITY_THRESHOLD,
                base_digest: Optional[int] = None) -> ParamDelta:
    """Encode ``new`` against ``base``.  Raises :class:`DeltaShapeChanged`
    when the trees differ structurally (different keys, shapes, or
    dtypes) — the caller falls back to a full publish.

    ``base_digest`` lets a caller that already knows the base's digest
    (the encoder: it is exactly the previous publish's ``new_digest``)
    skip the whole-tree re-CRC on the publish latency path."""
    fb, fn = flatten_params(base), flatten_params(new)
    if set(fb) != set(fn):
        raise DeltaShapeChanged(
            f"param tree changed: base leaves {sorted(fb)} vs new "
            f"{sorted(fn)}")
    leaves: Dict[str, _LeafDelta] = {}
    for key in sorted(fn):
        a, b = fb[key], fn[key]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise DeltaShapeChanged(
                f"leaf {key!r} changed shape/dtype: "
                f"{a.dtype}{a.shape} -> {b.dtype}{b.shape}")
        if a.tobytes() == b.tobytes():
            continue
        if b.ndim == 0 or b.size == 0:
            leaves[key] = _LeafDelta(idx=None, values=b.copy())
            continue
        # raw-byte change mask (value compares would miss -0.0 flips and
        # mark NaNs changed forever)
        itemsize = b.dtype.itemsize
        av = a.reshape(-1).view(np.uint8).reshape(a.size, itemsize)
        bv = b.reshape(-1).view(np.uint8).reshape(b.size, itemsize)
        changed = np.nonzero(np.any(av != bv, axis=1))[0]
        if changed.size <= sparse_threshold * b.size:
            leaves[key] = _LeafDelta(idx=changed.astype(np.int64),
                                     values=b.reshape(-1)[changed].copy())
        else:
            leaves[key] = _LeafDelta(idx=None, values=b.copy())
    return ParamDelta(
        step=step,
        base_digest=(base_digest if base_digest is not None
                     else tree_digest(fb)),
        new_digest=tree_digest(fn), leaves=leaves)


def apply_delta(base: Any, delta: ParamDelta) -> Dict[str, np.ndarray]:
    """Apply ``delta`` to ``base``; returns the NEW flat params dict.
    Verifies the base digest before touching anything and the result
    digest before returning — on either failure the consumer's base is
    untouched (application happens on copies)."""
    flat = flatten_params(base)
    have = tree_digest(flat)
    if have != delta.base_digest:
        raise DeltaBaseMismatch(
            f"delta for step {delta.step} was diffed against generation "
            f"digest {delta.base_digest:#010x} but the live base digests "
            f"{have:#010x}; request a full update")
    out: Dict[str, np.ndarray] = {}
    for key, arr in flat.items():
        d = delta.leaves.get(key)
        if d is None:
            out[key] = arr
        elif d.idx is None:
            out[key] = d.values
        else:
            new = arr.copy().reshape(-1)
            new[d.idx] = d.values
            out[key] = new.reshape(arr.shape)
    got = tree_digest(out)
    if got != delta.new_digest:
        raise DeltaCorrupt(
            f"applying delta for step {delta.step} produced digest "
            f"{got:#010x}, producer recorded {delta.new_digest:#010x}: "
            "torn payload — refusing to serve")
    return out
