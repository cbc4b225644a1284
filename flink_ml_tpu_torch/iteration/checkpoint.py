"""Mid-training checkpoint/resume of iteration state.

The reference achieves exactly-once over a cyclic graph with coordinator/
barrier alignment plus a feedback-records-in-flight log (§3.4,
``checkpoint/Checkpoints.java:43-211``).  Here an epoch boundary is a
consistent cut by construction, so a checkpoint is simply

    (epoch counter, state tree, optional data-source cursor)

written atomically between epochs.  Exactly-once becomes deterministic
replay: state + epoch + cursor fully determine the rest of training.

Durability is validated: every checkpoint directory carries a per-file
CRC32 manifest and an atomic commit marker (``robustness/durability.py``:
write payload -> manifest -> marker -> rename), so a torn write, a bit
flip or a crash mid-save is *detected* at restore time.
``CheckpointManager.latest()`` scans newest->oldest, quarantines invalid
cuts (``<dir>.corrupt``) and returns the newest VALID one.

A port of the JAX package's ``iteration/checkpoint.py`` with the same
on-disk layout (``leaves.npz`` + ``structure.json`` under the commit
protocol): tensors go to host numpy (one blocking copy each), restored
leaves come back as numpy, and a namedtuple class recorded by the JAX
package (``flink_ml_tpu.<module>.<Class>``) resolves to the port's
counterpart, so a cut written by either package restores in the other.

In a process group of several ranks (``group=``, default the whole group)
a save is the JAX package's multi-host one: rank 0 of the group writes and
a barrier of the group makes the cut visible to every rank before any goes
on (the directory must be one that every rank sees).  A restore in a group
lets rank 0 scan (and quarantine) first.  The fleet metadata of elastic
cuts (:func:`mesh_shape_meta`, :func:`require_fleet_compat`) is the JAX
package's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.trace import tracer
from ..robustness.durability import (
    CorruptStateError,
    commit_dir,
    quarantine,
    verify_dir,
)
from ..utils.persist import port_class_name

__all__ = ["save_pytree", "load_pytree", "CheckpointManager",
           "CheckpointConfig", "host_copy", "mesh_shape_meta", "THIS_RANK",
           "require_fleet_compat"]


def mesh_shape_meta(mesh, participant_count: Optional[int] = None
                    ) -> Dict[str, Any]:
    """The fleet-identity metadata every elastic-aware cut carries: the
    writing mesh's axis sizes plus the reduction participant count.  A
    restore onto a different fleet consults it to know what it is
    re-sharding from (:func:`require_fleet_compat`); a cut without it can
    only restore onto a fleet of the original shape."""
    meta: Dict[str, Any] = {
        "mesh_shape": {str(a): int(mesh.shape[a]) for a in mesh.axis_names}}
    if participant_count is not None:
        meta["participant_count"] = int(participant_count)
    return meta


def require_fleet_compat(meta: Dict[str, Any], *, saved_participants: int,
                         current_participants: int, path: str = "") -> None:
    """Gate a cross-fleet restore on the cut carrying mesh-shape metadata:
    a cut may restore onto a fleet of another size only when it records
    the fleet that wrote it (``mesh_shape`` / ``participant_count``, which
    the elastic-aware fits attach).  A legacy cut restored onto a
    different fleet raises a :class:`CorruptStateError` naming the fix,
    never a silent wrong-shape restore."""
    if saved_participants == current_participants:
        return
    if meta.get("mesh_shape") is None \
            and meta.get("participant_count") is None:
        where = f" at {path}" if path else ""
        raise CorruptStateError(
            f"checkpoint{where} holds reducer state for "
            f"{saved_participants} participant(s) but is being restored "
            f"onto a fleet of {current_participants}, and the cut "
            "predates mesh-shape metadata (no 'mesh_shape'/"
            "'participant_count' in its manifest) — refusing the "
            "wrong-shape restore; restore onto a fleet of the original "
            "size, or re-cut the checkpoint with an elastic-aware fit")


_LEAF = "__leaf__"


def _encode_key(key: Any) -> Any:
    """Dict keys keep their python type through JSON (json.dump would
    silently stringify int/bool keys, corrupting the tree structure)."""
    if isinstance(key, str):
        return key
    if isinstance(key, bool):
        return {"__bool__": key}
    if isinstance(key, int):
        return {"__int__": key}
    if isinstance(key, float):
        return {"__float__": key}
    raise TypeError(f"Unsupported dict key type in checkpoint state: {key!r}")


def _decode_key(node: Any) -> Any:
    if isinstance(node, str):
        return node
    for tag in ("__bool__", "__int__", "__float__"):
        if tag in node:
            return node[tag]
    raise ValueError(f"Corrupt checkpoint key: {node!r}")


def _host_leaf(x: Any) -> Any:
    """A tensor leaf as host numpy (one blocking copy); anything else as
    is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _encode_structure(tree: Any, leaves: List[np.ndarray]) -> Any:
    """JSON-able structure skeleton with leaf placeholders: dict / list /
    tuple / namedtuple / None containers plus the iteration runtime's
    :class:`~.body.Workset` (a workset iteration's hosted carry is
    ``(state, Workset)``)."""
    from .body import Workset

    if tree is None:
        return None
    if isinstance(tree, Workset):
        return {"__workset__": [_encode_structure(tree.mask, leaves),
                                _encode_structure(tree.bounds, leaves)]}
    if isinstance(tree, dict):
        return {"__dict__": [[_encode_key(k), _encode_structure(v, leaves)]
                             for k, v in tree.items()]}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        return {"__namedtuple__": f"{cls.__module__}.{cls.__qualname__}",
                "fields": [[f, _encode_structure(v, leaves)]
                           for f, v in zip(tree._fields, tree)]}
    if isinstance(tree, tuple):
        return {"__tuple__": [_encode_structure(v, leaves) for v in tree]}
    if isinstance(tree, list):
        return {"__list__": [_encode_structure(v, leaves) for v in tree]}
    idx = len(leaves)
    leaves.append(np.asarray(_host_leaf(tree)))
    # only Python scalars restore as scalars: numpy scalars and 0-d
    # tensors come back as 0-d arrays, as the JAX package writes them
    return {_LEAF: idx, "__scalar__": np.ndim(tree) == 0
            and not isinstance(tree, (np.ndarray, np.generic,
                                      torch.Tensor))}


def _resolve_namedtuple(qualified: str):
    """The namedtuple class a skeleton names; a JAX package class path
    maps to the port's counterpart first (``utils.persist``'s rule)."""
    import importlib

    module_name, _, qualname = port_class_name(qualified).rpartition(".")
    obj: Any = importlib.import_module(module_name)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _decode_structure(node: Any, leaves: Dict[int, np.ndarray]) -> Any:
    from .body import Workset

    if node is None:
        return None
    if "__workset__" in node:
        mask_node, bounds_node = node["__workset__"]
        return Workset(_decode_structure(mask_node, leaves),
                       _decode_structure(bounds_node, leaves))
    if "__dict__" in node:
        return {_decode_key(k): _decode_structure(v, leaves)
                for k, v in node["__dict__"]}
    if "__namedtuple__" in node:
        values = {f: _decode_structure(v, leaves) for f, v in node["fields"]}
        cls = _resolve_namedtuple(node["__namedtuple__"])
        return cls(**values)
    if "__tuple__" in node:
        return tuple(_decode_structure(v, leaves) for v in node["__tuple__"])
    if "__list__" in node:
        return [_decode_structure(v, leaves) for v in node["__list__"]]
    leaf = leaves[node[_LEAF]]
    if node.get("__scalar__"):
        return leaf.item()
    return leaf


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor leaf copied to host numpy (the copy an
    async save takes before it returns, so the training loop may go on
    writing the device tensors)."""
    from .body import Workset

    if isinstance(tree, Workset):
        return Workset(host_copy(tree.mask), host_copy(tree.bounds))
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_copy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        # a copy also for a CPU tensor (its .numpy() would share memory)
        return tree.detach().to("cpu", copy=True).numpy()
    return tree


def _save_group(group) -> Tuple[bool, Any]:
    """``(coordinated, group)``: whether a save or restore coordinates
    ranks, and over which group (None: the whole process group, which it
    does where that has several ranks; ``THIS_RANK``: never)."""
    dist = torch.distributed
    if group is THIS_RANK:
        return False, None
    if group is None:
        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1), None
    return dist.get_world_size(group) > 1, group


def _is_writer(coordinated: bool, group) -> bool:
    return not coordinated or torch.distributed.get_rank(group) == 0


def save_pytree(path: str, tree: Any,
                meta: Optional[Dict[str, Any]] = None, *,
                group: Any = None) -> None:
    """Atomically persist a state tree: arrays into one npz, structure +
    metadata into a JSON sidecar.  Tensor leaves are copied to the host
    first (one blocking copy each; callers wanting async snapshots pass
    :func:`host_copy` of the state).  In a process group of several ranks
    (``group``, default the whole group) only its rank 0 writes, and a
    barrier of the group makes the cut visible before any rank returns
    (every rank of the group must call it, with the same tree)."""
    coordinated, group = _save_group(group)
    if not _is_writer(coordinated, group):
        torch.distributed.barrier(group=group)
        return
    leaves: List[np.ndarray] = []
    skeleton = _encode_structure(tree, leaves)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    with open(os.path.join(tmp, "structure.json"), "w") as f:
        json.dump({"skeleton": skeleton, "meta": meta or {}}, f)
    # commit protocol: CRC manifest -> (fault seam) -> COMMITTED marker,
    # all BEFORE the rename publishes the directory.  An injected crash
    # here leaves an uncommitted tmp (never trusted); an injected
    # torn/flip fault leaves a committed-but-invalid checkpoint that
    # verify_dir catches at restore.
    commit_dir(tmp, fault_scope="checkpoint.write")
    if os.path.exists(path):
        # keep a valid copy at every instant: demote the old checkpoint to
        # .old, promote tmp, then drop .old; load_pytree falls back to .old
        old = path + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old)
    else:
        os.replace(tmp, path)
    if coordinated:
        torch.distributed.barrier(group=group)


def load_pytree(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Validate (manifest CRCs + commit marker — legacy pre-manifest
    saves pass through) then decode.  Leaves come back as host numpy.
    Decode-time corruption surfaces as a
    :class:`~..robustness.durability.CorruptStateError` naming the path,
    never as silently wrong state."""
    if not os.path.exists(os.path.join(path, "structure.json")) \
            and os.path.exists(os.path.join(path + ".old", "structure.json")):
        path = path + ".old"  # crashed mid-overwrite; previous copy is valid
    verify_dir(path)
    try:
        with open(os.path.join(path, "structure.json")) as f:
            doc = json.load(f)
        with np.load(os.path.join(path, "leaves.npz")) as data:
            leaves = {int(k.split("_", 1)[1]): data[k] for k in data.files}
        return _decode_structure(doc["skeleton"], leaves), doc.get("meta", {})
    except (json.JSONDecodeError, zipfile.BadZipFile, KeyError, EOFError,
            ValueError, FileNotFoundError) as exc:
        raise CorruptStateError(
            f"checkpoint at {path} failed to decode ({exc!r}); the save "
            "is truncated or corrupted — restore from an earlier "
            "checkpoint") from exc


#: ``group=THIS_RANK``: this rank reads and writes alone, with no barrier,
#: whatever process group exists (a fit of one rank's own; the manager's
#: writer, which coordinates its group itself).
THIS_RANK = object()


class CheckpointConfig:
    def __init__(self, directory: str, interval: int = 1, max_to_keep: int = 2,
                 async_save: bool = False):
        if interval <= 0:
            raise ValueError("checkpoint interval must be positive")
        self.directory = directory
        self.interval = interval
        self.max_to_keep = max_to_keep
        # overlap the disk write with the next epochs' compute (the state
        # is copied to the host before the save returns)
        self.async_save = async_save


class CheckpointManager:
    """Epoch-granular checkpoint store: ``{dir}/ckpt-{epoch:08d}/``.

    The write is atomic (tmp dir + rename), so a crash mid-write leaves the
    previous checkpoint intact — the analog of the reference aborting a
    pending ``Checkpoints`` log on failure (``Checkpoints.java:179-211``)."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        os.makedirs(config.directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        #: set by :meth:`latest` — the supervisor reads these for the time
        #: to recover (detect -> restore complete)
        self.last_restore_at: Optional[float] = None
        self.last_restored_step: Optional[int] = None
        #: timestamp source for ``last_restore_at``; resilient_fit
        #: overwrites it with ITS clock so the two never mix clock domains
        self.clock: Callable[[], float] = time.perf_counter

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.config.directory, f"ckpt-{epoch:08d}")

    def list_epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.config.directory):
            if name.startswith("ckpt-") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def should_save(self, epoch: int) -> bool:
        return epoch % self.config.interval == 0

    def save(self, epoch: int, state: Any,
             extra: Optional[Dict[str, Any]] = None, *,
             group: Any = None) -> str:
        """Write the cut of ``epoch`` (in a group: its rank 0 writes and
        collects old cuts, :func:`save_pytree`)."""
        path = self._ckpt_path(epoch)
        meta = {"epoch": epoch}
        if extra:
            meta.update(extra)
        # the cut's slot key IS the trainer's global step for streaming
        # fits: the `step` correlation id
        coordinated, group = _save_group(group)
        if _is_writer(coordinated, group):
            # the writer collects old cuts before the barrier releases
            # the others
            with tracer.span("checkpoint_write", cat="train",
                             step=int(epoch)):
                save_pytree(path, state, meta, group=THIS_RANK)
            self._gc()
        if coordinated:
            torch.distributed.barrier(group=group)
        return path

    def save_async(self, epoch: int, state: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy ``state`` to the host now (one blocking copy), then write
        it on a background thread.  At most one save is in flight."""
        self.wait()
        host_state = host_copy(state)

        def work():
            try:
                self.save(epoch, host_state, extra)
            except BaseException as e:  # surfaced on next wait()
                self._pending_error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Block until the in-flight async save (if any) lands; re-raise its
        error.  Called before restore and at iteration end."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._pending_error is not None:
            error, self._pending_error = self._pending_error, None
            raise error

    def latest(self, *, group: Any = None
               ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        """The newest VALID checkpoint, scanning newest->oldest.  A cut
        that fails validation/decoding (torn write, bit flip, crash
        mid-commit) is quarantined (``<dir>.corrupt`` — kept for
        forensics, invisible to future scans) and the scan falls back to
        the previous one; only when NO valid checkpoint exists does this
        return None.  With ``group`` (a process group of several ranks,
        every rank calling) its rank 0 scans and quarantines first, a
        barrier, then the others read what it left."""
        self.wait()
        coordinated, group = _save_group(THIS_RANK if group is None
                                         else group)
        writer = _is_writer(coordinated, group)
        if not writer:
            torch.distributed.barrier(group=group)
        found = None
        for epoch in reversed(self.list_epochs()):
            path = self._ckpt_path(epoch)
            try:
                state, meta = load_pytree(path)
            except CorruptStateError:
                if writer:
                    quarantine(path)
                continue
            self.last_restore_at = self.clock()
            self.last_restored_step = int(meta["epoch"])
            found = int(meta["epoch"]), state, meta
            break
        if writer and coordinated:
            torch.distributed.barrier(group=group)
        return found

    def restore_latest(self, *, group: Any = None
                       ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        return self.latest(group=group)

    def _gc(self) -> None:
        keep = self.config.max_to_keep
        if keep <= 0:
            return
        for epoch in self.list_epochs()[:-keep]:
            shutil.rmtree(self._ckpt_path(epoch), ignore_errors=True)
