"""Stage persistence: directory layout + reflective load.

Re-design of ``util/ReadWriteUtils.java``.  The on-disk convention is kept
compatible in spirit with the reference (``ReadWriteUtils.java:112-223``):

    {path}/metadata        JSON: {className, timestamp, paramMap, extra...}
    {path}/data/           model data files (.npz instead of Kryo streams)
    {path}/stages/NN       pipeline children, zero-padded directory names

``load_stage`` resolves the saved class name with importlib and dispatches to
the class's ``load`` classmethod (the analog of the reflective static-load in
``ReadWriteUtils.java:294-314``).

A copy of the JAX package's ``utils/persist.py`` with one change: a class
path recorded by the JAX package (``flink_ml_tpu.<module>.<Class>``) maps
to the port's counterpart (``flink_ml_tpu_torch.<module>.<Class>``) before
anything is imported, so a directory saved by either package loads here
without importing JAX.  (The JAX copy's fault-injection hook is not
ported.)
"""

from __future__ import annotations

import importlib
import json
import os
import time
import zipfile

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "save_metadata",
    "load_metadata",
    "save_pipeline",
    "load_pipeline",
    "load_stage",
    "load_stage_param",
    "get_data_path",
    "save_model_arrays",
    "load_model_arrays",
    "port_class_name",
]


_JAX_PACKAGE = "flink_ml_tpu."
_PORT_PACKAGE = "flink_ml_tpu_torch."


def _class_name(obj_or_cls: Any) -> str:
    cls = obj_or_cls if isinstance(obj_or_cls, type) else type(obj_or_cls)
    return f"{cls.__module__}.{cls.__qualname__}"


def port_class_name(class_name: str) -> str:
    """The port's class path for a recorded ``className``: the JAX
    package's exact ``flink_ml_tpu.`` prefix becomes
    ``flink_ml_tpu_torch.``; any other path is returned unchanged."""
    if class_name.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + class_name[len(_JAX_PACKAGE):]
    return class_name


def _resolve_class(class_name: str) -> type:
    module_name, _, qualname = port_class_name(class_name).rpartition(".")
    module = importlib.import_module(module_name)
    obj: Any = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _resolve_saved_class(path: str, meta: Dict[str, Any]) -> type:
    """Resolve ``meta["className"]`` for the stage saved at ``path``,
    converting the raw importlib/getattr failure modes (module renamed,
    class deleted, metadata truncated) into a diagnosable ``IOError``
    naming the path and the stored class name — the model registry's
    hot-load path depends on these being actionable."""
    class_name = meta.get("className")
    if not class_name:
        raise IOError(
            f"Metadata at {path} has no className entry; the directory is "
            "not a saved stage (or the metadata file is truncated)")
    try:
        return _resolve_class(class_name)
    except (ImportError, AttributeError, ValueError) as exc:
        raise IOError(
            f"Cannot load stage at {path}: the stored class "
            f"{class_name!r} is not importable ({exc}).  The class was "
            "renamed/removed since the stage was saved, or the save came "
            "from a different code version.") from exc


def save_metadata(stage, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
    """Mirror of ``ReadWriteUtils.saveMetadata`` (``ReadWriteUtils.java:77-96``).

    Unlike the reference (which refuses to overwrite), saving over an existing
    directory is allowed but the metadata file is always rewritten atomically.
    """
    os.makedirs(path, exist_ok=True)
    meta = dict(extra or {})
    meta["className"] = _class_name(stage)
    meta["timestamp"] = int(time.time() * 1000)
    meta["paramMap"] = stage.params_to_json()
    tmp = os.path.join(path, ".metadata.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    os.replace(tmp, os.path.join(path, "metadata"))


def load_metadata(path: str, expected_class: Optional[type] = None) -> Dict[str, Any]:
    """Mirror of ``ReadWriteUtils.loadMetadata`` (``ReadWriteUtils.java:139-166``).

    A truncated/corrupted ``metadata`` file surfaces as the same
    diagnosable ``IOError`` (path + hint) that ``_resolve_saved_class``
    established — never a raw ``json.JSONDecodeError`` the registry's
    hot-load path can't act on."""
    meta_path = os.path.join(path, "metadata")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except json.JSONDecodeError as exc:
        raise IOError(
            f"Metadata at {meta_path} is not valid JSON ({exc}); the "
            "file is truncated or corrupted — the save was interrupted "
            "or the bytes were damaged; re-save the stage or restore "
            "from a valid copy") from exc
    if expected_class is not None:
        expected = _class_name(expected_class)
        if port_class_name(meta.get("className") or "") != expected:
            raise IOError(
                f"Metadata at {path} was saved by {meta.get('className')}, "
                f"expected {expected}")
    return meta


def stage_path(path: str, index: int) -> str:
    """``{path}/stages/%02d`` zero-padded child dir
    (``ReadWriteUtils.java:168-182``)."""
    return os.path.join(path, "stages", f"{index:02d}")


def save_pipeline(pipeline, stages: Sequence[Any], path: str) -> None:
    """Mirror of ``ReadWriteUtils.savePipeline`` (``ReadWriteUtils.java:184-198``)."""
    save_metadata(pipeline, path, {"numStages": len(stages)})
    for i, stage in enumerate(stages):
        stage.save(stage_path(path, i))


def load_pipeline(path: str, expected_class: Optional[type] = None) -> List[Any]:
    """Mirror of ``ReadWriteUtils.loadPipeline`` (``ReadWriteUtils.java:211-223``)."""
    meta = load_metadata(path, expected_class)
    num_stages = int(meta["numStages"])
    return [load_stage(stage_path(path, i)) for i in range(num_stages)]


def load_stage(path: str):
    """Reflective dispatch to the saved class's ``load``
    (``ReadWriteUtils.java:294-314``)."""
    meta = load_metadata(path)
    cls = _resolve_saved_class(path, meta)
    load_fn = getattr(cls, "load", None)
    if load_fn is None:
        raise IOError(f"Class {meta['className']} does not implement load()")
    return cls.load(path)


def load_stage_param(path: str):
    """Instantiate via no-arg constructor + restore params
    (``ReadWriteUtils.java:258-280``) — for stages whose state is purely
    their params."""
    meta = load_metadata(path)
    cls = _resolve_saved_class(path, meta)
    stage = cls()
    stage.params_from_json(meta.get("paramMap", {}))
    return stage


def get_data_path(path: str) -> str:
    """``{path}/data`` (``ReadWriteUtils.java:112-118``)."""
    return os.path.join(path, "data")


def save_model_arrays(path: str, name: str, arrays: Dict[str, np.ndarray]) -> str:
    """Write model data as a compressed npz under ``{path}/data/{name}.npz``
    (replaces the reference's Kryo FileSink, ``KMeansModel.java:184-199``).

    Atomic like :func:`save_metadata` (write tmp -> ``os.replace``): a
    crash mid-save can never leave a half-written model the serving
    registry would try to load."""
    data_dir = get_data_path(path)
    os.makedirs(data_dir, exist_ok=True)
    out = os.path.join(data_dir, f"{name}.npz")
    tmp = os.path.join(data_dir, f".{name}.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
        f.flush()
    os.replace(tmp, out)
    return out


def load_model_arrays(path: str, name: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`save_model_arrays`
    (replaces ``KMeansModel.load``'s Kryo FileSource, ``KMeansModel.java:202-213``).

    The npz's zip CRCs are a free integrity check: truncated or
    bit-flipped model data raises a diagnosable ``IOError`` naming the
    file — never silently-wrong params."""
    npz = os.path.join(get_data_path(path), f"{name}.npz")
    try:
        with np.load(npz) as data:
            return {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, EOFError, ValueError, KeyError) as exc:
        raise IOError(
            f"Model data at {npz} failed to load ({exc!r}); the file is "
            "truncated or corrupted — the save was interrupted or the "
            "bytes were damaged; re-save the model or restore from a "
            "valid copy") from exc
