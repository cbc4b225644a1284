"""Broadcast variables.

Capability mirror of ``flink-ml-lib/.../common/broadcast/`` (SURVEY §2.8):
the reference makes a small stream fully available to every parallel
instance of an operator before it runs.  In the port a broadcast variable
is a replicated value: every rank holds the same tensors on its device.

``with_broadcast`` keeps the reference's API shape
(``BroadcastUtils.withBroadcastStream(inputs, broadcastMap, userFn)``,
``BroadcastUtils.java:67-119``): materialize the named tables on the
rank's device, expose them through a context, run the user function.  A
port of the JAX package's ``data/broadcast.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

from ..parallel.mesh import replicate
from .table import Table

__all__ = ["BroadcastContext", "with_broadcast"]


class BroadcastContext:
    """Named replicated variables (analog of ``BroadcastContext.java:34-113``,
    whose JVM-singleton map becomes instance state)."""

    def __init__(self, variables: Mapping[str, Any]):
        self._variables = dict(variables)

    def get_broadcast_variable(self, name: str) -> Any:
        """The analog of ``RichFunction.getBroadcastVariable(name)``
        (``BroadcastStreamingRuntimeContext.java``)."""
        if name not in self._variables:
            raise KeyError(
                f"No broadcast variable {name!r}; available: "
                f"{sorted(self._variables)}")
        return self._variables[name]

    def names(self):
        return sorted(self._variables)


def _materialize(value: Any, mesh, device) -> Any:
    """Table -> dict of replicated tensors; array or tree -> replicated
    as-is (numeric object columns are densified)."""
    if isinstance(value, Table):
        cols = {}
        for name in value.column_names:
            col = value[name]
            if col.dtype == object:
                from ..linalg import stack_vectors
                col = stack_vectors(col)
            cols[name] = col
        return replicate(cols, mesh, device=device)
    return replicate(value, mesh, device=device)


def with_broadcast(fn: Callable[..., Any],
                   broadcast: Mapping[str, Any],
                   *inputs,
                   mesh=None, device=None) -> Any:
    """Run ``fn(*inputs, ctx)`` with ``broadcast`` (name -> Table or array
    tree) replicated on the rank's device (``device``, else the mesh's,
    else the card).  The variables are fully materialized before ``fn``
    runs, as ``BroadcastUtils.withBroadcastStream`` guarantees."""
    ctx = BroadcastContext(
        {name: _materialize(value, mesh, device)
         for name, value in broadcast.items()})
    return fn(*inputs, ctx)
