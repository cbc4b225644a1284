"""The train->serve publish protocol: deltas into live generations.

A port of the JAX package's ``online/publish.py`` (host code around the
servables' device binds).

Producer side (:class:`DeltaEncoder`) runs next to the trainer: it
remembers the last published params and encodes each chunk-boundary cut
as a :class:`~.delta.ParamDelta` (or a :class:`~.delta.FullUpdate` when
the staleness policy, a structural change, or payload accounting says
re-anchor).

Consumer side (:class:`DeltaPublisher`) runs next to the registry: it
keeps its own base copy of the served params, applies each update under
digest verification (:func:`~.delta.apply_delta`), rebuilds the model
object around the new params, and publishes by **rebinding** the live
:class:`~flink_ml_tpu_torch.serving.executor.ServableModel` — a shallow
clone pointing at the new model, marked ready WITHOUT warm-up.  That is
safe for the kernel servables (linear / KMeans / Wide&Deep / IVF index,
``rebind_safe``): they run their model's terminal kernel with the params
as arguments, so a same-shape generation builds no plan and loads no
kernel library — the rebind copies the new params to the card once, on
the publishing thread, and the registry swaps one reference.  Families
that serve through the model's own ``transform`` fall back to the full
``registry.deploy`` load->warm->swap path.

Exactly-once across replays: updates are ordered by the producer's
train-step cursor.  A replayed cut (crash between checkpoint and the
next one) arrives with ``step <= last applied``; at ``step ==`` the
publisher *verifies* the replay reproduced the identical digest — the
deterministic-replay guarantee made observable — and no-ops, at ``step
<`` it skips (serving never moves backward).  A delta against a base
the publisher does not hold raises :class:`~.delta.DeltaBaseMismatch`
and the encoder re-anchors with a full update.  The registry swap
itself is one reference assignment under the registry lock, so a crash
mid-publish can never expose a half-applied generation — in-flight
requests finish on the version their batch captured.
"""

from __future__ import annotations

import copy
import threading
import time

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..obs.trace import tracer
from .delta import (
    DeltaCorrupt,
    DeltaShapeChanged,
    FullUpdate,
    ParamDelta,
    apply_delta,
    diff_params,
    flatten_params,
    tree_digest,
    unflatten_params,
)
from .staleness import PublishStats, StalenessPolicy

__all__ = ["DeltaEncoder", "DeltaPublisher", "PublishResult",
           "DeterminismViolation", "params_of_model", "model_with_params"]


class DeterminismViolation(RuntimeError):
    """A replayed cut (same train step) produced different bits than the
    original publish — the deterministic-replay contract the exactly-once
    design rests on is broken.  Never serve silently past this."""


# -- model family adapters ---------------------------------------------------
#
# The canonical published-params form is the TRAINER's tree (f32 — what
# the chunk-boundary cut holds); the adapters rebuild a servable model
# object around it.  Kept as isinstance dispatch (the make_servable
# stance) so the family list lives in one place.

def params_of_model(model: Any) -> Any:
    """The live model's params as the canonical publish tree (host
    numpy)."""
    from ..models.clustering.kmeans import KMeansModel
    from ..models.common.linear import LinearModelBase
    from ..models.recommendation.widedeep import WideDeepModel
    from ..retrieval.ivf import IVFIndex

    if isinstance(model, LinearModelBase):
        model._require_model()
        # f64 LinearState holds f32-trained values: the f32 cast is
        # value-exact and restores the trainer's canonical form
        return {"w": np.asarray(model._state.coefficients, np.float32),
                "b": np.asarray(model._state.intercept, np.float32)}
    if isinstance(model, KMeansModel):
        model._require_model()
        return {"centroids": np.asarray(model._centroids, np.float32)}
    if isinstance(model, WideDeepModel):
        model._require_model()
        # the fitted params tree is host numpy already
        return _map_tree(model._params, np.asarray)
    if isinstance(model, IVFIndex):
        # the index's params dict IS the canonical tree (posting-list
        # row blocks + centroids + codebooks); posting-list edits touch
        # few rows, so the sparse delta codec pays off exactly as it
        # does for embedding tables
        return {name: np.asarray(arr)
                for name, arr in model.params.items()}
    raise TypeError(
        f"{type(model).__name__} has no params_of_model adapter; "
        "delta publishing covers the kernel servable families "
        "(linear / KMeans / WideDeep) and IVFIndex — use the full "
        "deploy path")


def model_with_params(model: Any, params: Any) -> Any:
    """A shallow clone of ``model`` carrying ``params`` — the object the
    rebound servable scores with.  The clone shares everything immutable
    (param map, vocab sizes, column names, device) and replaces only the
    fitted state."""
    from ..models.clustering.kmeans import KMeansModel
    from ..models.common.linear import LinearModelBase
    from ..models.common.sgd import LinearState
    from ..models.recommendation.widedeep import WideDeepModel
    from ..retrieval.ivf import IVFIndex

    if isinstance(model, IVFIndex):
        # host bookkeeping (the id->vector store) stays with the
        # producer's authoritative index; the serve-side clone only
        # needs the params (copied to the card once, at its bind)
        return model.rebound(params)
    clone = copy.copy(model)
    if isinstance(model, LinearModelBase):
        clone._state = LinearState(
            np.asarray(params["w"], np.float64),
            float(np.asarray(params["b"])),
            planned_impl="online-delta")
        return clone
    if isinstance(model, KMeansModel):
        clone._centroids = np.asarray(params["centroids"], np.float32)
        return clone
    if isinstance(model, WideDeepModel):
        clone._params = _map_tree(params, np.asarray)
        return clone
    raise TypeError(
        f"{type(model).__name__} has no model_with_params adapter")


def _map_tree(tree: Any, fn) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _map_tree(sub, fn) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_tree(sub, fn) for sub in tree]
        return items if isinstance(tree, list) else tuple(items)
    return fn(tree)


# -- producer side -----------------------------------------------------------

class DeltaEncoder:
    """Trainer-side half: turns each cut's params into the update the
    policy calls for, tracking the last ACKNOWLEDGED base.  ``encode``
    never mutates its base until the caller confirms the publish landed
    (``ack``) — a publish that raises leaves the encoder anchored on the
    generation serving traffic, so the next encode diffs against
    reality."""

    def __init__(self, policy: Optional[StalenessPolicy] = None):
        self.policy = policy or StalenessPolicy()
        self._base: Optional[Dict[str, np.ndarray]] = None
        #: digest of ``_base`` — the previous publish's new_digest,
        #: cached so each cut skips one whole-tree CRC (encode is on the
        #: publish latency path)
        self._base_digest: Optional[int] = None
        self._pending: Optional[Dict[str, np.ndarray]] = None
        self._pending_digest: Optional[int] = None

    def encode(self, step: int, params: Any,
               stats: Optional[PublishStats] = None):
        """-> :class:`FullUpdate` | :class:`ParamDelta` for this cut."""
        stats = stats if stats is not None else PublishStats()
        flat = flatten_params(params)
        if self._base is None or self.policy.wants_full(stats):
            return self._pend(FullUpdate(
                step=step, new_digest=tree_digest(flat), params=flat))
        try:
            delta = diff_params(self._base, flat, step=step,
                                base_digest=self._base_digest)
        except DeltaShapeChanged:
            return self._pend(FullUpdate(
                step=step, new_digest=tree_digest(flat), params=flat))
        full_bytes = sum(a.size * a.itemsize for a in flat.values())
        if self.policy.choose(delta.payload_bytes, full_bytes,
                              stats) == "full":
            return self._pend(FullUpdate(
                step=step, new_digest=delta.new_digest, params=flat))
        return self._pend(delta, flat)

    def _pend(self, update, flat: Optional[Dict[str, np.ndarray]] = None):
        self._pending = flat if flat is not None else update.params
        self._pending_digest = update.new_digest
        return update

    def ack(self) -> None:
        """The last encoded update landed: its params become the base the
        next delta diffs against."""
        if self._pending is not None:
            self._base = self._pending
            self._base_digest = self._pending_digest
            self._pending = None
            self._pending_digest = None

    def reset(self) -> None:
        """Drop the base (next encode ships full) — the heal move after
        :class:`~.delta.DeltaBaseMismatch`."""
        self._base = None
        self._base_digest = None
        self._pending = None
        self._pending_digest = None


# -- consumer side -----------------------------------------------------------

@dataclass(frozen=True)
class PublishResult:
    generation: int         # live generation after this call
    mode: str               # "delta" | "full" | "full-redeploy" | "noop"
    step: int
    payload_bytes: int
    publish_s: float        # wall time inside apply()


class DeltaPublisher:
    """Serving-side half: applies updates to its base copy and swaps the
    result into the registry as the next generation of ``name``."""

    def __init__(self, registry: Any, name: str = "default", *,
                 metrics: Optional[Any] = None):
        self._registry = registry
        self._name = name
        self._metrics = metrics if metrics is not None \
            else getattr(registry, "metrics", None)
        self._lock = threading.Lock()
        self._base: Optional[Dict[str, np.ndarray]] = None
        self._template: Any = None
        #: generation of the last publish WE made — when the live entry
        #: moved past it (an external deploy/hot_swap, a failover
        #: re-admission), our cached base no longer describes what
        #: serves and must re-anchor on it
        self._last_generation: Optional[int] = None
        self.stats = PublishStats()

    # -- base management ----------------------------------------------------
    def _ensure_base(self) -> None:
        if self._base is not None:
            return
        live = self._registry.current(self._name)
        self._template = params_of_model(live.servable.model)
        self._base = flatten_params(self._template)

    @property
    def last_step(self) -> Optional[int]:
        return self.stats.last_published_step

    # -- the publish --------------------------------------------------------
    def apply(self, update) -> PublishResult:
        """Apply one update (:class:`FullUpdate` / :class:`ParamDelta`)
        and publish the result atomically.  Thread-safe; idempotent on
        replays (see module doc).  A concurrent external deploy landing
        between validation and swap loses us the compare-and-swap
        (:class:`~flink_ml_tpu_torch.serving.registry.GenerationConflict`):
        ONE retry re-validates against the new generation — sequential
        semantics, just later."""
        from ..serving.registry import GenerationConflict

        t0 = time.perf_counter()
        with self._lock, \
                tracer.span("delta_publish", cat="publish",
                            step=int(update.step)) as span:
            try:
                result = self._apply_locked(update, t0)
            except GenerationConflict:
                # drop every cached view of the entry (the drift check
                # alone misses a first-publish race) and re-validate
                self._base = None
                self._template = None
                result = self._apply_locked(update, t0)
            # the publish span carries BOTH halves of the correlation
            # chain: the trainer's cut step and the serving generation
            # it became — the join point of "cut T -> generation G"
            span.note(generation=result.generation, x_mode=result.mode)
            return result

    def _apply_locked(self, update, t0: float) -> PublishResult:
        live = self._registry.current(self._name)
        drifted = (self._last_generation is not None
                   and live.generation != self._last_generation)
        if drifted:
            # someone else deployed into this entry (operator hot_swap,
            # registry deploy, failover re-admission): our cached
            # base/template describe a generation that may no longer
            # serve.  Re-anchor on the LIVE model — a pending delta then
            # applies only if the live params are its base (else it
            # base-mismatches and the caller heals with a full
            # re-anchor), and a FullUpdate shape-checks against what
            # actually serves, never against stale shapes.
            self._base = None
            self._template = None
        last = self.stats.last_published_step
        if last is not None and update.step <= last:
            if update.step == last and not drifted:
                # replayed cut (crash between this cut and the next):
                # deterministic replay MUST reproduce the exact bits.
                # (After an external deploy the base is the OTHER
                # model's — the check would be against the wrong tree.)
                self._ensure_base()
                if update.new_digest != tree_digest(self._base):
                    raise DeterminismViolation(
                        f"replayed cut at step {update.step} digests "
                        f"{update.new_digest:#010x}, original publish "
                        f"digested {tree_digest(self._base):#010x}")
            self.stats.skips += 1
            return PublishResult(generation=live.generation, mode="noop",
                                 step=update.step, payload_bytes=0,
                                 publish_s=time.perf_counter() - t0)
        if isinstance(update, FullUpdate):
            new_flat = dict(update.params)
            if tree_digest(new_flat) != update.new_digest:
                raise DeltaCorrupt(
                    f"full update at step {update.step} digests "
                    f"differently than its header — torn payload")
            mode = "full"
            # a delta is shape-guarded by its base digest; a FULL update
            # must be checked here, or a shape-incompatible publish
            # would ride the rebind fast path (which skips the warm-up
            # that catches exactly this) and break every later request.
            # A real shape/schema change needs a new example and a
            # warmed deploy — the registry path, outside this protocol.
            self._ensure_base()
            if (set(new_flat) != set(self._base)
                    or any(new_flat[k].shape != self._base[k].shape
                           or new_flat[k].dtype != self._base[k].dtype
                           for k in new_flat)):
                raise DeltaShapeChanged(
                    f"full update at step {update.step} does not match "
                    "the live generation's param shapes/dtypes; a "
                    "shape/schema change must go through "
                    "registry.deploy() with a fresh example (warmed at "
                    "the new shapes), not the publish fast path")
        elif isinstance(update, ParamDelta):
            self._ensure_base()
            new_flat = apply_delta(self._base, update)
            mode = "delta"
        else:
            raise TypeError(f"not a publishable update: {update!r}")

        if self._template is None:
            self._template = params_of_model(live.servable.model)
        new_params = unflatten_params(self._template, new_flat)
        new_model = model_with_params(live.servable.model, new_params)
        if getattr(live.servable, "rebind_safe", False):
            # the rebind runs the new generation's bind on THIS thread
            # (params to the card once; an int8 servable re-derives its
            # scales from the new params) BEFORE the conditional swap
            # below — in-flight requests finish on the old generation
            servable = live.servable.rebind(new_model)
            deployed = self._registry.publish_servable(
                self._name, servable,
                source=f"<{mode}:step={update.step}>",
                metrics=self._metrics, mode=mode,
                payload_bytes=update.payload_bytes,
                # compare-and-swap: everything above validated against
                # live.generation — refuse to clobber a deploy that
                # landed since (apply() retries through re-validation)
                expected_generation=live.generation)
        else:
            # the generic adapter serves through model.transform: full
            # path (warm off the serving path, then swap)
            mode = "full-redeploy"
            deployed = self._registry.deploy(
                self._name, new_model, metrics=self._metrics)
            if self._metrics is not None \
                    and hasattr(self._metrics, "on_publish"):
                # deploy() only records on_deploy: account the publish
                # (staleness gauge, full counter) here too, or a
                # continuously-trained generic-family endpoint reads as
                # never published
                self._metrics.on_publish(
                    deployed.generation, mode="full",
                    payload_bytes=update.payload_bytes)
        return self._landed(int(update.step), mode, update.payload_bytes,
                            deployed.generation, new_flat, t0)

    def _landed(self, step: int, mode: str, payload_bytes: int,
                generation: int, new_flat: Dict[str, np.ndarray],
                t0: float) -> PublishResult:
        """Account a publish that swapped: the new base, the generation
        we made, the stats the policy and the bench read."""
        self._base = new_flat
        self._last_generation = generation
        st = self.stats
        st.publishes += 1
        st.last_publish_at = time.time()
        st.last_published_step = step
        if mode == "delta":
            st.deltas += 1
            st.delta_bytes += payload_bytes
        else:
            st.fulls += 1
            st.full_bytes += payload_bytes
        return PublishResult(generation=generation, mode=mode, step=step,
                             payload_bytes=payload_bytes,
                             publish_s=time.perf_counter() - t0)

    def redeploy(self, step: int, model: Any) -> PublishResult:
        """Publish ``model`` whole through the registry's warmed deploy
        (load -> warm every bucket -> swap, on this thread): the path for
        a generation whose param shapes changed — an IVF re-anchor that
        rebuilt its blocks — which the rebind fast path must never take.
        Re-anchors this publisher on the deployed params; a step at or
        below the last published one is a no-op, as in :meth:`apply`."""
        t0 = time.perf_counter()
        with self._lock, \
                tracer.span("delta_publish", cat="publish",
                            step=int(step)) as span:
            live = self._registry.current(self._name)
            last = self.stats.last_published_step
            if last is not None and step <= last:
                self.stats.skips += 1
                result = PublishResult(
                    generation=live.generation, mode="noop", step=step,
                    payload_bytes=0, publish_s=time.perf_counter() - t0)
            else:
                template = params_of_model(model)
                new_flat = flatten_params(template)
                payload = sum(a.size * a.itemsize
                              for a in new_flat.values())
                deployed = self._registry.deploy(self._name, model,
                                                 metrics=self._metrics)
                if self._metrics is not None \
                        and hasattr(self._metrics, "on_publish"):
                    self._metrics.on_publish(deployed.generation,
                                             mode="full",
                                             payload_bytes=payload)
                self._template = template
                result = self._landed(int(step), "full-redeploy", payload,
                                      deployed.generation, new_flat, t0)
            span.note(generation=result.generation, x_mode=result.mode)
            return result
