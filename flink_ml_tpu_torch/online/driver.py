"""The continuous-learning driver: training and serving as ONE system.

A port of the JAX package's ``online/driver.py``.  :class:`ContinuousLearner`
runs the streaming trainer *forever* off the write-ahead window log and,
at every chunk-boundary cut, pushes the params straight into the live
serving generation as a delta (``publish.py``) — no reload, no warm-up,
no plan build in steady state.  On the card, a mixed (Criteo-shaped)
stream trains through the ELL margin and fused scatter kernels (B1, B2)
once a step, with the streamed fit's scatter-adds in a fixed order.

The exactly-once chain across ingest -> train -> publish:

1. **Ingest**: every live window is durably appended to the
   :class:`~flink_ml_tpu_torch.data.wal.WindowLog` BEFORE the trainer
   sees it.
2. **Train**: ``sgd_fit_outofcore`` cuts a validated checkpoint
   (params + window cursor, CRC manifest + commit marker) every
   ``publish_every_steps`` windows.
3. **Publish**: the cut's params publish AFTER the save — the served
   state is never ahead of the durable one — ordered by the train-step
   cursor, idempotent on replays (``publish.DeltaPublisher``).

A crash anywhere (mid-chunk, mid-publish, torn newest checkpoint, torn
newest WAL tail) is healed by :func:`~flink_ml_tpu_torch.robustness
.supervisor.resilient_fit`: restore the newest VALID cut, replay the
WAL past the cursor, re-run — deterministic replay reproduces the same
params at every subsequent cut, so replayed publishes are digest-
verified no-ops and the served model converges to the same bits as the
uninterrupted run.  The model served after the cut at step T is bit for
bit an offline ``sgd_fit_outofcore`` over WAL windows <= T on the same
device.

Hosted ``iterate`` bodies (online KMeans, FTRL-style logistic
regression) join the same publish protocol through
:class:`PublishingListener`, which rides the iteration's
``on_checkpoint_saved`` hook.
"""

from __future__ import annotations

import logging

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..data.wal import WindowBatchReader, WindowLog
from ..iteration.body import IterationListener
from ..obs.trace import tracer
from .delta import (DeltaBaseMismatch, DeltaShapeChanged, flatten_params,
                    unflatten_params)
from .publish import (DeltaEncoder, DeltaPublisher, PublishResult,
                      params_of_model)
from .staleness import StalenessPolicy

__all__ = ["ContinuousLearner", "PublishingListener", "encode_and_publish",
           "publish_index_update"]

log = logging.getLogger("flink_ml_tpu_torch.online")


def encode_and_publish(encoder: DeltaEncoder, publisher: DeltaPublisher,
                       step: int, params: Any) -> PublishResult:
    """One cut through the protocol: encode against the encoder's base,
    apply at the publisher, heal a base mismatch (the encoder's view
    went stale across a crash) with a full re-anchor, and ack only a
    landed publish — the shared producer-side state machine of the
    driver and the hosted-iterate listener."""
    update = encoder.encode(step, params, publisher.stats)
    try:
        result = publisher.apply(update)
    except DeltaBaseMismatch:
        log.warning("delta base went stale at step %d; re-anchoring "
                    "with a full update", step)
        encoder.reset()
        result = publisher.apply(
            encoder.encode(step, params, publisher.stats))
    encoder.ack()
    return result


def publish_index_update(encoder: DeltaEncoder, publisher: DeltaPublisher,
                         step: int, mode: str, index: Any) -> PublishResult:
    """Publish one ``IVFIndex.updated`` result into a live index tenant.

    ``"delta"`` (posting-list edits in place) encodes against the
    encoder's base — a sparse delta of the touched rows.  ``"reanchor"``
    (the index was rebuilt) drops the encoder's base and ships the whole
    params as a :class:`~.delta.FullUpdate` on the rebind path when the
    shapes held, else through the publisher's warmed redeploy (a new
    block size is a new kernel shape: it must warm before it serves)."""
    if mode not in ("delta", "reanchor"):
        raise ValueError(f'mode must be "delta" or "reanchor", got {mode!r}')
    params = params_of_model(index)
    if mode == "delta":
        return encode_and_publish(encoder, publisher, step, params)
    encoder.reset()
    try:
        return encode_and_publish(encoder, publisher, step, params)
    except DeltaShapeChanged:
        encoder.reset()
        result = publisher.redeploy(step, index)
        encoder.encode(step, params, publisher.stats)   # re-anchor on it
        encoder.ack()
        return result


class ContinuousLearner:
    """Run the streaming SGD trainer forever off a WAL, publishing
    chunk-boundary cuts into a live serving generation.

    ``source`` is the LIVE feed (any iterable of fixed-row window
    Tables); ``wal_dir`` is its write-ahead log.  ``endpoint`` names the
    serving side: its registry entry must already hold a deployed
    generation of a delta-capable family (the linear servables — deploy
    an offline-fitted or zero-init model first); the driver's publishes
    land on that entry and account on its metrics.

    ``device`` is where the fit trains (default ``"cuda"``: raises
    without a card unless the CPU is asked for).  The remaining keywords
    go to ``sgd_fit_outofcore`` — ``dense_key=`` + ``indices_key=`` train
    the mixed layout through the ELL kernels.

    ``run()`` wraps the whole loop in ``resilient_fit``; every restart
    rebuilds a fresh :class:`WindowLog` over the same live source (the
    crash-heal path replays logged-but-unacknowledged windows first).
    """

    def __init__(self, *, loss_fn: Callable, num_features: int,
                 source: Any, wal_dir: str,
                 endpoint: Optional[Any] = None,
                 registry: Optional[Any] = None, name: str = "default",
                 batch_rows: int, config: Optional[Any] = None,
                 checkpoint: Any = None,
                 publish_every_steps: int = 8,
                 policy: Optional[StalenessPolicy] = None,
                 keep_snapshots: int = 4,
                 features_key: str = "features",
                 label_key: str = "label",
                 weight_key: Optional[str] = None,
                 max_restarts: int = 3,
                 backoff: Optional[Any] = None,
                 device="cuda",
                 **fit_kwargs: Any):
        from ..models.common.sgd import SGDConfig
        from ..utils.device import resolve_device

        if endpoint is not None:
            registry = endpoint.registry
            name = endpoint._name
            metrics = endpoint.metrics
        elif registry is not None:
            metrics = registry.metrics
        else:
            raise ValueError("pass endpoint= or registry=")
        if checkpoint is None:
            raise ValueError(
                "ContinuousLearner needs checkpoint= (a CheckpointConfig/"
                "Manager): the exactly-once loop hangs off durable cuts")
        if publish_every_steps < 1:
            raise ValueError("publish_every_steps must be >= 1")
        self._loss_fn = loss_fn
        self._num_features = num_features
        self._source = source
        self._wal_dir = wal_dir
        self._registry = registry
        self._name = name
        self._batch_rows = int(batch_rows)
        self._config = config or SGDConfig(max_epochs=1, tol=0.0)
        if self._config.max_epochs != 1:
            raise ValueError(
                "continuous learning is single-pass by construction "
                "(an unbounded stream has no epochs): use "
                "SGDConfig(max_epochs=1); multi-epoch refinement belongs "
                "to the offline fit")
        self._checkpoint = checkpoint
        self._every = int(publish_every_steps)
        self._keep = keep_snapshots
        self._keys = dict(features_key=features_key, label_key=label_key,
                          weight_key=weight_key)
        self._max_restarts = max_restarts
        self._backoff = backoff
        resolve_device(device)      # no card: raise here, not mid-stream
        self.device = device
        self._fit_kwargs = fit_kwargs
        # cuts land at chunk boundaries, so a publish cadence finer than
        # the dispatch chunk would silently coarsen to it — align the
        # default chunk with the cadence (callers can still override)
        self._fit_kwargs.setdefault("steps_per_dispatch",
                                    min(8, self._every))
        self.policy = policy or StalenessPolicy()
        self.encoder = DeltaEncoder(policy=self.policy)
        self.publisher = DeltaPublisher(registry, name, metrics=metrics)
        self.publish_log: List[PublishResult] = []
        self._wal: Optional[WindowLog] = None

    # -- the cut hook --------------------------------------------------------
    def _on_cut(self, step: int,
                params_fn: Callable[[], Dict[str, np.ndarray]]) -> None:
        # the cut index derives from the STEP cursor (not a local
        # counter) so a replayed cut makes the same publish/skip
        # decision as the original run — determinism across restarts.
        # ``params_fn`` is the fit's lazy host-fetch thunk: a skipped
        # cut never pays the device->host copy it exists to avoid.
        if not self.policy.due(step // self._every, self.publisher.stats):
            self.publisher.stats.skips += 1
            # the cadence skip is a real event on the cut timeline: a
            # trace showing cut T with no publish must say WHY
            tracer.instant("publish_skip", cat="publish", step=step)
        else:
            result = encode_and_publish(self.encoder, self.publisher,
                                        step, params_fn())
            if result.mode != "noop":
                self.publish_log.append(result)
        if self._wal is not None:
            # WAL truncation horizon: snapshot positions trail the live
            # cursor by keep_snapshots cuts, which must cover the
            # prefetch lead plus a quarantined-newest-checkpoint
            # fallback — the WindowLog raises loudly if sized too small
            self._wal.snapshot()

    # -- the supervised loop -------------------------------------------------
    def run(self, max_windows: Optional[int] = None,
            resume: bool = True, report: Optional[Any] = None):
        """Train-and-serve until the source ends (or ``max_windows``).
        Returns ``(LinearState, loss_log)`` from the underlying fit —
        unbounded sources never return; bounded runs (benches, tests)
        do.  ``resume=True`` (default) continues from the newest valid
        checkpoint + WAL cursor, which is also what every crash restart
        does."""
        from ..models.common.sgd import sgd_fit_outofcore
        from ..robustness.supervisor import resilient_fit

        self._registry.current(self._name)   # serving must be live first

        def fit(checkpoint, resume):
            # fresh WindowLog per attempt over the SAME live source: the
            # heal path replays logged-but-unacknowledged windows first
            self._wal = WindowLog(self._source, self._wal_dir,
                                  keep_snapshots=self._keep)
            reader = WindowBatchReader(self._wal, self._batch_rows,
                                       max_windows=max_windows)
            return sgd_fit_outofcore(
                self._loss_fn, lambda: reader,
                num_features=self._num_features, config=self._config,
                checkpoint=checkpoint,
                checkpoint_every_steps=self._every,
                resume=resume, publish_cb=self._on_cut,
                device=self.device, **self._keys, **self._fit_kwargs)

        return resilient_fit(fit, checkpoint=self._checkpoint,
                             max_restarts=self._max_restarts,
                             backoff=self._backoff, resume=resume,
                             report=report)


class PublishingListener(IterationListener):
    """Publish hosted-``iterate`` state into a live serving generation —
    the continuous-learning path for online KMeans / FTRL-style bodies.

    Rides ``on_checkpoint_saved`` by default, so every publish is of a
    state that is already durable (the driver's exactly-once ordering);
    ``publish_on="epoch"`` publishes at watermarks instead for
    iterations run without a checkpoint manager (no exactly-once claim
    there — a crash may re-serve older bits until the stream re-trains).

    ``params_of`` maps the iteration state to the canonical publish
    tree of the deployed model family (e.g. online-KMeans state ->
    ``{"centroids": ...}``); its tensors are fetched to the host with
    ``.cpu()``.  ``every`` thins the cadence."""

    def __init__(self, publisher: DeltaPublisher, *,
                 params_of: Callable[[Any], Any] = lambda s: s,
                 every: int = 1, publish_on: str = "checkpoint",
                 policy: Optional[StalenessPolicy] = None):
        if publish_on not in ("checkpoint", "epoch"):
            raise ValueError('publish_on must be "checkpoint" or "epoch"')
        if every < 1:
            raise ValueError("every must be >= 1")
        self.publisher = publisher
        self.encoder = DeltaEncoder(policy=policy or StalenessPolicy())
        self._params_of = params_of
        self._every = every
        self._on = publish_on
        self.publish_log: List[PublishResult] = []

    def _publish(self, epoch: int, context) -> None:
        step = epoch + 1               # cuts/watermarks are post-epoch
        if step % self._every:
            return
        tree = self._params_of(context.state)
        params = unflatten_params(tree, flatten_params(tree))
        result = encode_and_publish(self.encoder, self.publisher,
                                    step, params)
        if result.mode != "noop":
            self.publish_log.append(result)

    def on_checkpoint_saved(self, epoch: int, context) -> None:
        if self._on == "checkpoint":
            self._publish(epoch, context)

    def on_epoch_watermark_incremented(self, epoch: int, context) -> None:
        if self._on == "epoch":
            self._publish(epoch, context)
