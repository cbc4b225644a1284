"""The iteration runtime: ``iterate``, the epoch loop in Python.

A port of the JAX package's ``iteration/core.py`` (the reference's
``Iterations.java:104-286`` and the operator machinery it drives).  The
feedback edge is the state tree, tensors that stay on the device between
epochs; the epoch boundary is the superstep barrier; replayed inputs are
device-resident tensors handed to every epoch.  PyTorch runs eagerly, so
both modes are Python loops; they differ in what the host does between
epochs:

- **fused**: no listeners, checkpoints or per-epoch data.  Without a
  termination criterion the loop never waits for the device; with one
  (a body's ``termination`` vote, or a workset) it reads one scalar per
  epoch, "continue?", where the JAX package decides inside
  ``lax.while_loop``.  The per-epoch ``active_fraction`` and vote stay
  on the device until the end and come back in ``side["epoch_trace"]``.
  A criteria-driven fused loop keeps only the last epoch's outputs.
- **hosted**: per-epoch listener callbacks, per-epoch data sources
  (``PerEpoch``, iterators, callables), PER_ROUND lifecycles, the
  ``iterate.epoch`` fault seam and validated checkpoint/resume with the
  source's cursor.  ``steps_per_dispatch=W`` reads the vote once per W
  epochs (see :class:`~.body.IterationConfig`).

``mode="auto"`` picks fused by the JAX package's rule: static data, no
listeners, no checkpoint, ALL_ROUND, ``max_epochs`` set, and a body that
casts no vote (or a workset body that emits no outputs).  Where the JAX
package evaluates the body's output structure without running it, the
port runs epoch 0 once and reuses its result in whichever loop it picks.
"""

from __future__ import annotations

import dataclasses
import warnings

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..obs.trace import null_span, tracer
from .body import (
    EpochContext,
    IterationBodyResult,
    IterationConfig,
    IterationListener,
    OperatorLifeCycle,
    Workset,
    active_fraction,
    normalize_body_result,
)
from .checkpoint import CheckpointConfig, CheckpointManager

__all__ = ["iterate", "IterationResult", "Replayed", "PerEpoch"]

BodyFn = Callable[..., Any]


@dataclass
class IterationResult:
    """Final state and outputs.  ``workset`` is the final :class:`Workset`
    of a workset iteration (None otherwise); ``side["epoch_trace"]`` of a
    criteria-driven fused loop (and of a per-epoch hosted workset loop)
    holds ``{"active_fraction": (num_epochs,), "termination":
    (num_epochs,)}`` host arrays; a hosted loop's ``side`` also carries
    ``termination_reason`` and the listeners' side outputs."""

    state: Any
    outputs: Any
    num_epochs: int
    side: dict
    workset: Any = None


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``):
    dict / list / tuple / namedtuple / :class:`Workset` containers."""
    if isinstance(tree, Workset):
        return Workset(
            _tree_map(fn, tree.mask, *(r.mask for r in rest)),
            _tree_map(fn, tree.bounds, *(r.bounds for r in rest)))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _private_copy(state: Any) -> Any:
    """A copy of the tensors of ``state`` (re-entering state must not
    alias tensors a body may write in place)."""
    return _tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def _first_device(tree: Any) -> torch.device:
    found = []
    _tree_map(lambda x: found.append(x.device)
              if isinstance(x, torch.Tensor) else None, tree)
    return found[0] if found else torch.device("cpu")


def _to_device(tree: Any, device: torch.device) -> Any:
    """Restored host leaves (numpy) as tensors on ``device``."""
    return _tree_map(
        lambda x: torch.from_numpy(np.require(x, requirements="C"))
        .to(device) if isinstance(x, np.ndarray) else x, tree)


def _freeze(alive: Any, new: Any, old: Any) -> Any:
    """``new`` where ``alive``, else ``old``, leaf by leaf (the dead epochs
    of a chunk run on the frozen state and are discarded)."""
    if alive is True:
        return new
    return _tree_map(
        lambda n, o: torch.where(alive, n, o)
        if isinstance(n, torch.Tensor) else n, new, old)


class Replayed:
    """Marks a bounded input replayed identically every epoch (the analog of
    ``ReplayableDataStreamList.replay(...)``): device-resident, so replay
    costs nothing."""

    def __init__(self, value: Any):
        self.value = value


class PerEpoch:
    """Marks a per-epoch source: a callable ``f(epoch) -> tree`` or an
    iterable consumed one item per epoch (the analog of
    ``ReplayableDataStreamList.notReplay(...)`` / an unbounded stream).
    Exhaustion of any PerEpoch iterator ends the iteration."""

    def __init__(self, source: Any):
        self.source = source


class _Feed:
    """One normalized leaf source."""

    def __init__(self, raw: Any):
        self.static = None
        self.fn = None
        self.it: Optional[Iterator] = None
        if callable(raw):
            self.fn = raw
        elif hasattr(raw, "__next__"):
            self.it = raw
        elif hasattr(raw, "__iter__") and not isinstance(
                raw, (dict, tuple, list, str, torch.Tensor, np.ndarray)):
            # keep the original object reachable for snapshot/restore
            self.source = raw
            self.it = iter(raw)
        else:
            self.static = raw
        if not hasattr(self, "source"):
            self.source = raw


class _DataProvider:
    """Adapts the ``data`` argument to a per-epoch feed.

    - None                  -> body gets data=None every epoch
    - tree of tensors       -> replayed: the same tensors each epoch
    - callable / iterator   -> per-epoch source (exhaustion = stream end)
    - Replayed(x)/PerEpoch(s) markers, possibly MIXED one level deep inside
      a dict/tuple/list — the ``ReplayableDataStreamList`` analog, e.g.
      ``{"train": Replayed(points), "stream": PerEpoch(reader)}``
    """

    def __init__(self, data: Any):
        self.exhausted = False
        self._container: Optional[type] = None
        self._keys = None
        self._feeds = None
        self._single: Optional[_Feed] = None

        data = self._unwrap(data)
        if isinstance(data, _Feed):
            self._single = data
            return
        if isinstance(data, dict) and any(
                isinstance(v, (Replayed, PerEpoch)) for v in data.values()):
            self._container = dict
            self._keys = list(data.keys())
            self._feeds = [self._unwrap(data[k], force=True)
                           for k in self._keys]
            return
        if isinstance(data, (tuple, list)) and any(
                isinstance(v, (Replayed, PerEpoch)) for v in data):
            self._container = type(data)
            self._feeds = [self._unwrap(v, force=True) for v in data]
            return
        # plain tree (or None): replayed static data
        self._single = _Feed(None)
        self._single.static = data
        self._single.source = data

    @staticmethod
    def _unwrap(value: Any, force: bool = False):
        if isinstance(value, Replayed):
            feed = _Feed(None)
            feed.static = value.value
            feed.source = value.value
            return feed
        if isinstance(value, PerEpoch):
            return _Feed(value.source)
        if force:
            feed = _Feed(None)
            feed.static = value
            feed.source = value
            return feed
        if value is None or isinstance(value, (dict, tuple, list)) \
                or hasattr(value, "shape"):
            return value
        return _Feed(value)

    def _all_feeds(self):
        if self._single is not None:
            return [self._single]
        return self._feeds

    @property
    def is_static(self) -> bool:
        return all(f.fn is None and f.it is None for f in self._all_feeds())

    def _pull(self, feed: _Feed, epoch: int) -> Any:
        if feed.it is not None:
            try:
                return next(feed.it)
            except StopIteration:
                self.exhausted = True
                return None
        if feed.fn is not None:
            return feed.fn(epoch)
        return feed.static

    def __call__(self, epoch: int) -> Any:
        if self._single is not None:
            return self._pull(self._single, epoch)
        values = [self._pull(f, epoch) for f in self._feeds]
        if self.exhausted:
            return None
        if self._container is dict:
            return dict(zip(self._keys, values))
        return self._container(values)

    def snapshot(self) -> Optional[dict]:
        # a single feed keeps the source's raw snapshot format; several
        # feeds wrap theirs in an index-keyed envelope
        feeds = self._all_feeds()
        if self._single is not None:
            src = self._single.source
            live = self._single.fn is not None or self._single.it is not None
            if live and hasattr(src, "snapshot"):
                return src.snapshot()
            return None
        snaps = {}
        for i, feed in enumerate(feeds):
            live = feed.fn is not None or feed.it is not None
            if live and hasattr(feed.source, "snapshot"):
                snaps[str(i)] = feed.source.snapshot()
        return {"__feeds__": snaps} if snaps else None

    def restore(self, snap: dict) -> None:
        if "__feeds__" in snap:
            for i, feed in enumerate(self._all_feeds()):
                sub = snap["__feeds__"].get(str(i))
                if sub is not None and hasattr(feed.source, "restore"):
                    feed.source.restore(sub)
            return
        single = self._single
        if single is not None and hasattr(single.source, "restore"):
            single.source.restore(snap)


def _call_body(body: BodyFn, state, epoch, data) -> IterationBodyResult:
    if data is None:
        return normalize_body_result(body(state, epoch))
    return normalize_body_result(body(state, epoch, data))


def iterate(
    body: BodyFn,
    initial_state: Any,
    data: Any = None,
    *,
    config: Optional[IterationConfig] = None,
    max_epochs: Optional[int] = None,
    steps_per_dispatch: Optional[int] = None,
    listeners: Sequence[IterationListener] = (),
    per_round_init: Optional[Callable[[], Any]] = None,
    per_round: Optional[Sequence[str]] = None,
    workset: Optional[Workset] = None,
    workset_tol: float = 0.0,
    workset_fraction: Optional[Callable[[Workset], Any]] = None,
    checkpoint: Optional[Union[CheckpointConfig, CheckpointManager]] = None,
    resume: bool = False,
) -> IterationResult:
    """Run an iteration (the analog of
    ``Iterations.iterateBoundedStreamsUntilTermination``,
    ``Iterations.java:149-170``).

    ``body(state, epoch[, data]) -> IterationBodyResult | state``; the
    state entering epoch ``e`` produces the state for epoch ``e + 1``.
    ``epoch`` is a Python int.

    Termination: ``max_epochs`` reached, OR the body's ``termination`` vote
    is zero/false, OR an iterator data source is exhausted, OR — workset
    iterations — the active fraction falls to ``workset_tol``.

    ``per_round=``: top-level keys of a dict state re-initialised from
    ``initial_state`` at the start of every epoch while the rest is
    carried (the ``IterationBody.forEachRound`` analog); the result keeps
    the LAST round's values.  ``config.lifecycle=PER_ROUND`` re-initialises
    the whole state every epoch (``per_round_init()``, default the initial
    state).

    Workset iterations (``workset=``): the body is ``body(state, workset,
    epoch[, data])`` and its feedback is ``(new_state, new_workset)``; the
    workset rides the state (and its checkpoints).  Incompatible with
    ``per_round=`` and PER_ROUND.  ``workset_fraction(workset)`` replaces
    :func:`active_fraction` where the workset is one rank's share of a
    data-parallel one: every rank must exit on the group's fraction.

    ``checkpoint`` (a :class:`CheckpointConfig` or
    :class:`CheckpointManager`) cuts ``(state, source cursor, terminated)``
    every ``interval`` epochs (hosted mode); ``resume=True`` restores the
    newest valid cut and continues, bit for bit the uninterrupted run.
    """
    config = config or IterationConfig()
    if max_epochs is not None:
        config = dataclasses.replace(config, max_epochs=max_epochs)
    if steps_per_dispatch is not None:
        config = dataclasses.replace(config,
                                     steps_per_dispatch=steps_per_dispatch)
    if config.max_epochs is not None and config.max_epochs < 0:
        raise ValueError(f"max_epochs must be >= 0, got {config.max_epochs}")

    if per_round:
        if not isinstance(initial_state, dict):
            raise TypeError(
                "per_round= names top-level dict keys; state is "
                f"{type(initial_state).__name__}")
        missing = [k for k in per_round if k not in initial_state]
        if missing:
            raise KeyError(f"per_round keys {missing} not in state "
                           f"{list(initial_state)}")
        reset_subtree = {k: _private_copy(initial_state[k])
                         for k in per_round}
        inner_body = body

        def body(state, epoch, *rest):  # noqa: F811
            # re-entering each epoch at the initial value IS the per-round
            # re-init (a copy: a body may write its state in place)
            return _call_body(inner_body,
                              {**state, **_private_copy(reset_subtree)},
                              epoch, rest[0] if rest else None)

    frac_fn = None
    if workset is not None:
        if not isinstance(workset, Workset):
            raise TypeError(
                f"workset= expects a Workset, got {type(workset).__name__}")
        if per_round or config.lifecycle == OperatorLifeCycle.PER_ROUND:
            raise ValueError(
                "workset iterations are incompatible with per-round "
                "re-initialisation (the workset is cross-round state)")
        ws_body, ws_tol = body, float(workset_tol)
        ws_frac = workset_fraction or active_fraction

        def body(carry, epoch, *rest):  # noqa: F811
            # the workset rides next to the state; continue while active
            # elements remain, AND-ed with any vote of the body
            state, ws = carry
            res = normalize_body_result(ws_body(state, ws, epoch, *rest))
            new_state, new_ws = res.feedback
            cont = ws_frac(new_ws) > ws_tol
            if res.termination is not None:
                cont = torch.logical_and(
                    cont, torch.as_tensor(res.termination,
                                          device=cont.device)
                    .bool().reshape(()))
            return IterationBodyResult((new_state, new_ws), res.outputs, cont)

        initial_state = (initial_state, workset)
        frac_fn = lambda carry: ws_frac(carry[1])  # noqa: E731

    provider = _DataProvider(data)
    # the whole-state PER_ROUND lifecycle flag (not the per_round= keys)
    per_round_lifecycle = config.lifecycle == OperatorLifeCycle.PER_ROUND
    if per_round_lifecycle and per_round_init is None:
        init_copy = initial_state
        per_round_init = lambda: _private_copy(init_copy)  # noqa: E731

    first = None
    mode = config.mode
    if mode == "auto":
        fusible = (provider.is_static and not listeners and checkpoint is None
                   and not per_round_lifecycle and config.jit
                   and config.max_epochs is not None)
        if fusible and config.max_epochs > 0:
            # criteria-driven fused loops keep only the LAST epoch's
            # outputs, so auto keeps hosted semantics where a vote exists —
            # except for a workset body without outputs (nothing to lose)
            first = _call_body(body, initial_state, 0, provider(0))
            fusible = (first.termination is None
                       or (workset is not None and first.outputs is None))
        mode = "fused" if fusible else "hosted"

    if mode == "fused":
        result = _iterate_fused(body, initial_state, provider, config,
                                frac_fn=frac_fn, first=first)
    else:
        result = _iterate_hosted(body, initial_state, provider, config,
                                 listeners, per_round_lifecycle,
                                 per_round_init, checkpoint, resume,
                                 frac_fn=frac_fn, first=first)
    if workset is not None:
        final_state, final_ws = result.state
        result = dataclasses.replace(result, state=final_state,
                                     workset=final_ws)
    return result


def _stack(outputs: list) -> Any:
    """Per-epoch outputs stacked along a new leading axis (the fused
    scan's stacking)."""
    first = outputs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outputs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([o[i] for o in outputs])
                           for i in range(len(first)))
    return torch.stack([torch.as_tensor(o) for o in outputs])


# ---------------------------------------------------------------------------
# fused: no listeners, checkpoints or per-epoch data
# ---------------------------------------------------------------------------

def _iterate_fused(body: BodyFn, state, provider: _DataProvider,
                   config: IterationConfig, *,
                   frac_fn: Optional[Callable[[Any], Any]] = None,
                   first: Optional[IterationBodyResult] = None
                   ) -> IterationResult:
    if not provider.is_static:
        raise ValueError("fused mode requires device-resident (static) data")
    if config.max_epochs is None:
        raise ValueError("fused mode requires max_epochs")
    data = provider(0)
    outputs, side = [], {}
    num_epochs = 0
    fracs, votes = [], []
    warned = False
    # an "iterate.epoch" span around each body call, timed on the state's
    # device (the recording test read once a loop)
    span = tracer.recorder()
    dev = None if span is null_span else _first_device(state)
    for epoch in range(config.max_epochs):
        if epoch == 0 and first is not None:
            res = first
        else:
            with span("iterate.epoch", cat="train", device=dev, epoch=epoch):
                res = _call_body(body, state, epoch, data)
        state = res.feedback
        num_epochs = epoch + 1
        if res.termination is None:
            outputs.append(res.outputs)
            continue
        if res.outputs is not None and not warned:
            warned = True
            warnings.warn(
                "fused iteration with a termination criterion keeps only "
                "the LAST epoch's outputs; use mode='hosted' to keep the "
                "full per-epoch output log", stacklevel=3)
        vote = torch.as_tensor(res.termination).reshape(())
        votes.append(vote.to(torch.float32))
        fracs.append(frac_fn(state) if frac_fn is not None
                     else torch.full((), float("nan"), device=vote.device))
        outputs = [res.outputs]
        if not bool(vote):        # the loop's one host read per epoch
            break
    if votes:
        side["epoch_trace"] = {
            "active_fraction": torch.stack(fracs).cpu().numpy().astype(
                np.float32),
            "termination": torch.stack(votes).cpu().numpy()}
        out = outputs[0] if outputs else None
    elif all(o is None for o in outputs):
        out = None
    else:
        out = _stack(outputs)
    return IterationResult(state, out, num_epochs, side)


# ---------------------------------------------------------------------------
# hosted: listeners, per-epoch data, PER_ROUND, checkpoints
# ---------------------------------------------------------------------------

def _iterate_hosted(body: BodyFn, initial_state, provider: _DataProvider,
                    config: IterationConfig,
                    listeners: Sequence[IterationListener],
                    per_round_lifecycle: bool, per_round_init,
                    checkpoint, resume: bool, *,
                    frac_fn: Optional[Callable[[Any], Any]] = None,
                    first: Optional[IterationBodyResult] = None
                    ) -> IterationResult:
    pending_first = [first]

    def step(state, epoch, data):
        if epoch == 0 and pending_first[0] is not None:
            res, pending_first[0] = pending_first[0], None
            return res
        return _call_body(body, state, epoch, data)

    # chunked stepping (steps_per_dispatch=W > 1): one host read of the
    # vote per W epochs; per-epoch sources and PER_ROUND bodies keep the
    # per-epoch loop (the host pulls or re-initialises between epochs)
    W = config.steps_per_dispatch
    chunked = (W > 1 and config.jit and provider.is_static
               and not per_round_lifecycle)

    manager: Optional[CheckpointManager] = None
    if isinstance(checkpoint, CheckpointManager):
        manager = checkpoint
    elif isinstance(checkpoint, CheckpointConfig):
        manager = CheckpointManager(checkpoint)

    # does any listener consume the checkpoint hook?  Only then must an
    # async save land before the hook fires (its contract is durability)
    wants_ckpt_hook = any(
        type(lst).on_checkpoint_saved
        is not IterationListener.on_checkpoint_saved
        for lst in listeners)

    state = initial_state
    start_epoch = 0
    resumed_terminated = False
    if manager is not None and resume:
        restored = manager.restore_latest()
        if restored is not None:
            start_epoch, saved, meta = restored
            state = _to_device(saved, _first_device(initial_state))
            pending_first[0] = None
            resumed_terminated = bool(meta.get("terminated"))
            snap = meta.get("source_snapshot")
            if snap:
                provider.restore(snap)
    if resumed_terminated:
        # the checkpointed run had already voted to terminate at this
        # epoch: re-running the body would diverge from it
        ctx = EpochContext(epoch=start_epoch, state=state, terminated=True)
        for listener in listeners:
            listener.on_iteration_terminated(ctx)
        return IterationResult(state, [], start_epoch,
                               {"termination_reason": "criteria"})

    def cut(epoch: int, stop: bool, ctx: EpochContext, hook_epoch: int):
        # the vote travels with the checkpoint: resuming from a cut of a
        # terminated run must not re-run the body
        extra = {"terminated": stop}
        snap = provider.snapshot()
        if snap:
            extra["source_snapshot"] = snap
        if getattr(manager.config, "async_save", False):
            manager.save_async(epoch, state, extra)
            if wants_ckpt_hook:
                manager.wait()   # the hook promises durability
        else:
            manager.save(epoch, state, extra)
        if wants_ckpt_hook:
            for listener in listeners:
                listener.on_checkpoint_saved(hook_epoch, ctx)

    outputs_log = []
    side: dict = {}
    # per-epoch convergence curves (per-epoch stepping only): device
    # scalars collected without a host read, fetched once at the end
    trace_frac: list = []
    trace_term: list = []
    epoch = start_epoch
    terminated_reason = "max_epochs"
    from ..robustness.faults import fault_point

    try:
        while config.max_epochs is None or epoch < config.max_epochs:
            # fault seam: lets a FaultPlan kill a hosted iteration at a
            # chosen epoch even when the data is static
            fault_point("iterate.epoch")
            epoch_data = provider(epoch)
            if provider.exhausted:
                terminated_reason = "stream_end"
                break
            if chunked:
                w = (W if config.max_epochs is None
                     else min(W, config.max_epochs - epoch))
                alive: Any = True
                ran, outs = [], []
                for i in range(w):
                    res = step(state, epoch + i, epoch_data)
                    ran.append(alive)
                    outs.append(res.outputs)
                    state = _freeze(alive, res.feedback, state)
                    if res.termination is not None:
                        vote = torch.as_tensor(res.termination).bool() \
                            .reshape(())
                        alive = vote if alive is True \
                            else torch.logical_and(alive, vote)
                # ONE host read per chunk: which epochs ran, and whether
                # the vote says continue
                flags = [f for f in ran + [alive] if f is not True]
                host = (torch.stack(flags).cpu().numpy().tolist()
                        if flags else [])
                host = iter(host)
                ran_h = [True if f is True else bool(next(host)) for f in ran]
                alive_h = True if alive is True else bool(next(host))
                n_run = sum(ran_h)
                last_outputs = None
                for i in range(w):
                    if ran_h[i] and outs[i] is not None:
                        last_outputs = outs[i]
                        outputs_log.append(last_outputs)
                epoch += n_run
                ctx = EpochContext(epoch=epoch - 1, state=state,
                                   outputs=last_outputs, side=side)
                for listener in listeners:
                    listener.on_epoch_watermark_incremented(epoch - 1, ctx)
                stop = not alive_h
                if manager is not None and (
                        stop or any(manager.should_save(e) for e in
                                    range(epoch - n_run + 1, epoch + 1))):
                    cut(epoch, stop, ctx, epoch - 1)
                if stop:
                    terminated_reason = "criteria"
                    break
                continue
            if per_round_lifecycle and epoch > start_epoch:
                state = per_round_init()
            res = step(state, epoch, epoch_data)
            state = res.feedback
            if res.outputs is not None:
                outputs_log.append(res.outputs)
            if frac_fn is not None:
                trace_frac.append(frac_fn(state))
                trace_term.append(res.termination)

            ctx = EpochContext(epoch=epoch, state=state, outputs=res.outputs,
                               side=side)
            for listener in listeners:
                listener.on_epoch_watermark_incremented(epoch, ctx)

            epoch += 1
            stop = (res.termination is not None
                    and not bool(torch.as_tensor(res.termination)))
            if manager is not None and (manager.should_save(epoch) or stop):
                cut(epoch, stop, ctx, epoch - 1)
            if stop:
                terminated_reason = "criteria"
                break
    except BaseException:
        # land any in-flight async save so the newest checkpoint is not
        # torn by interpreter exit; the loop's own exception is the one
        # the caller must see
        if manager is not None:
            try:
                manager.wait()
            except Exception:
                pass
        raise

    if manager is not None:
        manager.wait()

    final_ctx = EpochContext(epoch=epoch, state=state, terminated=True,
                             side=side)
    for listener in listeners:
        listener.on_iteration_terminated(final_ctx)

    side["termination_reason"] = terminated_reason
    if trace_frac:
        side["epoch_trace"] = {
            "active_fraction": torch.stack(
                [torch.as_tensor(f, dtype=torch.float32) for f in trace_frac]
            ).cpu().numpy(),
            "termination": torch.stack(
                [torch.as_tensor(t).to(torch.float32) for t in trace_term]
            ).cpu().numpy(),
        }
    return IterationResult(state, outputs_log, epoch, side)
