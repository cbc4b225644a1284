"""Host->device prefetch: the feed that keeps the card from waiting on IO.

``prefetch_to_device`` wraps any host-batch iterator with a bounded
pipeline: a reader thread pulls host batches (hitting the data cache's
fadvise readahead, ``data/datacache.py``), ``workers`` threads run the
decode ``transform`` (ordered reassembly: results stay in source order),
and ``put_workers`` threads move each unit of work to the device, parking
it in a depth-bounded queue.  The bound is the backpressure: the reader
never runs more than ``depth + in-flight transforms`` units ahead of the
consumer, so host RAM stays flat on out-of-core epochs.

The transfer, on a CUDA device:

1. the unit's numpy leaves are copied into **pinned host staging** (a
   pool of ``depth + put_workers + 2`` slots, reused);
2. a ``copy_(non_blocking=True)`` per leaf runs on a **dedicated copy
   stream**, and an event is recorded there after the last one;
3. the consumer's stream **waits on that event** when the unit is handed
   out (no host sync), and each device tensor is marked
   ``record_stream(consumer stream)``, so the caching allocator does not
   reuse its memory while the consumer's work may still read it;
4. a staging slot goes back to the pool with an event recorded on the
   consumer's stream when the NEXT unit is handed out: the slot is
   refilled only after that event, i.e. after the consumer's work on the
   unit's copy (and so the copy itself) is done.

On a CPU device the unit's leaves are copied into fresh CPU tensors (no
pinned staging, no streams).  A CUDA device that is asked for and not present
raises, as ``utils/device.py`` does: there is no CPU fallback.

``stats`` (a :class:`PrefetchStats`) attributes the pipeline's time:
seconds reading host batches, transforming, in the transfer (staging
copy + copy launches), and how long the CONSUMER sat waiting on an empty
queue (the infeed gap: ~0 means the device is the bottleneck, not the
ingest).

``chunks=W`` turns the unit of work from one batch into a CHUNK of ``W``
consecutive batches stacked along a new leading axis: the consumer runs
``W`` optimizer steps per chunk, and the transfer of chunk N+1 still
overlaps compute on chunk N.  The final short chunk pads by repeating
its last batch; the per-chunk validity mask (1.0 for real batches) and
the host count ``n_valid`` mark the pad steps, which
:func:`masked_chunk_scan` skips.  Chunk mode yields ``(chunk, mask,
n_valid)`` triples.  The chunk is stacked straight into the pinned
staging slot (one host copy), by the put worker.

Placement over a mesh: the port runs one rank a device, so a rank's
batches and chunks are its own rows and go whole to its own device
(``sharding=`` a mesh; :func:`chunk_consumer_plan` over a mesh names the
rank's device).

A port of the JAX package's ``data/prefetch.py``; its metric-group gauges
are not ported.
"""

from __future__ import annotations

import queue
import threading
import time

from concurrent import futures

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["prefetch_to_device", "PrefetchStats", "masked_chunk_scan",
           "chunk_consumer_plan"]

_END = object()


def _placement(mesh) -> Optional[torch.device]:
    """The device a mesh places this rank's units on (None without a
    mesh)."""
    if mesh is None:
        return None
    if not hasattr(mesh, "axis_names"):
        raise TypeError("sharding= takes a parallel.mesh.Mesh (this rank's "
                        f"device), got {type(mesh).__name__}")
    if mesh.device is None:
        raise ValueError(f"{mesh!r} names no device for this rank")
    return resolve_device(mesh.device)


@dataclass
class PrefetchStats:
    """Cumulative pipeline timing (seconds) and batch count.  Single
    writer per field (each stage runs on one thread; transform and put
    workers accumulate under the lock).

    In ``chunks=W`` mode ``assemble_s`` is the stacking of a chunk into its
    staging slot (inside ``put_s``), ``put_s``/``wait_s`` are per-CHUNK
    transfer/wait time, and ``chunks`` counts dispatched chunks
    (``batches`` keeps counting real batches)."""
    read_s: float = 0.0        # source iterator next()
    transform_s: float = 0.0   # decode/pad (sum over workers)
    put_s: float = 0.0         # staging copy + copy launches
    wait_s: float = 0.0        # consumer blocked on empty queue
    batches: int = 0
    assemble_s: float = 0.0    # chunk stack/pad (within put_s)
    chunks: int = 0
    chunk_size: Optional[int] = None   # W in chunks=W mode, else None
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def pad_fraction(self) -> float:
        """Fraction of dispatched chunk slots that were padding:
        ``(chunks*W - batches) / (chunks*W)``.  0.0 outside chunk mode or
        before any chunk."""
        if not self.chunks or not self.chunk_size:
            return 0.0
        slots = self.chunks * self.chunk_size
        return (slots - self.batches) / slots

    def as_dict(self) -> dict:
        d = {"read_s": round(self.read_s, 4),
             "transform_s": round(self.transform_s, 4),
             "put_s": round(self.put_s, 4),
             "consumer_wait_s": round(self.wait_s, 4),
             "batches": self.batches}
        if self.chunks:
            d["chunk_assemble_s"] = round(self.assemble_s, 4)
            d["chunks"] = self.chunks
            d["pad_fraction"] = round(self.pad_fraction(), 4)
        return d

    def publish(self, group) -> None:
        """Write the current stats into a ``utils.metrics.MetricGroup`` as
        gauges (names of :meth:`as_dict`, with ``chunks_emitted`` and
        ``put_overlap_s`` for the per-chunk view); safe to call
        repeatedly: gauges are overwritten in place."""
        group.gauge("read_s").set(round(self.read_s, 4))
        group.gauge("transform_s").set(round(self.transform_s, 4))
        group.gauge("put_overlap_s").set(round(self.put_s, 4))
        group.gauge("consumer_wait_s").set(round(self.wait_s, 4))
        group.gauge("batches").set(self.batches)
        group.gauge("chunks_emitted").set(self.chunks)
        group.gauge("pad_fraction").set(round(self.pad_fraction(), 4))
        group.gauge("chunk_assemble_s").set(round(self.assemble_s, 4))


def _grouped(batches: Iterable[Any], size: int) -> Iterator[list]:
    """Consecutive ``size``-item groups of ``batches`` (final group
    short).  A mid-group source error propagates immediately — items
    already read in the broken group are dropped, which keeps the error
    in stream order from the consumer's point of view."""
    group: list = []
    for item in batches:
        group.append(item)
        if len(group) == size:
            yield group
            group = []
    if group:
        yield group


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree: Any, it: Iterator[Any]) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


class _Staging:
    """The pinned staging pool of one pipeline: slots of host tensors
    matching a unit's leaves (reallocated where a shape changes), handed
    out to put workers and returned with the consumer-side event after
    which they may be refilled.

    Slots are handed out in stream order (unit ``seq`` waits for every
    earlier unit to take or skip its turn): the unit the consumer needs
    next always holds a slot, so a bounded pool cannot deadlock behind
    units that ran ahead."""

    def __init__(self, slots: int, abort: Callable[[], bool]):
        self._free: list = [([], None) for _ in range(slots)]
        self._cv = threading.Condition()
        self._turn = 0
        self._abort = abort

    def acquire(self, seq: int, take: bool = True):
        """Unit ``seq``'s slot (None when the pipeline stops); with
        ``take=False`` only pass the turn on (a unit that failed)."""
        with self._cv:
            while not self._abort() and (
                    self._turn != seq or (take and not self._free)):
                self._cv.wait(0.1)
            if self._abort():
                return None
            self._turn += 1
            self._cv.notify_all()
            if not take:
                return None
            bufs, ready = self._free.pop(0)
        if ready is not None:
            ready.synchronize()   # the consumer's work on it is done
        return bufs

    def release(self, bufs, ready) -> None:
        with self._cv:
            self._free.append((bufs, ready))
            self._cv.notify_all()


def _fit_bufs(bufs: list, shapes: list, pin: bool) -> list:
    """``bufs`` resized in place to host tensors of ``shapes`` (pinned
    when ``pin``); a buffer whose shape and dtype match is kept."""
    del bufs[len(shapes):]
    for i, (shape, dtype) in enumerate(shapes):
        if i < len(bufs) and tuple(bufs[i].shape) == shape \
                and bufs[i].dtype == dtype:
            continue
        buf = torch.empty(shape, dtype=dtype, pin_memory=pin)
        if i < len(bufs):
            bufs[i] = buf
        else:
            bufs.append(buf)
    return bufs


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), a.dtype)).dtype


def masked_chunk_scan(step: Callable, state: Any, loss_sum, chunk, mask,
                      probe=None, *, n_valid: Optional[int] = None):
    """THE consumer half of ``chunks=W``: run ``step(state, *batch) ->
    (new_state, loss)`` over the live batches of ``chunk`` (its leaves
    stacked along a leading axis of W) and add each live step's loss to
    ``loss_sum``.  Dead (padded) steps are skipped: in the JAX package's
    scan they run and are discarded, an exact no-op, so skipping them
    gives the same result and any two W values agree bit for bit.

    ``n_valid`` is the host count of live steps (the prefetch triple's
    third element); without it the ``mask`` is read on the host.
    ``probe`` (a :class:`~flink_ml_tpu_torch.obs.StepProbe`) records each
    live step's ``loss``.  Returns ``(state, loss_sum)``, or ``(state,
    loss_sum, probe)`` with a probe."""
    if n_valid is None:
        n_valid = int(torch.as_tensor(mask).gt(0).sum())
    for i in range(n_valid):
        state, loss = step(state, *(leaf[i] for leaf in chunk))
        loss_sum = loss if loss_sum is None else loss_sum + loss
        if probe is not None:
            probe = probe.record(loss=loss)
    if probe is None:
        return state, loss_sum
    return state, loss_sum, probe


def chunk_consumer_plan(mesh, specs, W: int, prefetch_depth: int):
    """``(sharding, depth)`` for ``chunks=W`` prefetch.  ``sharding`` is
    where a rank's chunk goes: over a mesh (a rank of a process group,
    one device a rank) the rank's device, whole, since the chunk holds
    just its own rows (``specs``, the JAX package's partition specs, place
    nothing more); None without a mesh.  ``depth`` converts the caller's
    per-batch ``prefetch_depth`` into chunks (``ceil(prefetch_depth /
    W)``, at least one)."""
    return _placement(mesh), max(1, -(-prefetch_depth // W))


def prefetch_to_device(batches: Iterable[Any], *, depth: int = 2,
                       device: Any = "cuda",
                       sharding: Optional[Any] = None,
                       transform: Optional[Callable[[Any], Any]] = None,
                       workers: int = 1,
                       put_workers: int = 1,
                       stats: Optional[PrefetchStats] = None,
                       put_fn: Optional[Callable[[Any, Any], Any]] = None,
                       chunks: Optional[int] = None,
                       metric_group: Optional[Any] = None,
                       retry_policy: Optional[Any] = None
                       ) -> Iterator[Any]:
    """Iterate ``device`` copies of ``batches`` (trees of numpy arrays:
    dicts, tuples, lists), staying ``depth`` UNITS OF WORK ahead of the
    consumer — a unit is one batch, or one ``chunks=W``-batch chunk.

    ``transform`` runs on ``workers`` background threads before the
    transfer (decode/pad/astype); results are reassembled in source
    order, so worker count never changes what the consumer sees.
    ``put_workers`` threads stage and launch the transfers, also
    reassembled in source order.  Exceptions raised by the source, the
    transform or the transfer are re-raised at the consuming ``next()``,
    in stream order (every earlier unit is delivered first).

    ``put_fn(batch, device)`` overrides the transfer of a per-batch unit
    (not with ``chunks``).  ``sharding`` (a mesh) places every unit on
    this rank's device of the mesh in place of ``device``.

    ``chunks=W`` (an int >= 1; default None = per-batch yields) groups
    every ``W`` consecutive transformed batches into one stacked chunk
    and yields ``(chunk, mask, n_valid)``: ``chunk`` the stacked device
    tree, ``mask`` a device ``(W,)`` f32, ``n_valid`` the host count of
    real batches.  ``chunks=1`` keeps one batch per chunk in the triple
    form, so a ``W=1`` consumer runs the same loop as ``W>1``.

    ``retry_policy`` (a ``robustness.retry.RetryPolicy``) retries the
    SOURCE pull on classified-transient errors with exponential backoff:
    ``batches`` is wrapped in a ``RetryingIterator`` at the raw-source
    level (below the chunk grouping), so object-shaped sources retry in
    place and cursor-backed generator sources re-iterate at their cursor;
    a bare generator that dies on a transient fails loudly
    (``StreamRetryUnsupported``) rather than truncating silently.

    ``metric_group`` (a ``utils.metrics.MetricGroup``) receives the stats
    as gauges (:meth:`PrefetchStats.publish`) after every unit and at
    close.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if put_workers < 1:
        raise ValueError(f"put_workers must be >= 1, got {put_workers}")
    if chunks is not None and chunks < 1:
        raise ValueError(f"chunks must be >= 1 (or None), got {chunks}")
    if chunks is not None and put_fn is not None:
        raise ValueError("chunks= does not compose with put_fn (a per-batch "
                         "transfer override)")
    dev = _placement(sharding) or resolve_device(device)
    cuda = dev.type == "cuda"
    st = stats or PrefetchStats()
    if chunks is not None:
        st.chunk_size = chunks
    if retry_policy is not None:
        # wrap the RAW source, below the chunk grouping: retrying above a
        # generator adapter would read StopIteration off its dead frame
        # and silently truncate
        from ..robustness.retry import RetryingIterator

        batches = RetryingIterator(batches, retry_policy)

    if chunks is not None:
        item_transform = transform
        batches = _grouped(batches, chunks)

        def transform(group):  # noqa: F811 — chunk-mode transform
            return ([item_transform(b) for b in group]
                    if item_transform is not None else list(group))

    stop = threading.Event()
    failed = threading.Event()   # an in-stream error reached the consumer
    staging = (_Staging(depth + put_workers + 2,
                        lambda: stop.is_set() or failed.is_set())
               if cuda and put_fn is None else None)
    copy_stream = torch.cuda.Stream(device=dev) if cuda else None

    def stage(unit, seq):
        """The unit's host tensors (the tree skeleton and its leaves in a
        staging slot, or fresh CPU tensors) and, for a chunk, its mask
        and live count; None when the pipeline stopped."""
        if cuda:
            bufs = staging.acquire(seq)
            if bufs is None:
                return None
        if chunks is not None:
            items = unit
            n_valid = len(items)
            skeleton = items[0]
            per_item = [_leaves(it) for it in items]
            shapes = [((chunks,) + np.shape(a), _torch_dtype(np.asarray(a)))
                      for a in per_item[0]]
        else:
            skeleton = unit
            per_item = [_leaves(unit)]
            shapes = [(np.shape(a), _torch_dtype(np.asarray(a)))
                      for a in per_item[0]]
        if cuda:
            _fit_bufs(bufs, shapes, pin=True)
        else:
            bufs = _fit_bufs([], shapes, pin=False)
        t0 = time.perf_counter()
        if chunks is not None:
            for j, buf in enumerate(bufs):
                host = buf.numpy()
                for k in range(chunks):
                    src = per_item[min(k, n_valid - 1)][j]
                    np.copyto(host[k], np.asarray(src), casting="no")
            mask = np.zeros((chunks,), np.float32)
            mask[:n_valid] = 1.0
            with st._lock:
                st.assemble_s += time.perf_counter() - t0
                st.chunks += 1
            return skeleton, bufs, mask, n_valid
        for buf, a in zip(bufs, per_item[0]):
            np.copyto(buf.numpy(), np.asarray(a), casting="no")
        return skeleton, bufs, None, None

    def put(unit, seq):
        if put_fn is not None:
            return (put_fn(unit, dev), None, None)
        staged = stage(unit, seq)
        if staged is None:
            return _END
        skeleton, bufs, mask, n_valid = staged
        if cuda:
            with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
                moved = [b.to(dev, non_blocking=True) for b in bufs]
                if mask is not None:
                    moved_mask = torch.from_numpy(mask).to(dev,
                                                           non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
        else:
            moved, ready = bufs, None
            moved_mask = torch.from_numpy(mask) if mask is not None else None
        tree = _rebuild(skeleton, iter(moved))
        if chunks is not None:
            tree = (tree, moved_mask, n_valid)
        # the staging slot rides with the unit until the consumer is done
        return (tree, ready, bufs if cuda else None)

    q: queue.Queue = queue.Queue(maxsize=depth)

    def put_or_abandon(dst: queue.Queue, item) -> None:
        """Stop-aware put: never parks forever if the consumer walked away
        (an untimed put here would leak the thread and its buffers)."""
        while not stop.is_set():
            try:
                dst.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def timed_transform(batch):
        t0 = time.perf_counter()
        out = transform(batch) if transform is not None else batch
        with st._lock:
            st.transform_s += time.perf_counter() - t0
        return out

    def timed_put(batch, seq):
        t0 = time.perf_counter()
        out = put(batch, seq)
        with st._lock:
            st.put_s += time.perf_counter() - t0
        return out

    pool = None
    if workers == 1 and put_workers == 1:
        def worker():
            seq = 0
            try:
                src = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                    st.read_s += time.perf_counter() - t0
                    if stop.is_set():
                        return
                    entry = timed_put(timed_transform(batch), seq)
                    seq += 1
                    if entry is _END:
                        return
                    put_or_abandon(q, entry)
                put_or_abandon(q, _END)
            except BaseException as exc:  # noqa: BLE001 — raised at consumer
                put_or_abandon(q, exc)

        threads = [threading.Thread(target=worker, daemon=True,
                                    name="flink-ml-torch-prefetch")]
    else:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="flink-ml-torch-decode")
        fq: queue.Queue = queue.Queue(maxsize=depth + workers + put_workers)
        # ordered reassembly shared by the putters: seq -> device unit,
        # flushed to q in source order as the prefix completes
        flush_lock = threading.Lock()
        pending: dict = {}
        flush_state = {"next": 0, "total": None, "finished": False,
                       "draining": False}
        # `failed` latches once an in-stream error entry is FLUSHED: the
        # consumer raises at that seq, so later transfers are waste

        def _collect_ready_locked() -> list:
            """Pop the completed prefix (appending the terminal _END once
            the reader's total is known and reached).  Caller holds
            flush_lock; the blocking puts run outside it."""
            ready: list = []
            while flush_state["next"] in pending:
                entry = pending.pop(flush_state["next"])
                if isinstance(entry, BaseException):
                    failed.set()
                ready.append(entry)
                flush_state["next"] += 1
            if (flush_state["total"] is not None
                    and flush_state["next"] >= flush_state["total"]
                    and not flush_state["finished"]):
                flush_state["finished"] = True
                ready.append(_END)
            return ready

        def _flush_ready():
            """Emit every ready entry to q in source order.  Exactly one
            thread drains at a time: a second completer registers its
            entry and leaves, and the active drainer re-collects after
            each emit round, so nothing is stranded."""
            flush_lock.acquire()
            try:
                if flush_state["draining"]:
                    return
                flush_state["draining"] = True
                try:
                    while True:
                        ready = _collect_ready_locked()
                        if not ready:
                            return
                        flush_lock.release()
                        try:
                            for entry in ready:
                                put_or_abandon(q, entry)
                        finally:
                            flush_lock.acquire()
                finally:
                    flush_state["draining"] = False
            finally:
                flush_lock.release()

        def reader():
            seq = 0
            try:
                src = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                    st.read_s += time.perf_counter() - t0
                    if stop.is_set():
                        return
                    if failed.is_set():
                        break   # consumer will raise; stop reading ahead
                    put_or_abandon(
                        fq, (seq, pool.submit(timed_transform, batch)))
                    seq += 1
                with flush_lock:
                    flush_state["total"] = seq
                _flush_ready()   # covers the empty stream
            except BaseException as exc:  # noqa: BLE001
                # deliver the error IN STREAM ORDER: it enters the
                # reassembly at the next seq, so every unit already read
                # reaches the consumer first
                with flush_lock:
                    pending[seq] = exc
                    flush_state["total"] = seq + 1
                _flush_ready()
            for _ in range(put_workers):
                put_or_abandon(fq, _END)

        def get_or_abandon(src: queue.Queue):
            """Stop-aware get: the putter exits when the consumer walks
            away."""
            while not stop.is_set():
                try:
                    return src.get(timeout=0.1)
                except queue.Empty:
                    continue
            return _END

        def putter():
            while True:
                if failed.is_set():
                    return
                item = get_or_abandon(fq)
                if item is _END:
                    return
                seq, fut = item
                # stop-aware future wait: poll done-ness rather than catch
                # TimeoutError from result(), so a transform failing with
                # a timeout error still propagates
                while not stop.is_set() and not failed.is_set() \
                        and not fut.done():
                    futures.wait([fut], timeout=0.1)
                if stop.is_set() or failed.is_set():
                    fut.cancel()
                    return
                try:
                    batch = fut.result()
                except BaseException as exc:  # noqa: BLE001
                    # transform errors ride the reassembly at their own
                    # seq (every earlier unit is delivered first) and pass
                    # their staging turn on
                    if staging is not None:
                        staging.acquire(seq, take=False)
                    entry = exc
                else:
                    if failed.is_set():
                        return
                    try:
                        entry = timed_put(batch, seq)
                    except BaseException as exc:  # noqa: BLE001
                        entry = exc
                    if entry is _END:
                        return
                with flush_lock:
                    pending[seq] = entry
                _flush_ready()
                if isinstance(entry, BaseException):
                    return

        threads = [threading.Thread(target=reader, daemon=True,
                                    name="flink-ml-torch-prefetch-read")]
        threads += [threading.Thread(target=putter, daemon=True,
                                     name=f"flink-ml-torch-prefetch-put-{i}")
                    for i in range(put_workers)]

    for t in threads:
        t.start()
    held = None   # the staging slot of the unit the consumer holds
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            st.wait_s += time.perf_counter() - t0
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            tree, ready, bufs = item
            if cuda:
                consumer = torch.cuda.current_stream(dev)
                if ready is not None:
                    consumer.wait_event(ready)
                for leaf in _leaves(tree):
                    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                        leaf.record_stream(consumer)
                if held is not None:
                    # the previous unit's slot is free once the consumer's
                    # work enqueued so far (all of it on that unit) is done
                    done = torch.cuda.Event()
                    done.record(consumer)
                    staging.release(held, done)
                held = bufs
            st.batches += tree[2] if chunks is not None else 1
            if metric_group is not None:
                st.publish(metric_group)
            yield tree
    finally:
        stop.set()
        # quiesce the pipeline threads before returning control: a live
        # reader still holds the SOURCE iterator, and a supervised fit
        # (robustness.resilient_fit) re-attempts over the same source
        for t in threads:
            t.join(timeout=5.0)
            if t.is_alive():
                import logging

                logging.getLogger("flink_ml_tpu_torch.robustness").warning(
                    "prefetch thread %s still alive after close "
                    "(blocked in a live-source pull?); it will exit at "
                    "its next stop check", t.name)
        if metric_group is not None:
            st.publish(metric_group)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
