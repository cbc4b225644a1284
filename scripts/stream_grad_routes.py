#!/usr/bin/env python3
"""The fixed-order gradient sums of the streamed fits, timed on the card.

    python3 scripts/stream_grad_routes.py

The streamed Wide&Deep fit must sum each table row's gradient in one fixed
order (W, resume and reruns give the same bits).  Two ways, at the bench
width (``bench.py:1094-1112``: 26 fields x 40329 vocab, embedding 64,
batch 8192, numpy seed 17):

(i)  ``fixed``: the gather's backward is ``sgd._scatter_add_`` (on the
     card the sort-based ``index_put_(accumulate=True)``),
     what ``WideDeep.fit_outofcore`` runs (``widedeep._FixedOrderRows``);
(ii) ``sort_fold``: a per-batch route built on the card (a stable sort of
     the batch's ids, its run starts and longest run read to the host),
     the fold kernel over the sorted rows (``ops.emb_grad.fold_runs``,
     B7) and the gather placement (:class:`SortFoldRows` below).

Beside them ``index_add_`` (autograd's own backward: atomics, no fixed
order).  Prints the table-gradient ms of each at E 64 (the embedding
table) and E 1 (the wide table), a whole streamed dense-Adam step (W 8
over device-resident batches) through (i) and (ii), and the FTRL
gradient scatter at ``bench_online_ftrl``'s shape (``bench.py:1459-1472``:
d 2^20, a window of 2^12 rows x 39 slots, seed 13) fixed order against
``index_add_``, with the whole sparse FTRL step through each; every number
beside the card's name and power limit.  Device times are CUDA events over
repeated calls after a warm-up.  Last, ``WideDeep.fit_outofcore`` itself
(16 bench-width batches from a data cache under the gitignored
``scratch_stream/``, 1 epoch, W 8, dense and lazy Adam) once warm, then
under ``torch.profiler``: the fit's wall time a step, the summed kernel
time, the device's busy share and the ops with the most device and host
time.  Needs one NVIDIA GPU.
"""

import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WD_FIELDS, WD_VOCAB, WD_EMB = 26, (1 << 20) // 26, 64
WD_HIDDEN, WD_BATCH, WD_DENSE = (1024, 512, 256), 8192, 13
FTRL_D, FTRL_ROWS, FTRL_SLOTS = 1 << 20, 1 << 12, 39


def sort_fold_table_grad(g_rows: torch.Tensor, ids: torch.Tensor,
                         num_rows: int) -> torch.Tensor:
    """Route (ii): the dense ``(num_rows, ...)`` gradient of ``table[ids]``
    from the per-slot rows ``g_rows``, through a route built on the
    device (two host reads: the run starts and the longest run)."""
    from flink_ml_tpu_torch.ops.emb_grad import routed_table_grad_gather

    sid, order = torch.sort(ids.to(torch.int32), stable=True)
    S = sid.numel()
    start = torch.ones(S, dtype=torch.bool, device=sid.device)
    start[1:] = sid[1:] != sid[:-1]
    pos = torch.nonzero(start).squeeze(1)
    runs = torch.diff(torch.cat([pos, pos.new_tensor([S])]))
    longest = int(runs.max())
    passes = math.ceil(math.log2(longest)) if longest > 1 else 0
    pos_map = torch.full((num_rows,), S, dtype=torch.int32,
                         device=sid.device)
    pos_map[sid[pos].long()] = pos.to(torch.int32)
    return routed_table_grad_gather(g_rows, order.to(torch.int32), sid,
                                    pos_map, fold_passes=passes)


class SortFoldRows(torch.autograd.Function):
    """``table[ids]`` whose backward is :func:`sort_fold_table_grad`: the
    drop-in for ``widedeep._FixedOrderRows`` on route (ii)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = table.shape[0]
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, grad_rows):
        (ids,) = ctx.saved_tensors
        return sort_fold_table_grad(grad_rows.contiguous(), ids,
                                    ctx.num_rows), None


def fixed_table_grad(g_rows, ids, num_rows):
    """Route (i): the backward of ``widedeep._FixedOrderRows``."""
    from flink_ml_tpu_torch.models.common.sgd import _scatter_add_

    return _scatter_add_(g_rows.new_zeros((num_rows,) + g_rows.shape[1:]),
                         ids, g_rows)


def index_add_table_grad(g_rows, ids, num_rows):
    return g_rows.new_zeros((num_rows,) + g_rows.shape[1:]).index_add_(
        0, ids, g_rows)


ROUTES = {"fixed": fixed_table_grad, "sort_fold": sort_fold_table_grad,
          "index_add_": index_add_table_grad}


def widedeep_batches(steps, batch=WD_BATCH, fields=WD_FIELDS,
                     vocab=WD_VOCAB, d_dense=WD_DENSE, seed=17):
    """Bench-shaped host batches: ``(dense, cat ids offset into the
    stacked vocab, label, mask)`` each ``(steps, batch, ...)``."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, vocab, size=(steps, batch, fields)).astype(
        np.int32) + (np.arange(fields, dtype=np.int32) * vocab)
    dense = rng.normal(size=(steps, batch, d_dense)).astype(np.float32)
    y = rng.integers(0, 2, size=(steps, batch)).astype(np.float32)
    return dense, cat, y, np.ones((steps, batch), np.float32)


def streamed_step_ms(route: str, dev, steps=8, batch=WD_BATCH,
                     vocab=WD_VOCAB, emb=WD_EMB, hidden=WD_HIDDEN, reps=3,
                     time_fn=None):
    """ms a step of the streamed dense-Adam Wide&Deep step (the
    ``fit_outofcore`` step: ``_make_train_ops``) over
    ``steps`` device-resident batches, the gather's backward on ``route``
    ("fixed" or "sort_fold"); ``time_fn(fn) -> ms`` times one run of all
    the steps.  Returns ``(ms a step, final params)``."""
    from flink_ml_tpu_torch.models.recommendation import widedeep as W

    data = [torch.from_numpy(a).to(dev)
            for a in widedeep_batches(steps, batch, vocab=vocab)]
    params0 = W.params_to_device(W.init_params(
        np.random.default_rng(18), WD_DENSE, [vocab] * WD_FIELDS, emb,
        hidden), dev)
    saved = W._FixedOrderRows
    if route == "sort_fold":
        W._FixedOrderRows = SortFoldRows
    try:
        step, opt0 = W._make_train_ops(params0, 1e-2, False)

        def run():
            params, opt = params0, opt0
            for i in range(steps):
                params, opt, _ = step(params, opt, *(a[i] for a in data))
            return params

        out = run()                                  # warm
        ms = min(time_fn(run) for _ in range(reps)) / steps
    finally:
        W._FixedOrderRows = saved
    return ms, out


def profile_streamed_fit(dev, card, lazy: bool, steps=16):
    """``WideDeep.fit_outofcore`` at the bench width under the profiler
    (see the module doc)."""
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from flink_ml_tpu_torch import WideDeep
    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)

    cache = os.path.join(HERE, "scratch_stream", "wd_profile")
    shutil.rmtree(cache, ignore_errors=True)
    try:
        dense, cat, y, _ = widedeep_batches(steps, WD_BATCH,
                                            vocab=WD_VOCAB)
        w = DataCacheWriter(cache)
        w.append({"denseFeatures": dense.reshape(-1, WD_DENSE),
                  "catFeatures": (cat - np.arange(WD_FIELDS, dtype=np.int32)
                                  * WD_VOCAB).reshape(-1, WD_FIELDS),
                  "label": y.reshape(-1)})
        w.finish()

        def fit():
            return (WideDeep(device=dev).set_vocab_sizes([WD_VOCAB]
                                                         * WD_FIELDS)
                    .set(WideDeep.EMBEDDING_DIM, WD_EMB)
                    .set(WideDeep.HIDDEN_UNITS, WD_HIDDEN).set_max_iter(1)
                    .set(WideDeep.LAZY_EMB_OPT, lazy)
                    .fit_outofcore(lambda: DataCacheReader(
                        cache, batch_rows=WD_BATCH)))

        fit()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    events = list(prof.key_averages())
    # kernels and copies only: an op's device time repeats its kernels'
    device_us = sum(e.self_device_time_total for e in events
                    if getattr(e, "self_device_time_total", 0) > 0
                    and e.cpu_time_total == 0)
    label = "lazy" if lazy else "dense"
    print(f"streamed Wide&Deep fit ({label} Adam, {steps} steps, W 8) "
          f"under the profiler: {wall * 1e3 / steps:.3f} ms a step of "
          f"wall, summed kernel time {device_us / 1e3 / steps:.3f} ms a "
          f"step, device busy share {device_us / 1e6 / wall:.3f} [{card}]",
          flush=True)
    by_dev = sorted((e for e in events
                     if getattr(e, "self_device_time_total", 0) > 0),
                    key=lambda e: -e.self_device_time_total)
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)
    for what, top, attr in (("device", by_dev[:12],
                             "self_device_time_total"),
                            ("host (self)", by_cpu[:12],
                             "self_cpu_time_total")):
        print(f"  top ops by {what} time:", flush=True)
        for e in top:
            print(f"    {e.key[:64]:64s} {e.count:7d} "
                  f"{getattr(e, attr) / 1e3 / steps:10.4f} ms a step",
                  flush=True)


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _event_ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    from flink_ml_tpu_torch.models.classification import (
        online_logisticregression as OLR)
    from flink_ml_tpu_torch.ops import emb_grad as EG

    if not torch.cuda.is_available():
        sys.exit("stream_grad_routes: needs an NVIDIA GPU")
    from flink_ml_tpu_torch.kernels import build

    build.build_all()
    card = _card()
    dev = torch.device("cuda")
    rows = WD_FIELDS * WD_VOCAB
    _, cat, _, _ = widedeep_batches(1)
    ids = torch.from_numpy(cat[0].reshape(-1)).to(dev)
    rng = np.random.default_rng(19)
    for E in (WD_EMB, 1):
        g = torch.from_numpy(rng.normal(size=(ids.numel(), E)).astype(
            np.float32)).to(dev)
        if E == 1:
            g = g[:, 0].contiguous()
        want = ROUTES["fixed"](g, ids, rows)
        again = ROUTES["fixed"](g, ids, rows)
        fold = ROUTES["sort_fold"](g, ids, rows)
        if not (torch.equal(want, again)
                and torch.equal(fold, ROUTES["sort_fold"](g, ids, rows))):
            sys.exit("a fixed-order route gave other bits on a rerun")
        err = float((fold - want).abs().max())
        if not torch.allclose(fold, want, rtol=1e-5, atol=1e-6):
            sys.exit(f"the two routes disagree (max |d| {err:.3e})")
        times = {name: _event_ms(lambda fn=fn: fn(g, ids, rows))
                 for name, fn in ROUTES.items()}
        print(f"table gradient, E {E}, {ids.numel()} slots into {rows} "
              f"rows: " + ", ".join(f"{k} {v:.4f} ms"
                                    for k, v in times.items())
              + f"; max |sort_fold - fixed| {err:.3e} [{card}]", flush=True)

    def time_fn(fn):
        torch.cuda.synchronize()
        return _event_ms(fn, reps=1, warm=0)

    EG.reset_launch_counts()
    for route in ("fixed", "sort_fold", "sort_fold", "fixed"):
        ms, _ = streamed_step_ms(route, dev, time_fn=time_fn)
        print(f"streamed dense-Adam step at the bench width (batch "
              f"{WD_BATCH}, W 8, device-resident batches), {route}: "
              f"{ms:.3f} ms a step [{card}]", flush=True)
    print(f"fold kernel launches on the sort_fold steps: "
          f"{EG.LAUNCHES['fold_runs']}", flush=True)

    rng = np.random.default_rng(13)
    idx = torch.from_numpy(rng.integers(0, FTRL_D, size=(
        FTRL_ROWS, FTRL_SLOTS))).to(dev)
    vals = torch.from_numpy(np.concatenate(
        [rng.normal(size=(FTRL_ROWS, 13)),
         np.ones((FTRL_ROWS, 26))], axis=1).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, size=FTRL_ROWS).astype(
        np.float32)).to(dev)
    sw = torch.ones(FTRL_ROWS, device=dev)
    flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
    zeros = torch.zeros(FTRL_D, device=dev)
    scatter = {
        "fixed": lambda: OLR._scatter_add_(zeros.clone(), flat_i, flat_v),
        "index_add_": lambda: zeros.clone().index_add_(0, flat_i, flat_v)}
    state = {k: torch.zeros(FTRL_D, device=dev) for k in ("w", "z", "n")}
    saved = OLR._scatter_add_
    step_ms = {}
    for name in ("fixed", "index_add_"):
        if name == "index_add_":
            OLR._scatter_add_ = lambda t, i, v: t.index_add_(0, i, v)
        try:
            step_ms[name] = _event_ms(lambda: OLR.sparse_ftrl_step(
                state, idx, vals, y, sw, 0.1, 1.0, 1e-4, 1e-4))
        finally:
            OLR._scatter_add_ = saved
    print(f"FTRL gradient scatter ({FTRL_ROWS} x {FTRL_SLOTS} into "
          f"{FTRL_D}): " + ", ".join(f"{k} {_event_ms(fn):.4f} ms"
                                     for k, fn in scatter.items())
          + "; whole sparse FTRL step: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in step_ms.items())
          + f" [{card}]", flush=True)
    for lazy in (False, True):
        profile_streamed_fit(dev, card, lazy)


if __name__ == "__main__":
    main()
