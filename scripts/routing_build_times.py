#!/usr/bin/env python3
"""The streamed LR fit's per-batch sample routing, built on the card (what
the fit runs) and on the host (the alternative), timed side by side.

    python3 scripts/routing_build_times.py [--batches N]

At ``chip_smoke.py`` phase 21's shapes (Criteo-shaped rows from
``criteo_rows(..., seed=0)``, 2^20 features, batch 2^15, the streamed
caps ``ell_ovf_cap = max(1024, batch)`` and ``ell_heavy_cap = 16``), for
each of ``N`` batches (default 8): the host's ELL layout build (what a
decode worker does a batch; host clock), the host routing
(:func:`sample_routing_host`, numpy; host clock) and the card's routing
(``ops.ell_scatter.sample_routing`` of the batch's layout on the card;
CUDA events, and the host microseconds a call when 20 calls are enqueued
back to back).  Checks that both builds give the same array for every
batch.  The host build would add its time to every batch the decode
workers decode (the record epoch); the card's adds its time to every
step (record and replay epochs).  Prints medians and ranges beside the
card's name and power limit.  Needs one NVIDIA GPU.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CALLS = 20


def sample_routing_host(cat: np.ndarray, lay,
                        nnz: Optional[int] = None) -> np.ndarray:
    """``ops.ell_scatter.sample_routing`` of ONE step, built on the host
    from the step's ``(batch, slots)`` categorical indices ``cat`` and its
    layout ``lay`` (``ell_layout`` of ``cat[None]``, no values): the
    ``(nnz, batch)`` int32 ``route_w``, array for array the one
    ``sample_routing`` builds from ``lay``.

    A sample's in-grid slots are its indices less the sentinels (``>=
    num_features``), the heavy indices and its overflow entries; a row's
    slots sit in lane order, so ascending grid position is ascending weight
    index and the routing is each sample's in-grid indices, sorted.

    ``nnz`` pads the routing with ``-1`` rows to a fixed height (a
    sample's in-grid slots never outnumber its slots); None gives the
    exact height (the most in-grid slots of any sample)."""
    batch, width = cat.shape
    if lay.val is not None or lay.steps != 1 or lay.batch != batch:
        raise ValueError("sample_routing_host takes one step's layout "
                         "without values, built from the same indices")
    out = np.iinfo(np.int32).max
    keys = np.where((cat >= 0) & (cat < lay.num_features), cat, out
                    ).astype(np.int32)
    n_heavy = int(lay.need_heavy[0])
    if n_heavy:
        keys[np.isin(keys, lay.heavy_idx[0, :n_heavy])] = out
    keys.sort(axis=1)
    n_ovf = int(lay.need_ovf[0])
    if n_ovf:
        # each overflow entry (index, sample) leaves one of the sample's
        # copies of the index: the k-th entry of a repeated pair the k-th
        o_src = lay.ovf_src[0, :n_ovf].astype(np.int64)
        o_idx = lay.ovf_idx[0, :n_ovf].astype(np.int64)
        order = np.lexsort((o_idx, o_src))
        o_src, o_idx = o_src[order], o_idx[order]
        first = np.ones(n_ovf, bool)
        first[1:] = (o_src[1:] != o_src[:-1]) | (o_idx[1:] != o_idx[:-1])
        at = np.arange(n_ovf)
        dup = at - np.maximum.accumulate(np.where(first, at, 0))
        rows = np.unique(o_src)
        flat = ((np.arange(rows.size, dtype=np.int64)[:, None] << 32)
                + keys[rows]).reshape(-1)
        hit = np.searchsorted(
            flat, (np.searchsorted(rows, o_src) << 32) + o_idx) + dup
        sub = keys[rows]
        sub.reshape(-1)[hit] = out
        sub.sort(axis=1)
        keys[rows] = sub
    need = int(np.max(np.sum(keys != out, axis=1))) if batch else 0
    if nnz is None:
        nnz = need
    elif need > nnz:
        raise ValueError(f"a sample has {need} in-grid slots > nnz {nnz}")
    route_w = np.full((nnz, batch), -1, np.int32)
    top = min(nnz, width)
    route_w[:top] = np.where(keys[:, :top] == out, -1, keys[:, :top]).T
    return route_w


def _spread(xs) -> str:
    return (f"median {statistics.median(xs):.4f} (range {min(xs):.4f}-"
            f"{max(xs):.4f})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args()

    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.ops import ell_scatter as E

    if not torch.cuda.is_available():
        sys.exit("routing_build_times: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    _, cats, _ = C.criteo_rows(args.batches * C.BATCH, C.D_MAIN, seed=0)
    layout_ms, host_ms, card_ms, card_us = [], [], [], []
    for i in range(args.batches):
        cat = np.ascontiguousarray(cats[i * C.BATCH:(i + 1) * C.BATCH])
        t0 = time.perf_counter()
        lay = E.ell_layout(cat[None], C.D_MAIN,
                           pad_ovf_cap=max(1024, C.BATCH), pad_heavy_cap=16)
        layout_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        host = sample_routing_host(cat, lay)
        host_ms.append((time.perf_counter() - t0) * 1e3)

        t = lay.to(dev)
        grid = (t.src[0], t.pos[0], t.mask[0])

        def build():
            return E.sample_routing(*grid, C.BATCH)[0]

        got = build()
        if not np.array_equal(got.cpu().numpy(), host):
            sys.exit(f"routing_build_times: batch {i}: the host routing "
                     "differs from the card's")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(CALLS):
            build()
        end.record()
        card_us.append((time.perf_counter() - t0) / CALLS * 1e6)
        torch.cuda.synchronize()
        card_ms.append(start.elapsed_time(end) / CALLS)
    print(f"routing builds at 2^20 features, batch 2^15, {args.batches} "
          f"batches (equal array for array in every batch) [{card}]",
          flush=True)
    print(f"  host ell_layout a batch (the decode's build): "
          f"{_spread(layout_ms)} ms [{card}]", flush=True)
    print(f"  host sample routing a batch (numpy): {_spread(host_ms)} ms "
          f"[{card}]", flush=True)
    print(f"  card sample routing a step: {_spread(card_ms)} ms device, "
          f"{_spread(card_us)} us host a call enqueued [{card}]",
          flush=True)


if __name__ == "__main__":
    main()
