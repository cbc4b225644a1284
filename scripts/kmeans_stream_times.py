#!/usr/bin/env python3
"""The streamed KMeans epoch on the stats kernel (B4) against the plain
stats, timed on the card.

    python3 scripts/kmeans_stream_times.py

At ``bench.py:54``'s shape (2^20 x 64 f32 points, N(0,1), numpy seed 0,
k 256), written once with ``DataCacheWriter`` to the gitignored
``scratch_stream/`` (~256 MB, removed at the end) and read by
``DataCacheReader`` at 2^16 and 2^17 rows a batch, ``kmeans_fit_outofcore``
runs 4 Lloyd's rounds on each of three per-batch stats:

- ``kernel``: B4 (``ops.kmeans.kmeans_update_stats``, tie policy first),
  the route the fit plans at >= 65536 rows a batch;
- ``kernel_plain``: the kernel's plain PyTorch version (``plain=True``);
- ``assign``: the plain assign-and-reduce the fit runs below the
  threshold (``kmeans._assign_stats``; the threshold lifted for the run).

Each route runs twice, in the order assign, kernel_plain, kernel, kernel,
kernel_plain, assign, and prints the median epoch seconds of rounds 2-4
(round 1 pays the pinned staging and the page cache), the iterations/s
and the second run's ``PrefetchStats`` (the consumer's wait on the
ingest), then the device ms of one batch's stats on each route (CUDA
events, device-resident batch), every number beside the card's name and
power limit.  Needs one NVIDIA GPU.
"""

import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

N, D, K = 1 << 20, 64, 256
ROUNDS = 4
BATCHES = (1 << 16, 1 << 17)
CACHE = os.path.join(HERE, "scratch_stream", "kmeans_times")


def main() -> None:
    import numpy as np
    import torch

    from flink_ml_tpu_torch.data.datacache import (DataCacheReader,
                                                   DataCacheWriter)
    from flink_ml_tpu_torch.data.prefetch import PrefetchStats
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.clustering import kmeans as KM
    from flink_ml_tpu_torch.ops import kmeans as KO

    if not torch.cuda.is_available():
        sys.exit("kmeans_stream_times: needs an NVIDIA GPU")
    build.build_all()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    pts = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    shutil.rmtree(CACHE, ignore_errors=True)
    try:
        w = DataCacheWriter(CACHE)
        w.append({"features": pts})
        w.finish()

        def epoch_s(batch, route, stats):
            info = {}
            saved = KM._KERNEL_MIN_ROWS
            if route == "assign":
                KM._KERNEL_MIN_ROWS = N + 1
            try:
                KM.kmeans_fit_outofcore(
                    lambda: DataCacheReader(CACHE, batch_rows=batch), K,
                    max_iter=ROUNDS, seed=0, device=dev,
                    plain=route == "kernel_plain", info=info,
                    prefetch_stats=stats)
            finally:
                KM._KERNEL_MIN_ROWS = saved
            want = "plain" if route == "assign" else "kernel"
            if info["impl"] != want:
                sys.exit(f"route {route} planned {info['impl']}")
            return statistics.median(info["epoch_seconds"][1:])

        order = ("assign", "kernel_plain", "kernel", "kernel",
                 "kernel_plain", "assign")
        for batch in BATCHES:
            secs, stats = {}, {}
            for route in order:
                stats[route] = PrefetchStats()
                secs.setdefault(route, []).append(
                    epoch_s(batch, route, stats[route]))
            for route, s in secs.items():
                print(f"streamed epoch, {batch} rows a batch ({N // batch} "
                      f"batches), {route}: {s[0]:.4f} s, {s[1]:.4f} s "
                      f"({1 / min(s):.3f} iterations/s); prefetch of the "
                      f"second run's {ROUNDS} rounds "
                      f"{stats[route].as_dict()} [{card}]", flush=True)

            x = torch.from_numpy(pts[:batch]).to(dev)
            c = x[:K].clone()
            measure = DistanceMeasure.get_instance("euclidean")
            ones = torch.ones(batch, device=dev)
            runs = {
                "kernel": lambda: KO.kmeans_update_stats(
                    x, c, tie_policy="first"),
                "kernel_plain": lambda: KO.kmeans_update_stats_plain(
                    x, c, tie_policy="first"),
                "assign": lambda: KM._assign_stats(measure, K, x, ones, c)}
            for route, fn in runs.items():
                for _ in range(3):
                    fn()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    fn()
                end.record()
                torch.cuda.synchronize()
                print(f"one batch's stats, {batch} x {D}, k {K}, "
                      f"device-resident, {route}: "
                      f"{start.elapsed_time(end) / 20:.4f} ms [{card}]",
                      flush=True)
    finally:
        shutil.rmtree(CACHE, ignore_errors=True)


if __name__ == "__main__":
    main()
