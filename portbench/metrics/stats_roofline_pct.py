"""The KMeans stats kernel's share of its roofline (B4:
``ops/kmeans.py::kmeans_update_stats``, ``kernels/csrc/kmeans.cu``) at the
cell's shapes: CUDA events around launches on the run's points, against
the larger of 2 n k d operations at 495 TFLOP/s and the points,
centroids, sums and counts at 3.35 TB/s."""

import torch

from portbench import peaks

WARM, REPS = 2, 10


def flops(n: int, d: int, k: int) -> float:
    return 2.0 * n * k * d


def nbytes(n: int, d: int, k: int) -> float:
    """float32 points and centroids read, sums and counts written."""
    return 4.0 * (n * d + k * d + k * d + k)


def read(run):
    c = run.config
    if not {"n", "d", "k"} <= set(c) or run.device.type != "cuda":
        return None
    from flink_ml_tpu_torch.ops.kmeans import kmeans_update_stats

    n, d, k = int(c["n"]), int(c["d"]), int(c["k"])
    points = run.job.points(run.columns)
    centroids = points[:k].clone()
    for _ in range(WARM):
        kmeans_update_stats(points, centroids, tie_policy="first")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        kmeans_update_stats(points, centroids, tie_policy="first")
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) * 1e-3 / REPS
    return 100.0 * peaks.roofline_s(flops(n, d, k), nbytes(n, d, k)) / seconds
