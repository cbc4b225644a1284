"""The KMeans stats kernel's share of its roofline inside the fit (B4,
``ops/kmeans.py::kmeans_update_stats``): ``stats_roofline_pct``'s
operations and bytes at the cell's (n, d, k) over the card's mean busy
time under the ``kmeans.stats`` spans of a profiled one-round fit
(``portbench/spans.py``)."""

from portbench import peaks
from portbench.metrics.stats_roofline_pct import flops, nbytes
from portbench.spans import mean_busy_s


def read(run):
    c = run.config
    if not {"n", "d", "k"} <= set(c):
        return None
    s = mean_busy_s(run, "kmeans.stats")
    if not s:
        return None
    n, d, k = int(c["n"]), int(c["d"]), int(c["k"])
    return 100.0 * peaks.roofline_s(flops(n, d, k), nbytes(n, d, k)) / s
