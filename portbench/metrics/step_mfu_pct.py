"""The whole fit's share of the card's float32 peak: the algorithm's
floating-point operations (the job's ``flops_per_fit``: the MLP's 6 a
weight a row a epoch for Wide&Deep, 2 n k d a round for KMeans) over the
window's mean fit time at 495 TFLOP/s (``peaks.F32_PEAK_FLOPS``)."""

from portbench import peaks


def read(run):
    flops = getattr(run.job, "flops_per_fit", None)
    if flops is None or not run.fit_walls:
        return None
    return 100.0 * flops() / (run.fit_s * peaks.F32_PEAK_FLOPS)
