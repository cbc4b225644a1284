"""The share of one fit's wall time in which no kernel, copy or set ran
on the card: 1 minus the union of the device intervals over the fit's
span, from ``torch.profiler`` (``portbench/profiling.py``)."""


def read(run):
    p = run.profile
    if not p or p["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
