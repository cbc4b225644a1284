"""Milliseconds the card is busy in a Wide&Deep step: the mean, over the
``wd_step`` spans of a profiled one-epoch fit (``widedeep.py``
``WideDeep.fit``), of the union of the kernels, copies and sets launched
inside each (``portbench/spans.py``).  The card's waits for the host are
left out."""

from portbench.spans import mean_busy_s


def read(run):
    s = mean_busy_s(run, "wd_step")
    return None if s is None else 1e3 * s
