"""Seconds of the traced fit outside its loop: the program's ``*.fit``
span (``WideDeep.fit``, ``KMeans.fit``) less the stream time of its loop
child (``widedeep.epochs``, ``kmeans.rounds``), from the spans the fit
records under the profiler (``portbench/spans.py``): validation, layout,
route, init draws, copies in and out.  The loop counts by its time on the
card's stream: the host queues the rounds ahead of the card and waits for
them in the copy out, so the loop's host span ends before its work
does."""

from portbench.spans import FIT_LOOP, traced_fit


def read(run):
    got = traced_fit()
    if got is None:
        return None
    fit, inside = got
    loop = [s for s in inside if s.name == FIT_LOOP[fit.name]]
    if len(loop) != 1 or loop[0].stream_s is None:
        return None
    return fit.dur - loop[0].stream_s
