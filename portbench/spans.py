"""The program's own spans, for the readers of the fits' layers.

- :func:`traced_fit`: the harness's traced fit as the program recorded it
  in its process-wide ring (``flink_ml_tpu_torch/obs/trace.py``), which
  records while a ``torch.profiler`` session does: host durations, and a
  span's ``stream_s`` where it was timed on the card.
- :func:`busy_by_span`: the card's busy time under each span, from a fit
  of one epoch profiled here: the union of the kernels, copies and sets
  that the host launched inside the span's ``user_annotation`` (each
  device event joined to its launch by the profiler's correlation id).
  Unlike ``stream_s`` it leaves out the stream's waits for the host.

A program that records no such span leaves nothing to read: both return
None, and nothing is profiled.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from portbench.jobs.seeds import fit_seed
from portbench.profiling import DEVICE_CATS, union_us

#: each fit's span and the child that holds its loop
FIT_LOOP = {"widedeep.fit": "widedeep.epochs", "kmeans.fit": "kmeans.rounds"}
#: slack on the containment test: a child's end is ``t0 + dur`` in floats
EPS_S = 1e-9
#: the host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def traced_fit(names=tuple(FIT_LOOP)) -> Optional[tuple]:
    """``(fit, spans inside it)`` for the first span in the ring named in
    ``names``, or None.  The first is the harness's traced fit: nothing
    records before it."""
    from flink_ml_tpu_torch.obs.trace import tracer

    spans = tracer.spans()
    fit = next((s for s in spans if s.name in names), None)
    if fit is None:
        return None
    end = fit.t0 + fit.dur + EPS_S
    return fit, [s for s in spans if s is not fit and s.t0 >= fit.t0
                 and s.t0 + s.dur <= end]


def busy_by_annotation(events: list) -> Dict[str, List[float]]:
    """Seconds of device work under each ``user_annotation`` of a Chrome
    trace, by name, one number an annotation in time order: the union of
    the device events whose launch lies inside it.  Annotations of one
    name do not nest."""
    launched = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "dur" in e:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    lt, ks, ke = [], [], []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            at = launched.get((e.get("args") or {}).get("correlation"))
            if at is not None:
                lt.append(at)
                ks.append(float(e["ts"]))
                ke.append(float(e["ts"]) + float(e["dur"]))
    lt, ks, ke = np.array(lt), np.array(ks), np.array(ke)
    marks = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e:
            ts = float(e["ts"])
            marks[e["name"]].append((ts, ts + float(e["dur"])))
    out = {}
    for name, spans in marks.items():
        spans.sort()
        s0 = np.array([a for a, _ in spans])
        s1 = np.array([b for _, b in spans])
        i = np.searchsorted(s0, lt, side="right") - 1
        inside = (i >= 0) & (lt <= s1[np.maximum(i, 0)])
        busy = [0.0] * len(spans)
        for j in np.unique(i[inside]):
            sel = inside & (i == j)
            busy[j] = union_us(ks[sel], ke[sel])[0] * 1e-6
        out[name] = busy
    return out


def _profiled_events(fit) -> list:
    """The Chrome trace events of ``fit()`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def busy_by_span(run) -> Optional[Dict[str, List[float]]]:
    """:func:`busy_by_annotation` of one fit of the run's job at one epoch
    (the fit's steps, each as in the window's fits), profiled once a run;
    None off the card or where the program records no fit span."""
    if not hasattr(run, "_busy_by_span"):
        busy = None
        if run.device.type == "cuda" and traced_fit() is not None:
            seed = fit_seed(run.seed, len(run.fit_walls) + 1)
            busy = busy_by_annotation(_profiled_events(
                lambda: run.job.fit(run.table, seed, max_iter=1)))
        run._busy_by_span = busy
    return run._busy_by_span


def mean_busy_s(run, name: str) -> Optional[float]:
    """Mean :func:`busy_by_span` of the spans called ``name``, or None
    where there are none."""
    busy = (busy_by_span(run) or {}).get(name)
    return sum(busy) / len(busy) if busy else None
