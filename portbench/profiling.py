"""One fit under ``torch.profiler``: the device's busy time as the union
of its kernel, copy and set intervals, and the breakdown of device time by
kernel and of idle time by what the host was doing."""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN = "portbench.fit"
#: gaps shorter than this are the launch gaps of a busy stream; they are
#: summed under one label
SHORT_GAP_US = 50.0
NO_OP = "host code outside torch operations"


def union_us(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """The union of intervals: ``(total length, merged starts, merged
    ends)``."""
    if starts.size == 0:
        return 0.0, starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, s.size - 1)
    ms, me = s[first], reach[last]
    return float(np.sum(me - ms)), ms, me


def _label_gaps(gs, ge, host) -> dict:
    """Idle microseconds by the innermost host operation under each gap's
    midpoint."""
    by = defaultdict(float)
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        names = [h[2] for h in host]
    for a, b in zip(gs, ge):
        length = b - a
        if length < SHORT_GAP_US:
            by[f"launch gaps under {SHORT_GAP_US:g} us"] += length
            continue
        label = NO_OP
        if host:
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            if cover.size:
                label = names[cover[np.argmin(he[cover] - hs[cover])]]
        by[label] += length
    return by


def summarize(events: list) -> dict:
    """Busy and idle times of the span :data:`SPAN` in a Chrome trace's
    events."""
    span = [e for e in events if e.get("name") == SPAN and "dur" in e]
    if not span:
        raise RuntimeError(f"the trace holds no {SPAN!r} span")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    starts = np.clip(np.array([float(e["ts"]) for e in dev]), t0, t1)
    ends = np.clip(np.array([float(e["ts"]) + float(e["dur"]) for e in dev]),
                   t0, t1)
    busy, ms, me = union_us(starts, ends)
    ops = defaultdict(float)
    for e, a, b in zip(dev, starts, ends):
        ops[e["name"]] += b - a
    gs = np.concatenate([[t0], me])
    ge = np.concatenate([ms, [t1]])
    keep = ge > gs
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in HOST_CATS and "dur" in e
            and e.get("name") != SPAN]
    idle = _label_gaps(gs[keep], ge[keep], host)

    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(),
                                                  key=lambda kv: -kv[1])[:10]]

    return {"busy_s": busy * 1e-6, "span_s": (t1 - t0) * 1e-6,
            "device_ops": top(ops), "idle_gaps": top(idle)}


@contextlib.contextmanager
def host_spans(names):
    """Wrap each ``(module, attribute)`` function in a
    ``record_function`` span named ``<module tail>.<attribute>`` while the
    context is open, so that the trace can tell which of the program's
    host steps the card waited on.  Restored on exit."""
    from torch.profiler import record_function

    saved = []
    for mod_name, attr in names:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        label = f"{mod_name.rsplit('.', 1)[-1]}.{attr}"

        def wrapped(*a, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def profile_fit(fit, spans=()) -> dict:
    """Run ``fit()`` once under the profiler, with :func:`host_spans`
    around ``spans``: the summary of :func:`summarize`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with host_spans(spans), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            fit()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events)
