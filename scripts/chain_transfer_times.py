#!/usr/bin/env python3
"""Where a fused pipeline transform spends its time on the card, by part.

    python3 scripts/chain_transfer_times.py

At ``chip_smoke.py`` phase 25's pipeline (the pipeline bench,
``bench.py:1979-2003``: 2^17 x 64 f32, numpy seed 23; StandardScaler ->
MinMaxScaler -> MaxAbsScaler -> PCA k 16 -> LogisticRegression, fitted on
the card), the median host milliseconds over 7 runs of: the whole fused
and stagewise transforms; the fused segment's parts (the entry column's
host->device copy from pageable memory and from pinned memory, the five
stage functions on the card alone (also in CUDA-event milliseconds), the
fetched columns' device->host copies into fresh pageable arrays and into
pinned buffers allocated once, the terminal's host ``post`` and the
Table assembly); and a first touch of fresh host memory the size of the
fetch.  Prints each beside the card's name and power limit.  Needs one
NVIDIA GPU.
"""

import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

REPS = 7


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.api import chain
    from flink_ml_tpu_torch.data.table import Table
    from flink_ml_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    build.build_all()
    card = C.card_line()
    dev = torch.device("cuda")

    def med(fn):
        times = []
        for i in range(REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    pm, feats, _, _, _ = C.bench_pipeline(torch)
    (seg,) = pm._chain_plan([feats]).segments
    n = feats.num_rows
    X = np.asarray(feats["features"])
    rows = {}
    rows["fused transform"] = med(lambda: pm.transform(feats))

    def stagewise():
        with chain.chain_disabled():
            pm.transform(feats)

    rows["stagewise transform"] = med(stagewise)
    rows["entry copy in, pageable"] = med(
        lambda: torch.from_numpy(X).to(dev))
    pinned_x = torch.empty(X.shape, dtype=torch.float32, pin_memory=True)
    pinned_x.numpy()[:] = X
    rows["entry copy in, pinned"] = med(
        lambda: pinned_x.to(dev, non_blocking=True))
    cols = {"features": torch.from_numpy(X).to(dev)}
    out = chain.dispatch(seg.plan, seg.params, cols)
    rows["stage functions on the card"] = med(
        lambda: chain.dispatch(seg.plan, seg.params, cols))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    events = []
    for _ in range(REPS):
        start.record()
        chain.dispatch(seg.plan, seg.params, cols)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end))
    rows["stage functions, CUDA events"] = statistics.median(events)
    rows["fetch copies out, pageable"] = med(
        lambda: chain._fetch(out, seg.fetch_cols, n))
    pinned = {name: torch.empty(out[name][:n].shape, dtype=out[name].dtype,
                                pin_memory=True)
              for name in seg.fetch_cols}

    def fetch_pinned():
        for name in seg.fetch_cols:
            pinned[name].copy_(out[name][:n], non_blocking=True)

    rows["fetch copies out, pinned"] = med(fetch_pinned)
    fetched = chain._fetch(out, seg.fetch_cols, n)

    def post_and_table():
        got = dict(fetched)
        for post in seg.posts:
            got.update(post(got))
        Table({name: got[name] if name in got else feats[name]
               for name in seg.out_names})

    rows["post and Table assembly"] = med(post_and_table)
    fetch_bytes = seg.transfer_bytes(n)[1]
    rows[f"first touch of {fetch_bytes} fresh host bytes"] = med(
        lambda: np.ones(fetch_bytes // 4, np.float32))
    for name, ms in rows.items():
        print(f"{name}: {ms:.3f} ms [{card}]", flush=True)
    print(f"bytes a transform: entry {seg.transfer_bytes(n)[0]}, fetch "
          f"{fetch_bytes}; {n} x {X.shape[1]} [{card}]", flush=True)


if __name__ == "__main__":
    main()
