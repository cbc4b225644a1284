#!/usr/bin/env python3
"""Where one epoch of the port's Criteo fit spends its time on the card.

    python3 scripts/profile_torch_fit.py [--steps 8] [--plain]

Builds the main path of ``chip_smoke.py`` (LogisticRegression's SGD step at
2^20 features, batch 2^15, numpy seed 0) with device-resident epoch
tensors, runs one warm-up epoch, then one epoch under ``torch.profiler``.
Prints the device time by kernel, the epoch's wall time and the device's
busy share (summed kernel time over wall time), with the card's name and
power limit.  Needs one NVIDIA GPU.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

D, BATCH, N_DENSE, N_CAT = 1 << 20, 1 << 15, 13, 26


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--plain", action="store_true",
                    help="profile the kernels' plain versions instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    rows = args.steps * BATCH
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(rows, N_DENSE)).astype(np.float32)
    cat = rng.integers(32, D, size=(rows, N_CAT)).astype(np.int32)
    y = rng.integers(0, 2, size=rows).astype(np.float32)
    cat[:, 0] = np.where(y == 1, 16, 17)
    lay = E.ell_layout(cat.reshape(args.steps, BATCH, N_CAT), D).to(dev)

    def put(a):
        return torch.from_numpy(a.reshape((args.steps, BATCH)
                                          + a.shape[1:])).to(dev)

    route_w, _ = E.sample_routing(lay.src, lay.pos, lay.mask, BATCH)
    data = (put(dense), route_w, lay.src, lay.pos, lay.mask, lay.ovf_idx,
            lay.ovf_src, lay.heavy_idx, lay.heavy_cnt, put(y),
            put(np.ones(rows, np.float32)))
    cfg = S.SGDConfig(max_epochs=1, tol=0, global_batch_size=BATCH)
    update = S._mixed_update_ell(LOSSES["logistic"], cfg, plain=args.plain)
    params = {"w": torch.zeros(D, device=dev),
              "b": torch.zeros((), device=dev)}
    S._run_minibatch_epochs(update, data, params, args.steps, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        S._run_minibatch_epochs(update, data, params, args.steps, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    events.sort(key=lambda e: -e.device_time_total)
    # kernels and copies only: an op's device time repeats its kernels'
    kernel_us = sum(e.self_device_time_total for e in events
                    if e.cpu_time_total == 0)
    print(f"card: {card}; {'plain versions' if args.plain else 'kernels'}; "
          f"{args.steps} steps of {BATCH} rows at {D} features")
    print(f"epoch wall {wall * 1e3:.3f} ms (under the profiler); summed "
          f"device self time {kernel_us / 1e3:.3f} ms; device busy share "
          f"{kernel_us / 1e6 / wall:.3f}")
    print(f"{'op':60s} {'calls':>6s} {'self dev ms':>12s} {'cpu ms':>9s}")
    for e in events[:25]:
        print(f"{e.key[:60]:60s} {e.count:6d} "
              f"{e.self_device_time_total / 1e3:12.4f} "
              f"{e.cpu_time_total / 1e3:9.3f}")
    if not events:
        print("the profiler recorded no device time on this machine")


if __name__ == "__main__":
    main()
