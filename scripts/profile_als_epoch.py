#!/usr/bin/env python3
"""Where one ALS epoch at ``bench_als``'s shape spends its time on the card.

    python3 scripts/profile_als_epoch.py [--form sorted|scatter|both]

Builds ``chip_smoke.py`` phase 40's ratings (2^14 users, 2^12 items,
2^21 ratings, numpy seed 3; rank 64, reg 0.1, explicit), runs one warm-up
epoch of ``als_epoch_step`` in each normal-equation form, then one epoch
under ``torch.profiler``.  Prints the device time by op, the epoch's wall
time and the device's busy share (summed kernel time over wall time),
with the card's name and power limit.  Needs one NVIDIA GPU.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_USERS, N_ITEMS, NNZ, RANK, REG, SEED = 1 << 14, 1 << 12, 1 << 21, 64, 0.1, 3


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_ml_tpu_torch.models.recommendation import als as A

    ap = argparse.ArgumentParser()
    ap.add_argument("--form", choices=("sorted", "scatter", "both"),
                    default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    u = rng.integers(0, N_USERS, size=NNZ)
    i = rng.integers(0, N_ITEMS, size=NNZ)
    r = rng.normal(size=NNZ).astype(np.float32)
    w = np.ones(NNZ, np.float32)
    U0, V0 = A.init_factors(N_USERS, N_ITEMS, RANK, 0)
    state = (torch.from_numpy(U0).to(dev), torch.from_numpy(V0).to(dev))
    plans = (A.NeqPlan(u), A.NeqPlan(i))
    forms = {
        "sorted": (A.als_epoch_step(N_USERS, N_ITEMS, REG, False, 1.0,
                                    plans=plans),
                   plans[0].side_data(i, r, w, dev)
                   + plans[1].side_data(u, r, w, dev)),
        "scatter": (A.als_epoch_step(N_USERS, N_ITEMS, REG, False, 1.0),
                    tuple(torch.from_numpy(x).to(dev) for x in (u, i, r, w))),
    }
    names = list(forms) if args.form == "both" else [args.form]
    print(f"card: {card}; {N_USERS} users x {N_ITEMS} items, {NNZ} "
          f"ratings, rank {RANK}; spans {plans[0].span}, {plans[1].span}")
    for name in names:
        body, data = forms[name]
        body(state, 0, data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            body(state, 0, data)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0]
        events.sort(key=lambda e: -e.self_device_time_total)
        # kernels and copies only: an op's device time repeats its kernels'
        kernel_us = sum(e.self_device_time_total for e in events
                        if e.cpu_time_total == 0)
        print(f"\n{name}: epoch wall {wall * 1e3:.3f} ms (under the "
              f"profiler); summed device self time {kernel_us / 1e3:.3f} "
              f"ms; device busy share {kernel_us / 1e6 / wall:.3f}")
        print(f"{'op':70s} {'calls':>6s} {'self dev ms':>12s}")
        for e in events[:18]:
            print(f"{e.key[:70]:70s} {e.count:6d} "
                  f"{e.self_device_time_total / 1e3:12.4f}")
        if not events:
            print("the profiler recorded no device time on this machine")


if __name__ == "__main__":
    main()
