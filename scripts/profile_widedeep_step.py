#!/usr/bin/env python3
"""Where one epoch of the port's Wide&Deep training spends its time on the
card.

    python3 scripts/profile_widedeep_step.py [--mode kernel|plain|off]

Builds the main path of ``chip_smoke.py`` phase 10 at the bench width
(26 fields x 40329 vocab, 13 dense, embedding 64, MLP (1024, 512, 256),
batch 8192, 16 steps, numpy seed 17) with device-resident epoch tensors and
the fit's route, runs one warm-up epoch of ``_make_train_ops``'s step, then
one epoch under ``torch.profiler``.  ``--mode``: the routed step through the
fold kernel (default), through the plain fold, or autograd's scatter-add
(``'off'``).  Prints the device time by op, the epoch's wall time and the
device's busy share (summed kernel and copy time over wall time), with the
card's name and power limit.  Needs one NVIDIA GPU.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FIELDS, N_DENSE, EMB, HIDDEN = 26, 13, 64, (1024, 512, 256)
VOCAB, BATCH, STEPS = (1 << 20) // 26, 1 << 13, 16


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.recommendation import widedeep as W
    from flink_ml_tpu_torch.ops import emb_grad as G

    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("kernel", "plain", "off"),
                    default="kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    vocab_sizes = [VOCAB] * FIELDS
    rows = BATCH * STEPS
    rng = np.random.default_rng(17)          # the bench's draws, in order
    cat = rng.integers(0, VOCAB, size=(rows, FIELDS)).astype(np.int32)
    dense = rng.normal(size=(rows, N_DENSE)).astype(np.float32)
    y = rng.integers(0, 2, size=rows).astype(np.float32)
    steps, batch, perm = S.plan_epoch_layout(rows, BATCH, 1, 0)
    C = S.prepare_epoch_tensor(cat + W._field_offsets(vocab_sizes), perm,
                               steps, batch)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(
            S.prepare_epoch_tensor(a, perm, steps, batch))).to(dev)

    data = (put(dense), torch.from_numpy(C).to(dev), put(y),
            put(np.ones(rows, np.float32)))
    route = None
    if args.mode != "off":
        route = G.emb_grad_route(C, VOCAB * FIELDS).to(dev)
    params = W.params_to_device(W.init_params(
        np.random.default_rng(1), N_DENSE, vocab_sizes, EMB, HIDDEN), dev)
    step, state = W._make_train_ops(params, 1e-2, False, route=route,
                                    plain=args.mode == "plain")

    def epoch(params, state):
        for i in range(steps):
            extra = () if route is None else route.step_slice(i)
            params, state, _ = step(params, state, *(a[i] for a in data),
                                    *extra)
        return params, state

    params, state = epoch(params, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state = epoch(params, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    # kernels and copies only: an op's device time repeats its kernels'
    device_us = sum(e.self_device_time_total for e in events
                    if e.cpu_time_total == 0)
    print(f"card: {card}; mode {args.mode}; {steps} steps of {BATCH} rows, "
          f"fold_passes {route.fold_passes if route else '-'}")
    print(f"epoch wall {wall * 1e3:.3f} ms (under the profiler), "
          f"{wall * 1e3 / steps:.3f} ms a step; summed kernel time "
          f"{device_us / 1e3:.3f} ms; device busy share "
          f"{device_us / 1e6 / wall:.3f}")
    print(f"{'op':60s} {'calls':>6s} {'self dev ms':>12s} {'cpu ms':>9s}")
    for e in events[:30]:
        print(f"{e.key[:60]:60s} {e.count:6d} "
              f"{e.self_device_time_total / 1e3:12.4f} "
              f"{e.cpu_time_total / 1e3:9.3f}")
    if not events:
        print("the profiler recorded no device time on this machine")


if __name__ == "__main__":
    main()
