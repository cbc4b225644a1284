#!/usr/bin/env python3
"""The in-memory LR epoch rate on the card, beside another checkout's.

    python3 scripts/lr_epoch_rate.py [--against DIR] [--reps N]

At ``chip_smoke.py`` phase 4/5's shapes (2^18 Criteo-shaped rows from
``criteo_rows(..., seed=0)``, 2^20 features, batch 2^15, 8 steps an
epoch): the ELL update over device-resident epoch tensors (the layout
and the sample routing built once, outside the clock), 3 epochs a run,
``N`` runs (default 5) after one warm run, host clock around
``torch.cuda.synchronize()``.  Each checkout runs in its own process;
with ``--against DIR`` (a checkout of another commit, e.g. one unpacked
with ``git archive``) the order is DIR, this, this, DIR, so both are
timed in one call on one card.  Prints each run's epochs/s and the
median per checkout, beside the card's name and power limit.  Needs one
NVIDIA GPU and nvcc.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3


def worker(root: str, reps: int) -> None:
    """Time the epoch loop of the package at ``root``; print one JSON
    line of epochs/s per run."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

    build.build_all()
    dev = torch.device("cuda")
    dense, cat, y = C.criteo_rows(C.ROWS, C.D_MAIN, seed=0)
    steps = C.ROWS // C.BATCH
    perm = np.random.default_rng(0).permutation(C.ROWS)
    lay = E.ell_layout(S.prepare_epoch_tensor(cat, perm, steps, C.BATCH),
                       C.D_MAIN).to(dev)
    route, _ = E.sample_routing(lay.src, lay.pos, lay.mask, C.BATCH)

    def put(a):
        return torch.from_numpy(S.prepare_epoch_tensor(
            a, perm, steps, C.BATCH)).to(dev)

    args = (put(dense), route, lay.src, lay.pos, lay.mask, lay.ovf_idx,
            lay.ovf_src, lay.heavy_idx, lay.heavy_cnt,
            put(y.astype(np.float32)), put(np.ones(C.ROWS, np.float32)))
    cfg = dataclasses.replace(
        S.SGDConfig(learning_rate=0.5, global_batch_size=C.BATCH, tol=0),
        max_epochs=EPOCHS)
    update = S._mixed_update_ell(LOSSES["logistic"], cfg)

    def run():
        init = {"w": torch.zeros(C.D_MAIN, device=dev),
                "b": torch.zeros((), device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S._run_minibatch_epochs(update, args, init, steps, cfg)
        torch.cuda.synchronize()
        return EPOCHS / (time.perf_counter() - t0)

    run()
    print(json.dumps({"root": root, "epochs_per_s": [run()
                                                     for _ in range(reps)]}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a checkout of another commit")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.reps)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("lr_epoch_rate: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    roots = [HERE]
    if args.against:
        other = os.path.abspath(args.against)
        roots = [other, HERE, HERE, other]
    rates = {}
    for root in roots:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--reps", str(args.reps)], check=True, capture_output=True,
            text=True, timeout=900, cwd=root).stdout.strip().splitlines()
        got = json.loads(out[-1])["epochs_per_s"]
        rates.setdefault(root, []).extend(got)
        print(f"{root}: epochs/s {[round(r, 3) for r in got]} [{card}]",
              flush=True)
    for root, got in rates.items():
        print(f"{root}: median {statistics.median(got):.3f} epochs/s over "
              f"{len(got)} runs of {EPOCHS} epochs (8 steps of 2^15 at "
              f"2^20 features) [{card}]", flush=True)


if __name__ == "__main__":
    main()
