#!/usr/bin/env python3
"""The in-memory LR epoch rate and Wide&Deep step rate on the card,
beside another checkout's.

    python3 scripts/lr_epoch_rate.py [--against DIR] [--reps N] [--rounds R]

Each checkout's updates are built as its own fits build them, so
``--against`` a parent times what each commit's fits run.  LR: at
``chip_smoke.py`` phase 4/5's shapes (2^18 Criteo-shaped rows from
``criteo_rows(..., seed=0)``, 2^20 features, batch 2^15, 8 steps an
epoch), the ELL update over device-resident epoch tensors (the layout
and the sample routing built once, outside the clock), 3 epochs a run.
Wide&Deep: at phase 10/11's bench width (26 fields x 40329 vocab,
embedding 64, MLP (1024, 512, 256), batch 8192, 16 steps, numpy seed
17), one pass of the in-memory step without the route ('off', dense
Adam) and of the lazy step over device-resident batches.  ``N`` runs of
each (default 5) after one warm run, host clock around
``torch.cuda.synchronize()``.  Each checkout runs in its own process;
with ``--against DIR`` (a checkout of another commit, e.g. one unpacked
with ``git archive``) the order is DIR, this, this, DIR, ``R`` times
(default 1), so both are timed in one call on one card.  Prints each
process's rates and the median per checkout over all its runs, beside
the card's name and power limit.  Needs one NVIDIA GPU and nvcc.
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


def epoch_runner(torch, C):
    """``run()``: epochs/s of one run of the LR ELL update loop at the
    shapes above, the update as this checkout's ``sgd_fit_mixed`` builds
    it."""
    import dataclasses

    import numpy as np

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

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

    return run


def widedeep_runner(torch, C):
    """``run(lazy)``: steps/s of one pass of the in-memory Wide&Deep step
    without the route over the bench-width batches above, the step as
    this checkout's ``WideDeep.fit`` builds it ('off' or lazy)."""
    import numpy as np

    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.recommendation import widedeep as W

    dev = torch.device("cuda")
    cat, dense, y = C.widedeep_bench_data(C.WD_BATCH, C.WD_STEPS)
    rows = C.WD_BATCH * C.WD_STEPS
    vocab = [C.WD_VOCAB] * C.WD_FIELDS
    steps, batch, perm = S.plan_epoch_layout(rows, C.WD_BATCH, 1, 0)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(
            S.prepare_epoch_tensor(a, perm, steps, batch))).to(dev)

    epoch = (put(dense.reshape(rows, C.WD_DENSE)),
             put((cat.reshape(rows, C.WD_FIELDS)
                  + W._field_offsets(vocab)).astype(np.int32)),
             put(y.reshape(rows)), put(np.ones(rows, np.float32)))
    host = W.init_params(np.random.default_rng(1), C.WD_DENSE, vocab,
                         C.WD_EMB, C.WD_HIDDEN)

    def run(lazy):
        params = W.params_to_device(host, dev)
        step, state = W._make_train_ops(params, 1e-2, lazy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            params, state, _ = step(params, state, *(a[i] for a in epoch))
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0)

    return run


def worker(root: str, reps: int) -> None:
    """Time the loops of the package at ``root``; print one JSON line of
    rates per run."""
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.kernels import build

    build.build_all()
    lr = epoch_runner(torch, C)
    lr()
    out = {"root": root, "lr_epochs_per_s": [lr() for _ in range(reps)]}
    del lr
    wd = widedeep_runner(torch, C)
    for key, lazy in (("wd_off_steps_per_s", False),
                      ("wd_lazy_steps_per_s", True)):
        wd(lazy)
        out[key] = [wd(lazy) for _ in range(reps)]
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a checkout of another commit")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1)
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
    roots = [HERE] * args.rounds
    if args.against:
        other = os.path.abspath(args.against)
        roots = [other, HERE, HERE, other] * args.rounds
    keys = ("lr_epochs_per_s", "wd_off_steps_per_s", "wd_lazy_steps_per_s")
    rates = {}
    for root in roots:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root,
             "--reps", str(args.reps)], check=True, capture_output=True,
            text=True, timeout=900, cwd=root).stdout.strip().splitlines()
        got = json.loads(out[-1])
        for key in keys:
            rates.setdefault(root, {}).setdefault(key, []).extend(got[key])
        print(f"{root}: " + "; ".join(
            f"{key} {[round(r, 3) for r in got[key]]}" for key in keys)
            + f" [{card}]", flush=True)
    for root, got in rates.items():
        print(f"{root}: median over {len(got[keys[0]])} runs: LR "
              f"{statistics.median(got[keys[0]]):.3f} epochs/s ({EPOCHS} "
              f"epochs of 8 steps of 2^15 at 2^20 features a run); "
              f"Wide&Deep 'off' {statistics.median(got[keys[1]]):.3f}, "
              f"lazy {statistics.median(got[keys[2]]):.3f} steps/s [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
