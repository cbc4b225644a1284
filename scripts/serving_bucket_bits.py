#!/usr/bin/env python3
"""Do a row's scores depend on the bucket it rides in, on the card?

    python3 scripts/serving_bucket_bits.py

A served request is scored inside a coalesced micro-batch padded to a
power-of-two bucket (8-256 rows), while its offline ``transform`` pads
it to its own bucket.  This script scores the same first 8 rows at every
bucket of the serving ladder and counts, for each pair of buckets, the
rows whose bits differ:

- the LR terminal's ``X @ w + b`` at d 64 (``bench_serving``'s width);
- the Wide&Deep forward at the bench width (26 x 40329 vocab, embedding
  64, MLP (1024, 512, 256), numpy seed 17 weights, nonzero wide rows);
- B5 (``kmeans_assign_reduce``) at k 256, d 64.

Each is also scored with the other rows of the bucket replaced (same
bucket, other neighbours).  Then the same products in fixed row tiles of
``TILE`` rows (every matmul one shape; a bucket below the tile is padded
to it), with the median CUDA-event ms a call of both at every bucket.
Prints every count and time beside the card's name and power limit.
Needs one NVIDIA GPU.
"""

import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BUCKETS = (8, 16, 32, 64, 128, 256)
TILE = 256
REPS = 25


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.recommendation import widedeep as W
    from flink_ml_tpu_torch.ops.kmeans import kmeans_assign_reduce

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    build.build_all(["kmeans"])
    card = C.card_line()
    dev = torch.device("cuda")
    print(f"card: {card}; allow_tf32 (matmul) "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    rng = np.random.default_rng(17)
    top = BUCKETS[-1]

    # -- the three scorers -------------------------------------------------
    X = torch.from_numpy(rng.normal(size=(2, top, 64)).astype(np.float32)
                         ).to(dev)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(dev)
    b = torch.tensor(0.25, device=dev)

    vocab = [C.WD_VOCAB] * C.WD_FIELDS
    params = W.init_params(rng, C.WD_DENSE, vocab, C.WD_EMB, C.WD_HIDDEN)
    params["wide_cat"] = rng.normal(size=params["wide_cat"].shape).astype(
        np.float32) * 0.05
    net = W.params_to_device(params, dev)
    dense = torch.from_numpy(rng.normal(size=(2, top, C.WD_DENSE)).astype(
        np.float32)).to(dev)
    cat = torch.from_numpy(rng.integers(
        0, C.WD_VOCAB * C.WD_FIELDS, size=(2, top, C.WD_FIELDS)).astype(
            np.int64)).to(dev)
    cents = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32)
                             ).to(dev)
    X[1, :8], dense[1, :8], cat[1, :8] = X[0, :8], dense[0, :8], cat[0, :8]

    def lr(i, n):
        return X[i, :n] @ w + b

    def wd(i, n):
        return W.forward(net, dense[i, :n], cat[i, :n])

    def km(i, n):
        return kmeans_assign_reduce(X[i, :n].contiguous(), cents)[0]

    def tiled(fn):
        def run(i, n):
            if n >= TILE:
                return torch.cat([fn(i, slice(s, s + TILE))
                                  for s in range(0, n, TILE)])
            return fn(i, slice(0, TILE))[:n]
        return run

    def lr_rows(i, sl):
        return X[i, sl] @ w + b

    def wd_rows(i, sl):
        return W.forward(net, dense[i, sl], cat[i, sl])

    def head(fn, i, n):
        with torch.no_grad():
            return fn(i, n)[:8].cpu()

    def report(name, fn):
        heads = {n: head(fn, 0, n) for n in BUCKETS}
        worst = 0
        for a in BUCKETS:
            for c in BUCKETS:
                if c <= a:
                    continue
                diff = int((heads[a] != heads[c]).sum())
                worst = max(worst, diff)
                print(f"{name}: buckets {a} vs {c}: {diff} of 8 rows "
                      f"differ", flush=True)
        # same bucket, other neighbours: draw 1 shares draw 0's first 8
        # rows and nothing else
        neigh = sum(int((head(fn, 0, n) != head(fn, 1, n)).sum())
                    for n in BUCKETS[1:])
        print(f"{name}: rows differing with other neighbours in the same "
              f"bucket: {neigh}; worst bucket pair {worst} [{card}]",
              flush=True)

    def med_ms(fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        with torch.no_grad():
            for rep in range(REPS + 3):
                start.record()
                fn(0, n)
                end.record()
                torch.cuda.synchronize()
                if rep >= 3:
                    times.append(start.elapsed_time(end))
        return statistics.median(times)

    for name, fn, rows_fn in (("LR d 64", lr, lr_rows),
                              ("Wide&Deep bench width", wd, wd_rows),
                              ("B5 k 256 d 64", km, None)):
        report(name, fn)
        if rows_fn is None:
            continue
        tfn = tiled(rows_fn)
        report(f"{name}, tiles of {TILE}", tfn)
        for n in BUCKETS:
            print(f"{name}: bucket {n}: {med_ms(fn, n):.4f} ms as one "
                  f"product, {med_ms(tfn, n):.4f} ms in tiles of {TILE} "
                  f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
