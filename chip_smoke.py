#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``flink_ml_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100) and the CUDA toolkit; run from the root of a
checkout.  Phases, in order (any failure exits nonzero, before the last
line is printed):

1. Device: fail without CUDA; print the card's name and power limit.
2. Build: compile every kernel under ``flink_ml_tpu_torch/kernels/csrc``
   (one nvcc per source, all at once) and print the seconds and nvcc's
   register/shared-memory report.
3. Kernels vs plain versions on the card, at the main path's shapes
   (2^20 features = 8192 table rows, batch 2^15, 26 categorical slots with
   the label marker in slot 0); the pair kernel at 128*1001 features.
   With and without the per-slot ``val``.  Fails past the stated
   tolerance.
4. Main path: ``LogisticRegression(device="cuda")`` fit at 2^20 features,
   batch 2^15, 3 epochs over 2^18 Criteo-shaped rows (numpy seed 0), then
   ``transform``.  Checks: the loss falls every epoch, the plan is "ell",
   the margin and fused-scatter kernels launched steps x epochs times,
   one epoch's weights match the same fit through the plain versions on
   the card, and predictions match numpy scoring of the fitted weights.
   Then a small fit at 128*1001 features, the pair kernel's path.
5. Times (CUDA events, median, L2 flushed before each launch): each
   kernel, its plain version and one PyTorch library call computing the
   same function, beside the bound computed from bytes; epochs/s.

The last lines are the kernel table as one JSON object, the card line
from nvidia-smi, and ``{"ok": true, "device": {...}}``.  The script
imports neither JAX nor the JAX package.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

D_MAIN = 1 << 20            # hash-space size (the Criteo configuration)
BATCH = 1 << 15             # global batch
ROWS = 1 << 18              # 8 steps of 2^15
N_DENSE, N_CAT = 13, 26
EPOCHS = 3
D_PAIR = 128 * 1001         # 1001 table rows: not a multiple of 8
PAIR_ROWS, PAIR_BATCH = 1 << 14, 1 << 12
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)

SOURCE = "flink_ml_tpu_torch/kernels/csrc/ell_scatter.cu"
REPLACES = {
    "ell_margin": "flink_ml_tpu/ops/ell_scatter.py:790",
    "ell_scatter_apply_fused": "flink_ml_tpu/ops/ell_scatter.py:617",
    "ell_scatter_apply": "flink_ml_tpu/ops/ell_scatter.py:548",
}
# Tolerances of kernel vs plain version.  The margin kernel sums with
# atomics in a run-dependent order: ~25 f32 terms of |w| <= ~5 per sample
# reorder to within ~1e-5; the scatters add in a fixed order and are
# expected to match bit for bit.
TOL = {"ell_margin": 1e-4, "ell_scatter_apply_fused": 1e-6,
       "ell_scatter_apply": 1e-6}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def criteo_rows(n, d, seed):
    """Criteo-shaped rows: 13 dense N(0,1) features, 26 hashed categorical
    indices in [32, d), labels driven by marker slot 0 in {16, 17} (the
    JAX package's benchmark data, ``bench.py:118-130``)."""
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, N_DENSE)).astype(np.float32)
    cat = rng.integers(32, d, size=(n, N_CAT)).astype(np.int32)
    y = rng.integers(0, 2, size=n).astype(np.float64)
    cat[:, 0] = np.where(y == 1, 16, 17)
    return dense, cat, y


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class Timer:
    """Median milliseconds of ``fn`` over CUDA events.  Before each launch
    a 128 MB write evicts the 50 MB L2 (the training loop meets each
    step's layout cold), and a device sleep lets the host enqueue the
    launch before the start event fires, so host overhead stays out."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def ms(self, fn, reps=25, warm=3):
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main():
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU")
    try:
        import flink_ml_tpu_torch
    except ImportError as exc:
        fail(f"flink_ml_tpu_torch is not importable ({exc}); run from the "
             "root of a checkout")
    pkg_dir = os.path.dirname(os.path.abspath(flink_ml_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"flink_ml_tpu_torch came from {pkg_dir}, not this checkout")
    from flink_ml_tpu_torch import LogisticRegression, Table
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.models.common.losses import LOSSES
    from flink_ml_tpu_torch.ops import ell_scatter as E

    dev = torch.device(DEVICE)
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    secs = build.build_all()
    log(f"build: {secs:.2f} s (0 = already built)")
    log("nvcc report:\n" + (build.build_log("ell_scatter") or "(none)"))

    # -- 3. kernels vs plain versions at the main path's shapes ------------
    dense1, cat1, _ = criteo_rows(BATCH, D_MAIN, seed=1)
    lay = E.ell_layout(cat1[None], D_MAIN).to(dev)
    rows = D_MAIN // 128
    m_len = S._ext_len(BATCH)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=D_MAIN).astype(np.float32)).to(dev)
    r = rng.normal(size=BATCH).astype(np.float32) / BATCH
    r_ext = S._extended_r(torch.from_numpy(r).to(dev))
    val = torch.from_numpy(rng.normal(size=(rows, 128)).astype(np.float32)
                           ).to(dev)
    src, pos, mask = lay.src[0], lay.pos[0], lay.mask[0]
    lr = 0.5
    log(f"layout at {D_MAIN} features: kept slots {int((src != BATCH).sum())}, overflow "
        f"{int(lay.need_ovf[0])}, heavy indices {int(lay.need_heavy[0])}")

    err = {}

    def check(name, got, want):
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err[name] = max(err.get(name, 0.0), e)
        log(f"check {name}: max |kernel - plain| = {e:.3e} "
            f"(tolerance {TOL[name]:.0e})")
        if not e <= TOL[name]:
            fail(f"{name} disagrees with its plain version")

    for v in (None, val):
        check("ell_margin",
              E.ell_margin(w, src, pos, mask, m_len=m_len, val=v)[:BATCH],
              E.ell_margin_plain(w, src, pos, mask, m_len=m_len,
                                 val=v)[:BATCH])
        check("ell_scatter_apply_fused",
              E.ell_scatter_apply_fused(w, r_ext, src, pos, mask, lr=lr,
                                        val=v),
              E.ell_scatter_apply_fused_plain(w, r_ext, src, pos, mask,
                                              lr=lr, val=v))
    _, cat_p, _ = criteo_rows(BATCH, D_PAIR, seed=3)
    lay_p = E.ell_layout(cat_p[None], D_PAIR).to(dev)
    w_p = torch.from_numpy(rng.normal(size=D_PAIR).astype(np.float32)
                           ).to(dev)
    rows_p = D_PAIR // 128
    val_p = torch.from_numpy(
        rng.normal(size=(rows_p, 128)).astype(np.float32)).to(dev)
    for v in (None, val_p):
        g = E.gather_weights(r_ext, lay_p.src[0])
        upd = (-lr) * (g if v is None else v * g)
        check("ell_scatter_apply",
              E.ell_scatter_apply(w_p, upd, lay_p.pos[0], lay_p.mask[0]),
              E.ell_scatter_apply_plain(w_p, upd, lay_p.pos[0],
                                        lay_p.mask[0]))

    # -- 4. main path ------------------------------------------------------
    dense, cat, y = criteo_rows(ROWS, D_MAIN, seed=0)
    table = Table({"features_dense": dense, "features_indices": cat,
                   "label": y})
    steps = ROWS // BATCH

    def estimator(epochs):
        return (LogisticRegression(device=DEVICE).set_num_features(D_MAIN)
                .set_global_batch_size(BATCH).set_max_iter(epochs)
                .set_tol(0))

    E.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = estimator(EPOCHS).fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(E.LAUNCHES)
    log(f"main path: fit {fit_s:.3f} s, loss log {model.loss_log}, "
        f"plan {model.planned_impl}, launches {launches}")
    losses = model.loss_log
    if len(losses) != EPOCHS or not all(np.isfinite(losses)):
        fail(f"loss log {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"loss did not fall every epoch: {losses}")
    if model.planned_impl != "ell":
        fail(f"planned {model.planned_impl!r}, expected 'ell'")
    for name in ("ell_margin", "ell_scatter_apply_fused"):
        if launches[name] != steps * EPOCHS:
            fail(f"{name} launched {launches[name]} times on the main "
                 f"path, expected {steps * EPOCHS}")
    if launches["ell_scatter_apply"] != 0:
        fail("the pair kernel ran on a grid of 8192 rows")

    cfg = estimator(1)._sgd_config()
    one_k, _ = S.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                               D_MAIN, cfg, device=dev)
    one_p, _ = S.sgd_fit_mixed(LOSSES["logistic"], dense, cat, y, None,
                               D_MAIN, cfg, device=dev, plain=True)
    diff = float(np.max(np.abs(one_k.coefficients - one_p.coefficients)))
    log(f"one epoch, kernels vs plain versions on the card: max |dw| = "
        f"{diff:.3e} (allclose rtol 1e-3, atol 1e-4)")
    if not np.allclose(one_k.coefficients, one_p.coefficients, rtol=1e-3,
                       atol=1e-4):
        fail("the kernels' epoch diverged from the plain versions' epoch")

    t_dense, t_cat, t_y = criteo_rows(4096, D_MAIN, seed=9)
    (out,) = model.transform(Table({"features_dense": t_dense,
                                    "features_indices": t_cat}))
    coef = model.get_model_data()[0]["coefficients"][0]
    icpt = float(model.get_model_data()[0]["intercept"][0])
    margin = t_dense.astype(np.float64) @ coef[:N_DENSE] \
        + coef[t_cat].sum(axis=1) + icpt
    prob = 1.0 / (1.0 + np.exp(-margin))
    perr = float(np.max(np.abs(out["rawPrediction"] - prob)))
    acc = float(np.mean(out["prediction"] == t_y))
    log(f"transform: {len(t_y)} rows, max |p - numpy p| = {perr:.3e}, "
        f"accuracy {acc:.4f}")
    if out["rawPrediction"].shape != (4096,) or not np.all(
            np.isfinite(out["rawPrediction"])) or perr > 1e-5:
        fail("transform disagrees with numpy scoring of the fitted weights")
    if acc < 0.99:
        fail(f"the fit did not learn the label marker (accuracy {acc})")

    # the pair kernel's path: a grid of 1001 rows
    p_dense, p_cat, p_y = criteo_rows(PAIR_ROWS, D_PAIR, seed=4)
    p_table = Table({"features_dense": p_dense, "features_indices": p_cat,
                     "label": p_y})
    p_est = (LogisticRegression(device=DEVICE).set_num_features(D_PAIR)
             .set_global_batch_size(PAIR_BATCH).set_max_iter(2).set_tol(0))
    E.reset_launch_counts()
    p_model = p_est.fit(p_table)
    torch.cuda.synchronize()
    pair_launches = dict(E.LAUNCHES)
    log(f"pair path ({rows_p} table rows): plan {p_model.planned_impl}, "
        f"loss log {p_model.loss_log}, launches {pair_launches}")
    pair_steps = PAIR_ROWS // PAIR_BATCH * 2
    if pair_launches["ell_scatter_apply"] != pair_steps \
            or pair_launches["ell_margin"] != pair_steps \
            or pair_launches["ell_scatter_apply_fused"] != 0:
        fail("the pair kernel did not carry the 1001-row fit")
    p_plain, _ = S.sgd_fit_mixed(LOSSES["logistic"], p_dense, p_cat, p_y,
                                 None, D_PAIR, p_est._sgd_config(),
                                 device=dev, plain=True)
    p_coef = p_model.get_model_data()[0]["coefficients"][0]
    if not np.allclose(p_coef, p_plain.coefficients, rtol=1e-3, atol=1e-4):
        fail("the pair path diverged from the plain versions")

    # -- 5. times ----------------------------------------------------------
    timer = Timer(torch, dev)
    lanes, _ = E._slot_lanes(pos, mask)
    kept = src < BATCH
    slot_w = (torch.arange(rows, device=dev)[:, None] * 128 + lanes)[kept]
    slot_src = src[kept].long()
    slot_g = w[slot_w]
    slot_u = (-lr) * r_ext[slot_src]
    w_scratch = w.clone()
    upd_p = (-lr) * E.gather_weights(r_ext, lay_p.src[0])
    lanes_p, _ = E._slot_lanes(lay_p.pos[0], lay_p.mask[0])
    kept_p = lay_p.src[0] < BATCH
    slot_wp = (torch.arange(rows_p, device=dev)[:, None] * 128
               + lanes_p)[kept_p]
    slot_up = upd_p[kept_p]
    wp_scratch = w_p.clone()

    grid = rows * 128
    ext = r_ext.numel()
    bytes_moved = {
        # src, pos, mask and w read; the margin table written
        "ell_margin": grid * 16 + m_len * 4,
        # src, pos, mask, w and r_ext read; the new w written
        "ell_scatter_apply_fused": grid * 20 + ext * 4,
        # upd, pos, mask, w read; the new w written (1001 rows)
        "ell_scatter_apply": rows_p * 128 * 20,
    }
    runs = {
        "ell_margin": (
            lambda: E.ell_margin(w, src, pos, mask, m_len=m_len),
            lambda: E.ell_margin_plain(w, src, pos, mask, m_len=m_len),
            lambda: torch.zeros(m_len, device=dev).index_add_(
                0, slot_src, slot_g)),
        "ell_scatter_apply_fused": (
            lambda: E.ell_scatter_apply_fused(w, r_ext, src, pos, mask,
                                              lr=lr),
            lambda: E.ell_scatter_apply_fused_plain(w, r_ext, src, pos,
                                                    mask, lr=lr),
            lambda: w_scratch.index_add_(0, slot_w, slot_u)),
        "ell_scatter_apply": (
            lambda: E.ell_scatter_apply(w_p, upd_p, lay_p.pos[0],
                                        lay_p.mask[0]),
            lambda: E.ell_scatter_apply_plain(w_p, upd_p, lay_p.pos[0],
                                              lay_p.mask[0]),
            lambda: wp_scratch.index_add_(0, slot_wp, slot_up)),
    }
    count = {"ell_margin": launches["ell_margin"],
             "ell_scatter_apply_fused": launches["ell_scatter_apply_fused"],
             "ell_scatter_apply": pair_launches["ell_scatter_apply"]}
    kernels = []
    for name, (kern, plain, library) in runs.items():
        ms, plain_ms, lib_ms = (timer.ms(kern), timer.ms(plain),
                                timer.ms(library))
        bound_ms = bytes_moved[name] / HBM_BYTES_PER_S * 1e3
        log(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"(bytes) [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": count[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        })

    # steady-state epochs/s over device-resident epoch tensors (the layout
    # build and the host->device copies of fit() excluded)
    perm = np.random.default_rng(0).permutation(ROWS)
    epoch_lay = E.ell_layout(S.prepare_epoch_tensor(cat, perm, steps, BATCH),
                             D_MAIN).to(dev)

    def put(a):
        return torch.from_numpy(S.prepare_epoch_tensor(
            a, perm, steps, BATCH)).to(dev)

    epoch_args = (put(dense), epoch_lay.src, epoch_lay.pos, epoch_lay.mask,
                  epoch_lay.ovf_idx, epoch_lay.ovf_src, epoch_lay.heavy_idx,
                  epoch_lay.heavy_cnt, put(y.astype(np.float32)),
                  put(np.ones(ROWS, np.float32)))
    rates = {}
    for label, plain in (("kernels", False), ("plain", True)):
        update = S._mixed_update_ell(LOSSES["logistic"], cfg, plain=plain)
        run_cfg = dataclasses.replace(cfg, max_epochs=EPOCHS)
        init = {"w": torch.zeros(D_MAIN, device=dev),
                "b": torch.zeros((), device=dev)}
        S._run_minibatch_epochs(update, epoch_args, init, steps, run_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S._run_minibatch_epochs(update, epoch_args, init, steps, run_cfg)
        torch.cuda.synchronize()
        rates[label] = EPOCHS / (time.perf_counter() - t0)
    log(f"epochs/s at 2^20 features, batch 2^15, {steps} steps/epoch: "
        f"kernels {rates['kernels']:.3f}, plain versions "
        f"{rates['plain']:.3f}; fit() wall {fit_s:.3f} s for {EPOCHS} "
        f"epochs incl. layout build [{card}]")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
