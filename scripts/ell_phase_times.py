#!/usr/bin/env python3
"""Where the time of the ELL margin and fused-scatter kernels goes, on the
card, and how they compare with an earlier design.

    python3 scripts/ell_phase_times.py [--against DIR]

At the LR main path's shapes (``chip_smoke.py`` phase 3: 2^20 features =
8192 table rows, batch 2^15, 26 Criteo-shaped categorical slots, numpy
seed 1; the pair kernel at 128*1001 features, seed 3), with the L2
flushed before each launch (``chip_smoke.Timer``: median of 25):

1. Variants of ``flink_ml_tpu_torch/kernels/csrc/ell_scatter.cu`` with one
   memory phase switched off, built into ``kernels/build/phases/``: the
   margin without its weight gathers (the routing loads alone) and the
   fused scatter without its ``r_ext`` gather (the row loads, cumsum, pick
   and store alone); those variants compute wrong results, and only their
   times are read.  One more variant builds the pair scatter with 4 table
   rows a block instead of 8; both shapes are held bit for bit to the
   plain version and timed at 1001 rows.  Beside them the design that was not taken,
   ``scripts/ell_ring_variant.cu`` (a persistent grid over a ring of
   bulk-copied rows), held bit for bit to the plain version and timed.
   Then a near-empty launch (the margin over 0 route columns and 128
   samples): the timer's floor.
2. With ``--against DIR`` (a checkout of another commit, e.g. one
   unpacked with ``git archive``): the public wrappers of the package at
   DIR and of this checkout, each in its own process, in the order DIR,
   this, this, DIR, so both designs are timed in one call on one card.
   Either margin signature is understood: ``(w, src, pos, mask)`` before
   the sample routing, ``(w, route_w)`` after.

Prints the card's name and power limit beside every time.  Needs one
NVIDIA GPU and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the code each switch guards: (text in the source, text with the switch)
SWITCHES = {
    "margin_no_gather": (
        "? __ldg(w + idx[j]) : 0.0f;",
        "? static_cast<float>(idx[j]) : 0.0f;"),
    "fused_no_gather": (
        "? __ldg(r_ext + m) : 0.0f;",
        "? static_cast<float>(m) : 0.0f;"),
    # the pair scatter's other block shape: 4 table rows a block
    "pair_rows4": (
        "constexpr int kPairRows = 8;",
        "constexpr int kPairRows = 4;"),
}
# the fused scatter as a persistent grid over a ring of bulk-copied rows
RING = os.path.join(HERE, "scripts", "ell_ring_variant.cu")


def inputs(torch, E, S, root):
    """The main path's phase-3 inputs on the card."""
    import numpy as np

    sys.path.insert(0, root)
    from chip_smoke import BATCH, D_MAIN, D_PAIR, criteo_rows

    dev = torch.device("cuda")
    _, cat, _ = criteo_rows(BATCH, D_MAIN, seed=1)
    lay = E.ell_layout(cat[None], D_MAIN).to(dev)
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=D_MAIN).astype(np.float32)).to(dev)
    r = rng.normal(size=BATCH).astype(np.float32) / BATCH
    r_ext = S._extended_r(torch.from_numpy(r).to(dev))
    _, cat_p, _ = criteo_rows(BATCH, D_PAIR, seed=3)
    lay_p = E.ell_layout(cat_p[None], D_PAIR).to(dev)
    w_p = torch.from_numpy(rng.normal(size=D_PAIR).astype(np.float32)
                           ).to(dev)
    upd_p = -0.5 * E.gather_weights(r_ext, lay_p.src[0])
    return dict(src=lay.src[0], pos=lay.pos[0], mask=lay.mask[0], w=w,
                r_ext=r_ext, m_len=S._ext_len(BATCH), batch=BATCH, w_p=w_p,
                upd_p=upd_p, pos_p=lay_p.pos[0], mask_p=lay_p.mask[0])


def worker(root):
    """Times the public wrappers of the package at ``root``; prints one
    JSON line."""
    import torch

    sys.path.insert(0, root)
    from chip_smoke import Timer
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.ops import ell_scatter as E

    build.build_all(["ell_scatter"])
    x = inputs(torch, E, S, root)
    if hasattr(E, "sample_routing"):
        route_w, _ = E.sample_routing(x["src"], x["pos"], x["mask"],
                                      x["batch"])

        def margin():
            return E.ell_margin(x["w"], route_w, m_len=x["m_len"])
    else:
        def margin():
            return E.ell_margin(x["w"], x["src"], x["pos"], x["mask"],
                                m_len=x["m_len"])
    timer = Timer(torch, torch.device("cuda"))
    print(json.dumps({
        "root": root,
        "ell_margin": timer.ms(margin),
        "ell_scatter_apply_fused": timer.ms(
            lambda: E.ell_scatter_apply_fused(
                x["w"], x["r_ext"], x["src"], x["pos"], x["mask"], lr=0.5)),
        "ell_scatter_apply": timer.ms(
            lambda: E.ell_scatter_apply(x["w_p"], x["upd_p"], x["pos_p"],
                                        x["mask_p"])),
    }), flush=True)


def variants(card):
    """Builds and times the switched variants of this checkout's kernels."""
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import Timer
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.ops import ell_scatter as E

    src = open(os.path.join(build.CSRC_DIR, "ell_scatter.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs = {"ring": (os.path.join(out_dir, "libell_ring.so"),
                      subprocess.Popen([build.nvcc_path(), *flags, "-o",
                                        os.path.join(out_dir,
                                                     "libell_ring.so"),
                                        RING]))}
    for name, (plain, switched) in [("full", ("", "")),
                                    *SWITCHES.items()]:
        if plain and plain not in src:
            sys.exit(f"ell_scatter.cu changed; update SWITCHES ({name})")
        cu = os.path.join(out_dir, f"ell_{name}.cu")
        with open(cu + ".tmp", "w") as f:
            f.write(src.replace(plain, switched) if plain else src)
        os.replace(cu + ".tmp", cu)
        lib = os.path.join(out_dir, f"libell_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", lib, cu]))
    for name, (_, proc) in procs.items():
        if proc.wait(timeout=600) != 0:
            sys.exit(f"nvcc failed for {name}")

    x = inputs(torch, E, S, HERE)
    route_w, _ = E.sample_routing(x["src"], x["pos"], x["mask"], x["batch"])
    nnz, batch = route_w.shape
    m = torch.empty(x["m_len"], device="cuda")
    out = torch.empty_like(x["w"])
    rows = x["src"].shape[0]
    timer = Timer(torch, torch.device("cuda"))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    want = E.ell_scatter_apply_fused_plain(x["w"], x["r_ext"], x["src"],
                                           x["pos"], x["mask"], lr=0.5)
    want_p = E.ell_scatter_apply_plain(x["w_p"], x["upd_p"], x["pos_p"],
                                       x["mask_p"])
    out_p = torch.empty_like(x["w_p"])
    for name, (path, _) in procs.items():
        lib = ctypes.CDLL(path)
        lib.ell_margin_launch.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci,
                                          vp]
        if name in ("full", "pair_rows4"):
            lib.ell_scatter_pair_launch.argtypes = [vp, vp, vp, vp, vp, ci,
                                                    vp]

            def pair():
                return lib.ell_scatter_pair_launch(
                    x["w_p"].data_ptr(), x["upd_p"].data_ptr(),
                    x["pos_p"].data_ptr(), x["mask_p"].data_ptr(),
                    out_p.data_ptr(), x["pos_p"].shape[0],
                    torch.cuda.current_stream().cuda_stream)

            if pair():
                sys.exit(f"{name}: pair launch failed")
            torch.cuda.synchronize()
            print(f"variant {name:17s} ell_scatter_apply (1001 rows, "
                  f"{8 if name == 'full' else 4} rows a block) "
                  f"{timer.ms(pair):.4f} ms, bit for bit the plain "
                  f"version: {bool(torch.equal(out_p, want_p))} [{card}]",
                  flush=True)
            if name == "pair_rows4":
                continue
        lib.ell_scatter_fused_launch.argtypes = [vp, vp, ci, vp, vp, vp, vp,
                                                 cf, vp, ci, vp]
        if name == "ring":
            lib.ell_ring_fused_launch.argtypes = \
                lib.ell_scatter_fused_launch.argtypes
            lib.ell_scatter_fused_launch = lib.ell_ring_fused_launch

        def margin():
            return lib.ell_margin_launch(
                x["w"].data_ptr(), x["w"].numel(), route_w.data_ptr(), None,
                m.data_ptr(), nnz, batch, x["m_len"],
                torch.cuda.current_stream().cuda_stream)

        def fused():
            return lib.ell_scatter_fused_launch(
                x["w"].data_ptr(), x["r_ext"].data_ptr(),
                x["r_ext"].numel(), x["src"].data_ptr(),
                x["pos"].data_ptr(), x["mask"].data_ptr(), None, 0.5,
                out.data_ptr(), rows,
                torch.cuda.current_stream().cuda_stream)

        if margin() or fused():
            sys.exit(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name == "ring":
            grid = lib.ell_ring_grid(0, (rows + 7) // 8)
            print(f"variant ring: grid {grid} blocks, bit for bit the "
                  f"plain version: "
                  f"{bool(torch.equal(out, want))}; ell_scatter_apply_fused "
                  f"{timer.ms(fused):.4f} ms [{card}]", flush=True)
            continue
        if name == "full":
            if not torch.equal(out, want):
                sys.exit("the fused scatter differs from its plain version")
            floor_m = torch.empty(128, device="cuda")

            def near_empty():
                return lib.ell_margin_launch(
                    x["w"].data_ptr(), x["w"].numel(), route_w.data_ptr(),
                    None, floor_m.data_ptr(), 0, 128, 128,
                    torch.cuda.current_stream().cuda_stream)

            print(f"near-empty launch (the timer's floor) "
                  f"{timer.ms(near_empty):.4f} ms [{card}]", flush=True)
        if name != "fused_no_gather":
            print(f"variant {name:17s} ell_margin {timer.ms(margin):.4f} ms"
                  f" [{card}]", flush=True)
        if name != "margin_no_gather":
            print(f"variant {name:17s} ell_scatter_apply_fused "
                  f"{timer.ms(fused):.4f} ms [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a checkout of another commit")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    variants(card)
    if args.against:
        other = os.path.abspath(args.against)
        for root in (other, HERE, HERE, other):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 root], capture_output=True, text=True, timeout=900,
                cwd=root)
            if run.returncode:
                sys.exit(f"worker at {root} failed:\n{run.stderr[-4000:]}")
            got = json.loads(run.stdout.strip().splitlines()[-1])
            label = "this checkout" if root == HERE else root
            print(f"{label}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in got.items() if k != "root")
                + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
