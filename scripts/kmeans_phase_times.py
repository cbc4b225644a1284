#!/usr/bin/env python3
"""Where the time of the KMeans kernel goes, on the card.

    python3 scripts/kmeans_phase_times.py [--against DIR]

Builds variants of ``flink_ml_tpu_torch/kernels/csrc/kmeans.cu`` with one
or more of its phases switched off (the tile load, the scoring products of
both scoring paths, the tensor-core path's fold of its sums into
candidates, the keyed reduce), into ``kernels/build/phases/``, and
times each at the headline (2^20 x 64 points, k = 256, seeded N(0,1) points, the first 256
points as centroids) in the stats mode (``first``) and the workset mode:
CUDA events over 20 back-to-back launches, warm L2.  Beside them, whole
kernels with one change each (``SHAPES``): 2 m-tiles' tensor-core products
interleaved instead of 4, and the hi*hi products alone.  A variant with a phase switched off computes
wrong results; only its time is read.  Switching the scoring off sends
every point to one cluster, so the variants without scoring measure a
reduce that one warp does alone.  With ``--against DIR`` (a checkout of
another commit) DIR's ``kmeans.cu`` is built as one more variant,
``against``, and timed in turn with this checkout's (against, full, full,
against), so the two designs are compared on one card in one call.
Needs one NVIDIA GPU and nvcc.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the code each switch guards: (text in the source, text with the switch)
SWITCHES = [
    ("for (int base = 0; base < rows; base += 32) {",
     "for (int base = 0; base < (REDUCE_ON ? rows : 0); base += 32) {"),
    ("      if (has) {\n", "      if (has && SCORE_ON) {\n"),
    ("for (int idx = threadIdx.x; idx < kTile * d; idx += kThreads) {",
     "for (int idx = threadIdx.x; idx < (LOAD_ON ? kTile * d : 0); "
     "idx += kThreads) {"),
    ("    if (!has) continue;\n", "    if (!has || !FOLD_ON) continue;\n"),
]
# name: (score, reduce, load, fold); the fold is the tensor-core path's
# reading of its sums into candidates (off, the products go unused too)
VARIANTS = {"full": (1, 1, 1, 1), "no_reduce": (1, 0, 1, 1),
            "no_load": (1, 1, 0, 1), "score_only": (1, 0, 0, 1),
            "load_only": (0, 0, 1, 0), "fold_only": (0, 0, 0, 1),
            "nothing": (0, 0, 0, 0)}
# whole kernels built with the source changed: 2 m-tiles' tensor-core
# products interleaved instead of kmeans.cu's kMtGroup = 4; the hi*hi
# products alone (1xTF32: the other two terms' share of the time)
SHAPES = {
    "mt2": [("constexpr int kMtGroup = 4;", "constexpr int kMtGroup = 2;")],
    "hh_only": [
        ("mma_tf32(acc[m0 + m][nt], al[m], bh[2 * nt], bh[2 * nt + 1]);",
         ";"),
        ("mma_tf32(acc[m0 + m][nt], ah[m], bl[2 * nt], bl[2 * nt + 1]);",
         ";")],
}
MODES = {"first": 0, "workset": 4}


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a checkout of another commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from flink_ml_tpu_torch.kernels import build

    src = open(os.path.join(build.CSRC_DIR, "kmeans.cu")).read()
    for plain, switched in SWITCHES:
        if plain not in src:
            sys.exit(f"kmeans.cu changed; update SWITCHES ({plain!r})")
        src = src.replace(plain, switched)
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "kmeans_phases.cu")
    with open(cu + ".tmp", "w") as f:
        f.write(src)
    os.replace(cu + ".tmp", cu)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs = {}
    for name, (score, reduce, load, fold) in VARIANTS.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, f"-DSCORE_ON={score}",
             f"-DREDUCE_ON={reduce}", f"-DLOAD_ON={load}",
             f"-DFOLD_ON={fold}", "-o", lib, cu]))
    base = open(os.path.join(build.CSRC_DIR, "kmeans.cu")).read()
    for name, edits in SHAPES.items():
        text = base
        for plain, changed in edits:
            if plain not in text:
                sys.exit(f"kmeans.cu changed; update SHAPES ({plain!r})")
            text = text.replace(plain, changed)
        shape_cu = os.path.join(out_dir, f"kmeans_{name}.cu")
        with open(shape_cu + ".tmp", "w") as f:
            f.write(text)
        os.replace(shape_cu + ".tmp", shape_cu)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-DSCORE_ON=1", "-DREDUCE_ON=1",
             "-DLOAD_ON=1", "-DFOLD_ON=1", "-o", lib, shape_cu]))
    if args.against:
        lib = os.path.join(out_dir, "libagainst.so")
        procs["against"] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", lib, os.path.join(
                os.path.abspath(args.against), "flink_ml_tpu_torch",
                "kernels", "csrc", "kmeans.cu")]))
    for name, (_, proc) in procs.items():
        if proc.wait(timeout=600) != 0:
            sys.exit(f"nvcc failed for {name}")
    order = list(procs)
    if args.against:
        order = ["against", "full", "full", "against"] + [
            v for v in procs if v not in ("against", "full")]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    n, d, k = 1 << 20, 64, 256
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(n, d, generator=gen).cuda()
    cents = pts[:k].clone()
    prev = torch.zeros(n, dtype=torch.int32, device="cuda")
    ones = torch.ones(n, device="cuda")
    outs = [torch.empty(n, dtype=torch.int32, device="cuda"),
            torch.empty(n, device="cuda"), torch.empty(n, device="cuda")]
    sums = torch.empty(k, d, device="cuda")
    counts = torch.empty(k, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in order:
        path = procs[name][0]
        lib = ctypes.CDLL(path)
        lib.kmeans_grid.argtypes = [ci, ci, ci, ci,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.kmeans_launch.argtypes = [ci] + [vp] * 11 + [ci] * 4 + [vp]
        for mode_name, mode in MODES.items():
            grid, size = ctypes.c_int(0), ctypes.c_int64(0)
            if lib.kmeans_grid(mode, n, k, d, ctypes.byref(grid),
                               ctypes.byref(size)):
                sys.exit(f"{name}: planning failed")
            scratch = torch.empty(size.value, device="cuda")

            def run():
                return lib.kmeans_launch(
                    mode, pts.data_ptr(), cents.data_ptr(), prev.data_ptr(),
                    ones.data_ptr(), ones.data_ptr(), outs[0].data_ptr(),
                    outs[1].data_ptr(), outs[2].data_ptr(),
                    scratch.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                    n, k, d, grid.value,
                    torch.cuda.current_stream().cuda_stream)

            for _ in range(3):
                if run():
                    sys.exit(f"{name}: launch failed")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            print(f"{name:11s} {mode_name:8s} {start.elapsed_time(end) / 20:.4f}"
                  f" ms [{card}]", flush=True)


if __name__ == "__main__":
    main()
