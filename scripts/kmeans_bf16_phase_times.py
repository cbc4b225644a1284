#!/usr/bin/env python3
"""Where the time of the bf16 KMeans stats kernel goes, on the card.

    python3 scripts/kmeans_bf16_phase_times.py [--against DIR]

Builds variants of ``flink_ml_tpu_torch/kernels/csrc/kmeans_bf16.cu`` with
one or more of its phases switched off (the bulk copies of the f32 tiles,
the converter warps' bf16 tiles, the score product with its epilogue, the
sums product with its share fragments), into ``kernels/build/phases/``,
and times each at the headline (2^20 x 64 points, k = 256, seeded N(0,1)
points, the first 256 points as centroids) for every tie policy: CUDA
events over 20 back-to-back launches, warm L2.  A variant with a phase
switched off computes wrong results; only its time is read (with the
loads off the converters read whatever the ring holds; with the scores
off the sums read stale masks).  With ``--against DIR`` (a checkout of
another commit) DIR's ``kmeans_bf16.cu`` is built as one more variant,
``against``, and timed in turn with this checkout's (against, full, full,
against), so the two are compared on one card in one call.  Prints the
nvcc report (registers, spills) of the full variant, and a trace: the SM
cycles a tile that each consumer warpgroup spends in each span between
``clock64()`` marks (``TRACE_MARKS``), read by thread 0 of the group in a
build with the marks put in (its previous mark kept in shared memory).  Needs one NVIDIA GPU and nvcc.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the code each switch guards: (text in the source, text with the switch)
SWITCHES = [
    ("    } else if (pt == 0 && bulk) {",
     "    } else if (pt == 0 && bulk && LOAD_ON) {"),
    ("    if (from_ring) mbar_wait(full + s, (i / plan.stages) & 1);",
     "    if (from_ring && LOAD_ON) mbar_wait(full + s, (i / plan.stages) & 1);"),
    ("    if (from_ring && (d & 3) == 0)\n",
     "    if (!CONV_ON) {} else if (from_ring && (d & 3) == 0)\n"),
    ("    score_tile<POLICY>(", "    if (SCORE_ON) score_tile<POLICY>("),
    ("  if (wg < nmb) {", "  if (SUMS_ON && wg < nmb) {"),
]
# name: (load, conv, score, sums)
VARIANTS = {"full": (1, 1, 1, 1), "no_sums": (1, 1, 1, 0),
            "no_score": (1, 1, 0, 1), "no_load": (0, 1, 1, 1),
            "load_conv": (1, 1, 0, 0), "load_only": (1, 0, 0, 0),
            "nothing": (0, 0, 0, 0)}
POLICIES = {"first": 0, "fast": 1, "split": 2}

# The trace variant: every phase on, thread 0 of each consumer warpgroup
# reads clock64() at these marks and adds the cycles since its previous
# mark to the mark's slot (summed over blocks; atomics in this build only).
TRACE_MARKS = [
    ("    mbar_wait(converted + b, (i / kBufs) & 1);\n", 0,
     "wait for the converted tile"),
    ("  fence_regs(acc);\n", 1, "score: a product launched and awaited"),
    ("      mm[e >> 1][(2 * j + e) & 3] = fminf(mm[e >> 1][(2 * j + e) & 3], v);"
     "\n    }\n  }\n", 2, "score: scores and minima (a product)"),
    ("    warp_arrive(ready + b);\n", 3,
     "score: tie bits, merge, masks, shares"),
    ("  mbar_wait(ready + b, (j / kBufs) & 1);\n", 4,
     "wait for the other group's scores"),
    ("  warp_arrive(freeb + b);\n", 5, "sums: fragments and products"),
]
TRACE_HEAD = r"""
__device__ unsigned long long g_prof[2][8];
__shared__ long long g_last[2];  // a group's previous mark (0: none yet)
#define PROF_MARK(slot)                                                 \
  do {                                                                  \
    if ((threadIdx.x & 127) == 0) {                                     \
      const long long t_ = clock64();                                   \
      long long* l_ = &g_last[threadIdx.x >> 7];                        \
      if (*l_)                                                          \
        atomicAdd(&g_prof[threadIdx.x >> 7][slot],                      \
                  static_cast<unsigned long long>(t_ - *l_));           \
      *l_ = t_;                                                         \
    }                                                                   \
  } while (0)
"""
TRACE_TAIL = r"""
extern "C" int kmeans_bf16_prof_reset() {
  static unsigned long long z[2 * 8];
  return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
}
extern "C" int kmeans_bf16_prof_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, 16 * 8));
}
"""


def trace_source(src):
    """``src`` with the trace marks put in."""
    for anchor, slot, _ in TRACE_MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"kmeans_bf16.cu changed; update TRACE_MARKS "
                     f"({anchor!r})")
        src = src.replace(anchor, anchor + f"PROF_MARK({slot});\n")
    start = "  fence_proxy_async();\n  __syncthreads();\n"
    if src.count(start) != 1:
        sys.exit("kmeans_bf16.cu changed; update trace_source")
    src = src.replace(start, "  if (tid < 2) g_last[tid] = 0;\n" + start)
    head = "namespace {\n"
    return (src.replace(head, TRACE_HEAD + head, 1) + TRACE_TAIL)


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

    src = open(os.path.join(build.CSRC_DIR, "kmeans_bf16.cu")).read()
    for plain, switched in SWITCHES:
        if plain not in src:
            sys.exit(f"kmeans_bf16.cu changed; update SWITCHES ({plain!r})")
        src = src.replace(plain, switched)
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "kmeans_bf16_phases.cu")
    with open(cu + ".tmp", "w") as f:
        f.write(src)
    os.replace(cu + ".tmp", cu)
    flags = list(build.NVCC_FLAGS)
    trace_cu = os.path.join(out_dir, "kmeans_bf16_trace.cu")
    with open(trace_cu + ".tmp", "w") as f:
        f.write(trace_source(open(os.path.join(
            build.CSRC_DIR, "kmeans_bf16.cu")).read()))
    os.replace(trace_cu + ".tmp", trace_cu)
    procs = {"trace": (os.path.join(out_dir, "libbf16_trace.so"),
                       subprocess.Popen(
                           [build.nvcc_path(), *flags, "-o",
                            os.path.join(out_dir, "libbf16_trace.so"),
                            trace_cu],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True))}
    for name, (load, conv, score, sums) in VARIANTS.items():
        lib = os.path.join(out_dir, f"libbf16_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, f"-DLOAD_ON={load}",
             f"-DCONV_ON={conv}", f"-DSCORE_ON={score}",
             f"-DSUMS_ON={sums}", "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    if args.against:
        lib = os.path.join(out_dir, "libbf16_against.so")
        procs["against"] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", lib, os.path.join(
                os.path.abspath(args.against), "flink_ml_tpu_torch",
                "kernels", "csrc", "kmeans_bf16.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        if name == "full":
            print("nvcc report (full):\n" + "\n".join(
                line for line in log.splitlines()
                if "registers" in line or "spill" in line
                or "kmeans_bf16_kernel" in line or "C75" in line))
    order = [v for v in procs if v != "trace"]
    if args.against:
        order = ["against", "full", "full", "against"] + [
            v for v in order if v not in ("against", "full")]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    n, d, k = 1 << 20, 64, 256
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(n, d, generator=gen).cuda()
    cents = pts[:k].clone()
    sums = torch.empty(k, d, device="cuda")
    counts = torch.empty(k, device="cuda")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in order:
        lib = ctypes.CDLL(procs[name][0])
        lib.kmeans_bf16_grid.argtypes = [ci, ci, ci, ci,
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int64)]
        lib.kmeans_bf16_launch.argtypes = [ci] + [vp] * 5 + [ci] * 4 + [vp]
        for pol_name, pol in POLICIES.items():
            grid, size = ctypes.c_int(0), ctypes.c_int64(0)
            if lib.kmeans_bf16_grid(pol, n, k, d, ctypes.byref(grid),
                                    ctypes.byref(size)):
                sys.exit(f"{name}: planning failed")
            scratch = torch.empty(size.value, device="cuda")

            def run():
                return lib.kmeans_bf16_launch(
                    pol, pts.data_ptr(), cents.data_ptr(),
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
            print(f"{name:10s} {pol_name:6s} "
                  f"{start.elapsed_time(end) / 20:.4f} ms [{card}]",
                  flush=True)

    # cycles a tile in each traced span, per consumer warpgroup
    lib = ctypes.CDLL(procs["trace"][0])
    lib.kmeans_bf16_grid.argtypes = [ci, ci, ci, ci,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.kmeans_bf16_launch.argtypes = [ci] + [vp] * 5 + [ci] * 4 + [vp]
    lib.kmeans_bf16_prof_read.argtypes = [vp]
    ntiles = (n + 127) // 128
    for pol_name, pol in POLICIES.items():
        grid, size = ctypes.c_int(0), ctypes.c_int64(0)
        lib.kmeans_bf16_grid(pol, n, k, d, ctypes.byref(grid),
                             ctypes.byref(size))
        scratch = torch.empty(size.value, device="cuda")
        out = (ctypes.c_ulonglong * 16)()
        for _ in range(2):  # the second run is read
            torch.cuda.synchronize()
            lib.kmeans_bf16_prof_reset()
            if lib.kmeans_bf16_launch(
                    pol, pts.data_ptr(), cents.data_ptr(), scratch.data_ptr(),
                    sums.data_ptr(), counts.data_ptr(), n, k, d, grid.value,
                    torch.cuda.current_stream().cuda_stream):
                sys.exit("trace: launch failed")
            torch.cuda.synchronize()
        lib.kmeans_bf16_prof_read(ctypes.cast(out, vp))
        for wg in range(2):
            spans = ", ".join(
                f"{label} {out[8 * wg + slot] / ntiles:.0f}"
                for _, slot, label in TRACE_MARKS)
            print(f"trace {pol_name} group {wg}: cycles a tile: {spans} "
                  f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
