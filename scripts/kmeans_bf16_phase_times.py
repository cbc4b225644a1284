#!/usr/bin/env python3
"""Where the time of the bf16 KMeans stats kernel goes, on the card.

    python3 scripts/kmeans_bf16_phase_times.py [--against DIR]
    python3 scripts/kmeans_bf16_phase_times.py --wide [--reps N]

Builds variants of ``flink_ml_tpu_torch/kernels/csrc/kmeans_bf16.cu`` with
one or more of its phases switched off into ``kernels/build/phases/``
(one nvcc a variant, all started together) and launches them through
their C interface on the plan of ``ops/kmeans.py::bf16_plan``.  A variant
with a phase switched off computes wrong results; only its time is read.

Default, the fused pass at the headline (2^20 x 64 points, k = 256,
seeded N(0,1) points, the first 256 points as centroids), every tie
policy, CUDA events over 20 back-to-back launches, warm L2.  Its switches
(``SWITCHES``): the bulk copies of the f32 tiles, the converter warps'
bf16 tiles, the score product with its epilogue, the sums product with
its share fragments (with the loads off the converters read whatever the
ring holds; with the scores off the sums read stale masks).  With
``--against DIR`` (a checkout of another commit) DIR's ``kmeans_bf16.cu``
is built as one more variant, ``against``, and timed in turn with this
checkout's (against, full, full, against), so the two are compared on one
card in one call.  Prints the nvcc report (registers, spills) of the full
variant, and a trace: the SM cycles a tile that each consumer warpgroup
spends in each span between ``clock64()`` marks (``TRACE_MARKS``), read by
thread 0 of the group in a build with the marks put in (its previous mark
kept in shared memory).

``--wide``, the two-pass plan at the shapes of ``chip_smoke.py``'s phase
44 (appended part: 2^20 x 64 at k 1024, 2^20 x 128 at k 256, 2^18 x 64 at
k 4096; seeded N(0,1) points, centroids the means of two random points):
for each shape and tie policy ``kmeans_update_stats(...,
compute_dtype=torch.bfloat16)`` runs N times (default 10) under
``torch.profiler`` and the device time of each kernel (pack, norms,
scoring launches, sums, reduce) is printed a call, beside the whole call
timed with CUDA events (warm L2) and the plan.  Then the variants of
``WIDE_SWITCHES`` (the scoring epilogue, the score products, the sums
products with their fragments, the converting launch's conversion or its
stores of the packed panels), each timed whole a call (``first``; full
first and last).  Needs one NVIDIA GPU and nvcc.
"""

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the code each switch guards: (text in the source, text with the switch);
# every switch macro is 1 unless a variant sets it to 0
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
# the two-pass plan's switches
WIDE_SWITCHES = [
    ("                                           int (&cnt)[2]) {\n"
     "  const float inf",
     "                                           int (&cnt)[2]) {\n"
     "  if (!W_EPI_ON) return;\n  const float inf"),
    ("                                              uint32_t b, bool fresh) "
     "{\n",
     "                                              uint32_t b, bool fresh) "
     "{\n  if (!W_MMA_ON) return;\n"),
    ("                                           int q) {\n"
     "  fence_regs(part[0]);\n",
     "                                           int q) {\n"
     "  if (!W_SUMS_ON) return;\n  fence_regs(part[0]);\n"),
    ("  for (int x = 8 * t; x < count; x += 8 * kConverters) {",
     "  for (int x = 8 * t; x < (W_CONV_ON ? count : 0); "
     "x += 8 * kConverters) {"),
    ("            bulk_store(pts_pk + ",
     "            if (W_STORE_ON) bulk_store(pts_pk + "),
]
MACROS = ("LOAD_ON", "CONV_ON", "SCORE_ON", "SUMS_ON", "W_EPI_ON",
          "W_MMA_ON", "W_SUMS_ON", "W_CONV_ON", "W_STORE_ON")
# name: the switches set to 0
VARIANTS = {"full": (), "no_sums": ("SUMS_ON",), "no_score": ("SCORE_ON",),
            "no_load": ("LOAD_ON",), "load_conv": ("SCORE_ON", "SUMS_ON"),
            "load_only": ("CONV_ON", "SCORE_ON", "SUMS_ON"),
            "nothing": ("LOAD_ON", "CONV_ON", "SCORE_ON", "SUMS_ON")}
WIDE_VARIANTS = {
    "full": (), "no_epilogue": ("W_EPI_ON",), "no_products": ("W_MMA_ON",),
    "no_sums": ("W_SUMS_ON",), "no_pack_store": ("W_STORE_ON",),
    "no_conversion": ("W_CONV_ON", "W_STORE_ON"),
    "loads_only": ("W_EPI_ON", "W_MMA_ON", "W_SUMS_ON", "W_CONV_ON",
                   "W_STORE_ON")}
POLICIES = {"first": 0, "fast": 1, "split": 2}
WIDE_SHAPES = ((1 << 20, 64, 1024), (1 << 20, 128, 256),
               (1 << 18, 64, 4096))
# the two-pass kernels as the profiler names them (mangled names hold these)
WIDE_PARTS = ("pack_bf16_kernel", "norms_kernel", "kmeans_bf16_score_kernel",
              "kmeans_bf16_sums_kernel", "reduce_wide_kernel")

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


def switched_source(src):
    """``src`` with every switch of ``SWITCHES`` and ``WIDE_SWITCHES`` put
    in, each macro 1 unless defined."""
    for plain, switched in SWITCHES + WIDE_SWITCHES:
        if src.count(plain) != 1:
            sys.exit(f"kmeans_bf16.cu changed; update the switches "
                     f"({plain!r})")
        src = src.replace(plain, switched)
    return "".join(f"#ifndef {m}\n#define {m} 1\n#endif\n"
                   for m in MACROS) + src


def write(path, text):
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def start_builds(build, jobs):
    """Starts one nvcc for each ``name: (source, output, defines)`` of
    ``jobs``; returns ``name: (output, process)``."""
    return {name: (lib, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS,
         *(f"-D{m}=0" for m in off), "-o", lib, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (cu, lib, off) in jobs.items()}


def finish_builds(procs):
    """Waits for ``start_builds``' processes; returns the nvcc report of
    each (exits where one failed)."""
    logs = {}
    for name, (_, proc) in procs.items():
        logs[name], _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def loader(path, src_text):
    """The library at ``path`` with its C signatures declared, and a
    function ``(policy, pts, cents, sums, counts) -> run()`` that plans
    the launch (``bf16_plan``'s route and chunks where the source takes
    them, as a checkout before that interface did not) and returns a call
    of it."""
    import torch

    from flink_ml_tpu_torch.ops import kmeans as K

    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    planned = "int d, int route, int chunks" in src_text
    extra = [ci, ci] if planned else []
    lib.kmeans_bf16_grid.argtypes = [ci, ci, ci, ci, *extra,
                                     ctypes.POINTER(ci),
                                     ctypes.POINTER(ctypes.c_int64)]
    lib.kmeans_bf16_launch.argtypes = [ci] + [vp] * 5 + [ci] * 3 + extra + [
        ci, vp]

    def launcher(pol, pts, cents, sums, counts):
        (n, d), k = pts.shape, cents.shape[0]
        plan = K.bf16_plan(k, d)
        route = ((0 if plan.route == "fused" else 1, plan.chunks_per_launch)
                 if planned else ())
        grid, size = ci(0), ctypes.c_int64(0)
        if lib.kmeans_bf16_grid(pol, n, k, d, *route, ctypes.byref(grid),
                                ctypes.byref(size)):
            sys.exit(f"{path}: planning failed")
        scratch = torch.empty(size.value, device="cuda")

        def run():
            rc = lib.kmeans_bf16_launch(
                pol, pts.data_ptr(), cents.data_ptr(), scratch.data_ptr(),
                sums.data_ptr(), counts.data_ptr(), n, k, d, *route,
                grid.value, torch.cuda.current_stream().cuda_stream)
            if rc:
                sys.exit(f"{path}: launch failed, CUDA error {rc}")
        return run
    return lib, launcher


def event_ms(torch, run, reps):
    """ms a call of ``run`` over ``reps`` back-to-back calls after 3 warm
    ones, by CUDA events."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wide_problem(torch, n, d, k):
    import numpy as np

    host = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    perm = np.random.default_rng(1).permutation(n)
    return (torch.from_numpy(host).cuda(), torch.from_numpy(
        0.5 * (host[perm[:k]] + host[perm[k:2 * k]])).cuda())


def device_us(evt):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def headline(torch, card, src, procs, against):
    """The fused pass's variants and trace at the headline."""
    logs = finish_builds(procs)
    print("nvcc report (full):\n" + "\n".join(
        line for line in logs["full"].splitlines()
        if "registers" in line or "spill" in line
        or "kmeans_bf16_kernel" in line or "C75" in line))
    order = [v for v in procs if v != "trace"]
    if against:
        order = ["against", "full", "full", "against"] + [
            v for v in order if v not in ("against", "full")]
    n, d, k = 1 << 20, 64, 256
    gen = torch.Generator().manual_seed(0)
    pts = torch.randn(n, d, generator=gen).cuda()
    cents = pts[:k].clone()
    sums = torch.empty(k, d, device="cuda")
    counts = torch.empty(k, device="cuda")
    for name in order:
        text = src
        if name == "against":
            text = open(os.path.join(os.path.abspath(against),
                                     "flink_ml_tpu_torch", "kernels", "csrc",
                                     "kmeans_bf16.cu")).read()
        _, launcher = loader(procs[name][0], text)
        for pol_name, pol in POLICIES.items():
            ms = event_ms(torch, launcher(pol, pts, cents, sums, counts), 20)
            print(f"{name:10s} {pol_name:6s} {ms:.4f} ms [{card}]",
                  flush=True)

    # cycles a tile in each traced span, per consumer warpgroup
    lib, launcher = loader(procs["trace"][0], src)
    lib.kmeans_bf16_prof_read.argtypes = [ctypes.c_void_p]
    ntiles = (n + 127) // 128
    for pol_name, pol in POLICIES.items():
        run = launcher(pol, pts, cents, sums, counts)
        out = (ctypes.c_ulonglong * 16)()
        for _ in range(2):  # the second run is read
            torch.cuda.synchronize()
            lib.kmeans_bf16_prof_reset()
            run()
            torch.cuda.synchronize()
        lib.kmeans_bf16_prof_read(ctypes.cast(out, ctypes.c_void_p))
        for wg in range(2):
            spans = ", ".join(
                f"{label} {out[8 * wg + slot] / ntiles:.0f}"
                for _, slot, label in TRACE_MARKS)
            print(f"trace {pol_name} group {wg}: cycles a tile: {spans} "
                  f"[{card}]", flush=True)


def wide(torch, card, src, procs, reps):
    """The two-pass plan's kernels by the profiler, then its variants."""
    from flink_ml_tpu_torch.ops import kmeans as K

    bf = torch.bfloat16
    finish_builds(procs)
    for n, d, k in WIDE_SHAPES:
        pts, cents = wide_problem(torch, n, d, k)
        for tie in POLICIES:
            def call():
                return K.kmeans_update_stats(pts, cents, tie_policy=tie,
                                             compute_dtype=bf)
            whole = event_ms(torch, call, reps)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    call()
                torch.cuda.synchronize()
            parts = {p: 0.0 for p in WIDE_PARTS}
            other = 0.0
            for evt in prof.key_averages():
                hit = [p for p in WIDE_PARTS if p in evt.key]
                us = device_us(evt) / reps
                if hit:
                    parts[hit[0]] += us
                else:
                    other += us
            text = ", ".join(f"{p} {parts[p] / 1e3:.4f}" for p in WIDE_PARTS)
            print(f"(n {n}, d {d}, k {k}) {tie}: plan "
                  f"{tuple(K.bf16_plan(k, d))}; whole {whole:.4f} ms a call "
                  f"(CUDA events, warm L2); device ms a call by kernel: "
                  f"{text}; other {other / 1e3:.4f} [{card}]", flush=True)
        del pts, cents
    for n, d, k in WIDE_SHAPES:
        pts, cents = wide_problem(torch, n, d, k)
        sums = torch.empty(k, d, device="cuda")
        counts = torch.empty(k, device="cuda")
        times = {}
        for name in ["full", *WIDE_VARIANTS, "full"]:
            _, launcher = loader(procs[name][0], src)
            run = launcher(POLICIES["first"], pts, cents, sums, counts)
            times.setdefault(name, []).append(event_ms(torch, run, reps))
        print(f"(n {n}, d {d}, k {k}) first, variants (ms a call, CUDA "
              f"events, warm L2): " + ", ".join(
                  f"{name} " + "/".join(f"{t:.4f}" for t in ts)
                  for name, ts in times.items()) + f" [{card}]", flush=True)
        del pts, cents


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a checkout of another commit")
    ap.add_argument("--wide", action="store_true",
                    help="the two-pass plan at phase 44's wide shapes")
    ap.add_argument("--reps", type=int, default=10,
                    help="calls a time under --wide")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    sys.path.insert(0, HERE)
    from flink_ml_tpu_torch.kernels import build

    src = open(os.path.join(build.CSRC_DIR, "kmeans_bf16.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "kmeans_bf16_phases.cu")
    write(cu, switched_source(src))
    variants = WIDE_VARIANTS if args.wide else VARIANTS
    jobs = {name: (cu, os.path.join(out_dir, f"libbf16_{name}.so"), off)
            for name, off in variants.items()}
    if not args.wide:
        trace_cu = os.path.join(out_dir, "kmeans_bf16_trace.cu")
        write(trace_cu, trace_source(src))
        jobs["trace"] = (trace_cu, os.path.join(out_dir, "libbf16_trace.so"),
                         ())
        if args.against:
            jobs["against"] = (
                os.path.join(os.path.abspath(args.against),
                             "flink_ml_tpu_torch", "kernels", "csrc",
                             "kmeans_bf16.cu"),
                os.path.join(out_dir, "libbf16_against.so"), ())
    procs = start_builds(build, jobs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if args.wide:
        wide(torch, card, src, procs, args.reps)
    else:
        headline(torch, card, src, procs, args.against)


if __name__ == "__main__":
    main()
