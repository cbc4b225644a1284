#!/usr/bin/env python3
"""Times of the IVF search kernels on the card, by launch, by design
choice and against an earlier design.

    python3 scripts/retrieve_phase_times.py [--against DIR]

On ``chip_smoke.py``'s retrieval bench (131072 x 64 points in 4096 masses
of 32, numpy seed 77, nlist 256, k 10, build seed 1; the flat and IVF-PQ
(m 8, ksub 16) indexes built on the card; b queries near corpus rows,
numpy seed 77), with the L2 flushed before each call
(``chip_smoke.Timer``: median of 25):

1. This checkout's flat and IVF-PQ searches (``flink_ml_tpu_torch/
   kernels/csrc/retrieve.cu``) at b = 256 and nprobe 1, 2, 16 and nlist,
   and at b = 4096 and nprobe 2 and 16, with the queries a probed list
   draws (mean and most), whole and as variants of the source built into
   ``kernels/build/phases/`` (``SWITCHES``): with work switched off (the
   probe launch alone; the scan's blocks loading their chunk and
   stopping; the selections' k rounds; the merge: wrong results, only
   their times are read), and with a design choice undone (no
   programmatic dependent launch; the flat spans at 1 or 4 rounds a block
   instead of 2, the PQ spans at 2 instead of 1, without the split of busy
   lists (kFill 0), with it up to 2048 blocks, or sized for 3 times the
   average draw instead of 5; warp_select on every pass instead of the
   insertion of few keys); the IVF-PQ search also in chunks of 256 rows
   instead of whole lists; the flat search also at 1, 2, 4 and 8 queries
   a probe block, and the wall time a call of 200 calls in a row, whole
   and without the dependent launch.
2. With ``--against DIR`` (a checkout of another commit, e.g. one unpacked
   with ``git archive``): ``retrieve_flat`` and ``retrieve_pq`` of the
   package at DIR and of this checkout at b = 64, 256, 1024 and 4096 and
   nprobe 1, 2, 4 and 16 (and nlist at b = 256), each beside its bound
   (``chip_smoke.retrieve_bound``); and both searches' QPS by the host
   clock (50 calls of ``search_tensors`` at b = 256) and wall time a call
   of 200 in a row, each package in its own process, in the order DIR,
   this, this, DIR, so both designs are timed in one call on one card.

Prints the card's name and power limit beside every time.  Needs one
NVIDIA GPU and nvcc.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variants of the source: (text in the source, replacement), each for
# both searches where it applies (item 1 of the docstring).
PDL = "programmaticStreamSerializationAllowed = 1;"
ROUNDS = "constexpr int kRounds = 2;"
SWITCHES = {
    "probe_only": [("  err = cudaLaunchKernelEx(",
                    "  if (false) err = cudaLaunchKernelEx(")],
    "scan_load_only": [("        staged = true;\n      }\n",
                        "        staged = true;\n      }\n"
                        "      if (staged) return;\n")],
    "no_pdl": [(PDL, "programmaticStreamSerializationAllowed = 0;")],
    "rounds_1": [(ROUNDS, "constexpr int kRounds = 1;")],
    "rounds_4": [(ROUNDS, "constexpr int kRounds = 4;")],
    "select_off": [("  Key mine = kNoKey;\n  for (int i = 0; i < k; ++i) {",
                    "  Key mine = kNoKey;\n"
                    "  if (k > 0) return lane < k ? key[0] : kNoKey;\n"
                    "  for (int i = 0; i < k; ++i) {")],
    "merge_off": [("  if (__shfl_sync(kFull, last, 0))\n    merge_query(",
                   "  if (false && __shfl_sync(kFull, last, 0))\n"
                   "    merge_query(")],
    "pq_rounds_2": [("static constexpr int kRounds = 1;",
                     "static constexpr int kRounds = 2;")],
    "pq_fill_off": [("static constexpr int kFill = 1024;",
                     "static constexpr int kFill = 0;")],
    "pq_fill_2048": [("static constexpr int kFill = 1024;",
                      "static constexpr int kFill = 2048;")],
    "skew_3": [("constexpr long kSkew = 5;", "constexpr long kSkew = 3;")],
    "insert_off": [("constexpr int kInsertMost = 16;",
                    "constexpr int kInsertMost = -1;")],
}
# (b, nprobe) of the variants' times
VARIANT_CASES = ((256, 1), (256, 2), (256, 16), (256, 256), (4096, 2),
                 (4096, 16))
# (b, nprobe) of the comparison with another checkout
GRID_B = (64, 256, 1024, 4096)
GRID_NPROBE = (1, 2, 4, 16)


def smoke():
    """This checkout's ``chip_smoke`` module (its inputs and timer),
    whichever package is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def indexes(torch, cs, pq, nq=None):
    """The bench's flat (and, with ``pq``, IVF-PQ) index on the card and
    ``nq`` queries (the bench's 256 by default) there."""
    from flink_ml_tpu_torch import IVFIndex, PQConfig

    X, queries = cs.retrieval_corpus(cs.RT_N, cs.RT_D, nq or cs.RT_NQ)
    flat = IVFIndex.build(X, cs.RT_NLIST, k=cs.RT_K, seed=1, device="cuda")
    pqi = IVFIndex.build(X, cs.RT_NLIST, PQConfig(**cs.RT_PQ), k=cs.RT_K,
                         seed=1, device="cuda") if pq else None
    return flat, pqi, torch.from_numpy(queries).to("cuda")


def worker(root):
    """Times the package at ``root``; prints one JSON line."""
    import torch

    sys.path.insert(0, root)
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.ops import retrieve as R

    cs = smoke()
    build.build_all(["kmeans", "retrieve"])
    flat, pqi, qd = indexes(torch, cs, pq=True)
    timer = cs.Timer(torch, torch.device("cuda"))
    got = {}
    for b in GRID_B:
        _, queries = cs.retrieval_corpus(cs.RT_N, cs.RT_D, b)
        qb = torch.from_numpy(queries).to("cuda")
        nprobes = GRID_NPROBE + ((cs.RT_NLIST,) if b == cs.RT_NQ else ())
        for variant, index in (("flat", flat), ("pq", pqi)):
            cents = index.device_params()["centroids"]
            for nprobe in nprobes:
                view = index.with_options(nprobe=nprobe)
                got[f"{variant} b {b} nprobe {nprobe}"] = timer.ms(
                    lambda: view.search_tensors(qb))
                got[f"{variant} bound b {b} nprobe {nprobe}"] = \
                    cs.retrieve_bound(R, qb, cents, nprobe, index.block,
                                      variant == "pq")[1]
    for variant, index in (("flat", flat), ("pq", pqi)):
        for nprobe in (1, 2, 16):
            view = index.with_options(nprobe=nprobe)
            view.search_tensors(qd)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(cs.RT_ROUNDS):
                view.search_tensors(qd)
            torch.cuda.synchronize()
            got[f"{variant} QPS nprobe {nprobe}"] = (
                cs.RT_NQ * cs.RT_ROUNDS / (time.perf_counter() - t0))
            got[f"{variant} host us a call nprobe {nprobe}"] = host_us(
                torch, lambda: view.search_tensors(qd))
    print(json.dumps({"root": root, **got}), flush=True)


def host_us(torch, fn, calls=200):
    """Microseconds of host time a call of ``fn``: the wall time of
    ``calls`` calls in a row, none waited for, where the host cannot run
    ahead of the card by more than its launch queue (so this reads the
    larger of the host's and the card's time a call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def build_variants():
    """This checkout's retrieve.cu with the work of each of SWITCHES
    switched off, all built at once; returns their libraries' paths."""
    from flink_ml_tpu_torch.kernels import build

    src = open(os.path.join(build.CSRC_DIR, "retrieve.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs = {}
    for name, edits in SWITCHES.items():
        text = src
        for plain, switched in edits:
            if plain not in text:
                sys.exit(f"retrieve.cu changed; update SWITCHES ({name})")
            text = text.replace(plain, switched)
        cu = os.path.join(out_dir, f"retrieve_{name}.cu")
        with open(cu + ".tmp", "w") as f:
            f.write(text)
        os.replace(cu + ".tmp", cu)
        lib = os.path.join(out_dir, f"libretrieve_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", lib, cu]))
    build.build_all(["kmeans", "retrieve"])
    for name, (_, proc) in procs.items():
        if proc.wait(timeout=600) != 0:
            sys.exit(f"nvcc failed for {name}")
    return {name: path for name, (path, _) in procs.items()}


def variants(card):
    """This checkout's flat and IVF-PQ searches, whole and as each of
    SWITCHES."""
    import torch

    sys.path.insert(0, HERE)
    from flink_ml_tpu_torch.ops import retrieve as R

    cs = smoke()
    paths = build_variants()
    flat, pqi, _ = indexes(torch, cs, pq=True, nq=1)
    p = flat.device_params()
    pp = pqi.device_params()
    timer = cs.Timer(torch, torch.device("cuda"))
    libs = {"whole": R._kernels()}
    libs.update({name: R.declare(ctypes.CDLL(path))
                 for name, path in paths.items()})
    for b, nprobe in VARIANT_CASES:
        _, queries = cs.retrieval_corpus(cs.RT_N, cs.RT_D, b)
        qd = torch.from_numpy(queries).to("cuda")
        shape = dict(nprobe=nprobe, k=cs.RT_K, nlist=flat.nlist,
                     block=flat.block)
        pq_shape = dict(shape, block=pqi.block, m=pqi.pq.m)

        def flat_call():
            return R.retrieve_flat(qd, p["centroids"], p["ids"], p["vecs"],
                                   **shape)

        def pq_call():
            return R.retrieve_pq(qd, pp["centroids"], pp["ids"],
                                 pp["codes"], pp["cb_q"], pp["cb_s"],
                                 **pq_shape)

        times = {}
        pq_times = {}
        for name, lib in libs.items():
            R._LIB = lib             # the wrappers launch through it
            times[name] = timer.ms(flat_call)
            pq_times[name] = timer.ms(pq_call)
        R._LIB = libs["whole"]
        # IVF-PQ chunks of 256 rows (a whole list is one chunk at the bench)
        keep, R._PQ_SCAN_ROWS = R._PQ_SCAN_ROWS, 256
        R.pq_plan.cache_clear()
        pq_times["rows_256"] = timer.ms(pq_call)
        R._PQ_SCAN_ROWS = keep
        R.pq_plan.cache_clear()
        # 1, 2, 4 and 8 queries a probe block (the wrapper's: ceil(b /
        # 64), up to the plan's 8)
        for nq in (1, 2, 4, 8):
            keep, R._PROBE_BLOCKS = R._PROBE_BLOCKS, b // nq
            times[f"probe_{nq}q"] = timer.ms(flat_call)
            R._PROBE_BLOCKS = keep
        host = {}
        for name in ("whole", "no_pdl"):
            R._LIB = libs[name]
            host[name] = host_us(torch, flat_call)
        R._LIB = libs["whole"]
        counts = torch.bincount(R.select_probes(qd, p["centroids"], nprobe)
                                .flatten(), minlength=flat.nlist)
        counts = counts[counts > 0].float()
        print(f"probes (b {b}, nprobe {nprobe}): {counts.numel()} lists "
              f"probed, queries a probed list: mean {counts.mean():.1f}, "
              f"most {counts.max():.0f}", flush=True)
        print(f"retrieve_flat (b {b}, nprobe {nprobe}): "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
              + "; wall us a call, 200 in a row: "
              + ", ".join(f"{name} {us:.1f}" for name, us in host.items())
              + f" [{card}]", flush=True)
        print(f"retrieve_pq (b {b}, nprobe {nprobe}): "
              + ", ".join(f"{name} {ms:.4f} ms"
                          for name, ms in pq_times.items())
              + f" [{card}]", flush=True)


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
            unit = {True: "", False: " ms"}
            print(f"{label}: " + ", ".join(
                f"{k} {v:.4f}" + unit["QPS" in k or " us " in k]
                for k, v in got.items() if k != "root") + f" [{card}]",
                flush=True)


if __name__ == "__main__":
    main()
