#!/usr/bin/env python3
"""Times of the flat IVF search kernels on the card, by launch, by design
choice and against an earlier design.

    python3 scripts/retrieve_phase_times.py [--against DIR]

On ``chip_smoke.py``'s retrieval bench (131072 x 64 points in 4096 masses
of 32, numpy seed 77, nlist 256, k 10, build seed 1; the flat index built
on the card; b queries near corpus rows, numpy seed 77), with the L2
flushed before each call (``chip_smoke.Timer``: median of 25):

1. This checkout's flat search (``flink_ml_tpu_torch/kernels/csrc/
   retrieve.cu``) at b = 256 and nprobe 1, 2, 16 and nlist, and at b =
   4096 and nprobe 2 and 16, whole and as variants of the source built
   into ``kernels/build/phases/`` (``SWITCHES``): with work switched off
   (the probe launch alone; the scan's blocks loading their rows and
   stopping: wrong results, only their times are read), and with a design
   choice undone (no programmatic dependent launch; spans of 1 or 4
   rounds a block instead of 2; 1, 2, 4 and 8 queries a probe block);
   and the wall time a call of 200 calls
   in a row, whole and without the dependent launch.
2. With ``--against DIR`` (a checkout of another commit, e.g. one unpacked
   with ``git archive``): ``retrieve_flat`` of the package at DIR and of
   this checkout at b = 64, 256, 1024 and 4096 and nprobe 1, 2, 4 and 16
   (and nlist at b = 256), beside the bound
   (``chip_smoke.retrieve_bound``); ``retrieve_pq`` at b = 256 and nprobe
   2; and the flat search's QPS by the host clock (50 calls of
   ``search_tensors`` at b = 256) and its wall time a call of 200 in a
   row, each package in its own process, in
   the order DIR, this, this, DIR, so both designs are timed in one call
   on one card.

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

# variants of the source: (text in the source, replacement).  Work
# switched off (wrong results; only the time is read): the probe launch
# alone, and the scan's blocks loading their rows and stopping.  Design
# choices undone: no programmatic dependent launch, and spans sized for 1
# and 4 rounds a block instead of 2.
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
    p = flat.device_params()
    timer = cs.Timer(torch, torch.device("cuda"))
    got = {}
    for b in GRID_B:
        _, queries = cs.retrieval_corpus(cs.RT_N, cs.RT_D, b)
        qb = torch.from_numpy(queries).to("cuda")
        nprobes = GRID_NPROBE + ((cs.RT_NLIST,) if b == cs.RT_NQ else ())
        for nprobe in nprobes:
            view = flat.with_options(nprobe=nprobe)
            got[f"flat b {b} nprobe {nprobe}"] = timer.ms(
                lambda: view.search_tensors(qb))
            got[f"bound b {b} nprobe {nprobe}"] = cs.retrieve_bound(
                R, qb, p["centroids"], nprobe, flat.block, False)[1]
    for nprobe in (1, 2, 16):
        view = flat.with_options(nprobe=nprobe)
        view.search_tensors(qd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.RT_ROUNDS):
            view.search_tensors(qd)
        torch.cuda.synchronize()
        got[f"flat QPS nprobe {nprobe}"] = (
            cs.RT_NQ * cs.RT_ROUNDS / (time.perf_counter() - t0))
        got[f"flat host us a call nprobe {nprobe}"] = host_us(
            torch, lambda: view.search_tensors(qd))
    view = pqi.with_options(nprobe=2)
    got["pq nprobe 2"] = timer.ms(lambda: view.search_tensors(qd))
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
    """This checkout's flat search, whole and as each of SWITCHES."""
    import torch

    sys.path.insert(0, HERE)
    from flink_ml_tpu_torch.ops import retrieve as R

    cs = smoke()
    paths = build_variants()
    flat, _, _ = indexes(torch, cs, pq=False, nq=1)
    p = flat.device_params()
    timer = cs.Timer(torch, torch.device("cuda"))
    libs = {"whole": R._kernels()}
    libs.update({name: R.declare(ctypes.CDLL(path))
                 for name, path in paths.items()})
    for b, nprobe in VARIANT_CASES:
        _, queries = cs.retrieval_corpus(cs.RT_N, cs.RT_D, b)
        qd = torch.from_numpy(queries).to("cuda")
        shape = dict(nprobe=nprobe, k=cs.RT_K, nlist=flat.nlist,
                     block=flat.block)
        times = {}
        for name, lib in libs.items():
            R._LIB = lib             # the wrapper launches through it
            times[name] = timer.ms(lambda: R.retrieve_flat(
                qd, p["centroids"], p["ids"], p["vecs"], **shape))
        # 1, 2, 4 and 8 queries a probe block (the wrapper's: ceil(b /
        # 64), up to the plan's 8)
        for nq in (1, 2, 4, 8):
            keep, R._PROBE_BLOCKS = R._PROBE_BLOCKS, b // nq
            times[f"probe_{nq}q"] = timer.ms(lambda: R.retrieve_flat(
                qd, p["centroids"], p["ids"], p["vecs"], **shape))
            R._PROBE_BLOCKS = keep
        host = {}
        for name in ("whole", "no_pdl"):
            R._LIB = libs[name]
            host[name] = host_us(torch, lambda: R.retrieve_flat(
                qd, p["centroids"], p["ids"], p["vecs"], **shape))
        R._LIB = libs["whole"]
        print(f"retrieve_flat (b {b}, nprobe {nprobe}): "
              + ", ".join(f"{name} {ms:.4f} ms" for name, ms in times.items())
              + "; wall us a call, 200 in a row: "
              + ", ".join(f"{name} {us:.1f}" for name, us in host.items())
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
