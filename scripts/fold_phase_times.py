#!/usr/bin/env python3
"""Times of the Wide&Deep fold kernel on the card, at several group
depths and against an earlier design.

    python3 scripts/fold_phase_times.py [--against DIR]

At ``chip_smoke.py`` phase 9's routes (step 0 of the bench route, the
heavy-hitter route at 12 passes, the deep route at 14, each at E = 64 and
E = 1; numpy seeds as there), with the L2 flushed before each launch
(``chip_smoke.Timer``: median of 25):

1. This checkout's kernel (``flink_ml_tpu_torch/kernels/csrc/emb_grad.cu``)
   built into ``kernels/build/phases/`` as each of ``VARIANTS``, called
   through its C entry point: L = 7 levels a launch (the source as it is),
   6 and 8, each held bit for bit to the plain version beside the byte
   bound, with the plan of every group launch (residues and floats a
   piece, window and tile in super-rows, shared bytes, blocks; ``PLAN``,
   appended to every variant's source); the levels switched off (wrong
   results; its time is the staging, match bits and stores alone); and
   windows sized for three and nine blocks an SM instead of six.
2. With ``--against DIR`` (a checkout of another commit, e.g. one unpacked
   with ``git archive``): the public wrapper ``fold_runs`` of the package
   at DIR and of this checkout, each in its own process, in the order DIR,
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

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variants of emb_grad.cu, (text in the source, replacement): the source
# as it is (L = 7), L = 6 and 8, the fold's levels switched off (its blocks
# stage their window, work out the match bits and write the tile back:
# wrong results, only its time is read), and windows sized for three and
# nine blocks an SM instead of six
LEVELS = "constexpr int kGroupLevels = 7;"
WINDOW = "constexpr long kSmemTarget = 36L * 1024;"
VARIANTS = {
    "levels_7": (LEVELS, LEVELS),
    "levels_6": (LEVELS, "constexpr int kGroupLevels = 6;"),
    "levels_8": (LEVELS, "constexpr int kGroupLevels = 8;"),
    "no_levels": ("  for (int k = 0; k < levels; ++k) {\n"
                  "    const int off = 1 << k;",
                  "  for (int k = 0; k < 0; ++k) {\n"
                  "    const int off = 1 << k;"),
    "window_72k": (WINDOW, "constexpr long kSmemTarget = 72L * 1024;"),
    "window_24k": (WINDOW, "constexpr long kSmemTarget = 24L * 1024;"),
}

# appended to every variant: the plan of group launch `group`, out[0..7] =
# R, piece width, window, tile, shared bytes, blocks, stride, levels
PLAN = """
extern "C" int emb_fold_group_plan(long S, int E, int passes, int group,
                                   long* out) {
  const int base = group * kGroupLevels;
  const Group p = make_group(S, E, base, min(kGroupLevels, passes - base));
  const long v[8] = {p.R, p.width, p.window, p.tile, p.smem, p.blocks,
                     p.stride, p.levels};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
"""


def smoke():
    """This checkout's ``chip_smoke`` module (its inputs and timer),
    whichever package is first on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cases(torch, cs, G):
    """``(name, E) -> (sorted rows, sorted ids, passes)`` on the card."""
    dev = torch.device("cuda")
    routes, _ = cs.fold_routes(G, dev)
    out = {}
    for name, E in cs.FOLD_TIMED:
        route = routes[name][0]
        sorted_g, _ = cs.fold_rows(torch, route, E, dev)
        out[name, E] = (sorted_g, route.sorted_ids[0], route.fold_passes)
    return out


def worker(root):
    """Times the public wrapper of the package at ``root``; prints one JSON
    line."""
    import torch

    sys.path.insert(0, root)
    from flink_ml_tpu_torch.kernels import build
    from flink_ml_tpu_torch.ops import emb_grad as G

    cs = smoke()
    build.build_all(["emb_grad"])
    timer = cs.Timer(torch, torch.device("cuda"))
    got = {}
    for (name, E), (g, sid, P) in cases(torch, cs, G).items():
        got[f"{name} E {E} P {P}"] = timer.ms(lambda: G.fold_runs(g, sid, P))
    print(json.dumps({"root": root, **got}), flush=True)


def variant_libs():
    """This checkout's kernel built as each of VARIANTS, all at once."""
    from flink_ml_tpu_torch.kernels import build

    src = open(os.path.join(build.CSRC_DIR, "emb_grad.cu")).read()
    out_dir = os.path.join(build.BUILD_DIR, "phases")
    os.makedirs(out_dir, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f != "-Xptxas=-v"]
    procs = {}
    for name, (plain, switched) in VARIANTS.items():
        if plain not in src:
            sys.exit(f"emb_grad.cu changed; update VARIANTS ({name})")
        cu = os.path.join(out_dir, f"emb_grad_{name}.cu")
        with open(cu + ".tmp", "w") as f:
            f.write(src.replace(plain, switched) + PLAN)
        os.replace(cu + ".tmp", cu)
        so = os.path.join(out_dir, f"libemb_grad_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", so, cu]))
    libs = {}
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    for name, (so, proc) in procs.items():
        if proc.wait(timeout=600) != 0:
            sys.exit(f"nvcc failed for {name}")
        lib = ctypes.CDLL(so)
        lib.emb_fold_launch.argtypes = [vp, vp, vp, vp, cl, ci, ci, vp]
        lib.emb_fold_group_plan.argtypes = [cl, ci, ci, ci,
                                            ctypes.POINTER(cl)]
        libs[name] = lib
    return libs


def depths(card):
    """This checkout's kernel as each of ``VARIANTS``."""
    import torch

    sys.path.insert(0, HERE)
    from flink_ml_tpu_torch.ops import emb_grad as G

    cs = smoke()
    variants = variant_libs()
    timer = cs.Timer(torch, torch.device("cuda"))
    plan = (ctypes.c_long * 8)()
    for (name, E), (g, sid, P) in cases(torch, cs, G).items():
        S = sid.shape[0]
        want = G.fold_runs_plain(g, sid, P)
        out = torch.empty_like(g)
        scratch = torch.empty_like(g)
        for label, lib in variants.items():
            def run():
                rc = lib.emb_fold_launch(
                    g.data_ptr(), sid.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), S, E, P,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f"launch failed: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            groups = []
            for gi in range(P):
                lib.emb_fold_group_plan(S, E, P, gi, plan)
                groups.append(dict(zip(
                    ("R", "width", "window", "tile", "smem", "blocks",
                     "stride", "levels"), list(plan))))
                if groups[-1]["stride"] << groups[-1]["levels"] >= 1 << P:
                    break
            print(f"{name} route, S {S}, E {E}, P {P}, {label}: "
                  f"{timer.ms(run):.4f} ms in {len(groups)} launches, bound "
                  f"{cs.fold_bound_ms(S, E):.4f} ms (bytes); bit for bit "
                  f"the plain version: {same}; groups {groups} [{card}]",
                  flush=True)
            if not same and label != "no_levels":
                sys.exit("the fold differs from its plain version")


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
    depths(card)
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
