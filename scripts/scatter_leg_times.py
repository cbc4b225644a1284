#!/usr/bin/env python3
"""What the scatter-add legs of an ELL step cost on the card, by
primitive.

    python3 scripts/scatter_leg_times.py

At the LR main path's shapes (``chip_smoke.py`` phase 3's step: 2^20
features, batch 2^15, 26 Criteo-shaped slots, seed 1): the overflow legs
(the margin's ``mext[ovf_src] += w[ovf_idx]`` and the update's
``w[ovf_idx] += u``) and the heavy leg, with the overflow arrays at the
in-memory fit's cap (the need x 2, ``EllLayout.trim_overflow``) and at
the streamed fit's fixed cap (``max(1024, batch)``: its tail is padding
that targets one slot).  Each leg through ``index_add_`` (atomics: no
fixed order) and through ``sgd._scatter_add_`` (the sort-based fixed
order); the overflow legs also through ``sgd._overflow_scatter_`` (the
same with the padding spread over distinct slots as ``-0.0``: what the
streamed fit's updates run on the card).  Prints the host microseconds a
call (200 calls enqueued back to back, then one synchronize: what a
host-bound step loop pays) and the device milliseconds a call (CUDA
events), beside the card's name and power limit.  Needs one NVIDIA GPU.
"""

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

CALLS = 200


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from flink_ml_tpu_torch.models.common import sgd as S
    from flink_ml_tpu_torch.ops import ell_scatter as E

    if not torch.cuda.is_available():
        sys.exit("scatter_leg_times: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    _, cat, _ = C.criteo_rows(C.BATCH, C.D_MAIN, seed=1)
    stream = E.ell_layout(cat[None], C.D_MAIN,
                          pad_ovf_cap=max(1024, C.BATCH), pad_heavy_cap=16)
    layouts = {"in-memory cap": E.ell_layout(cat[None], C.D_MAIN)
               .trim_overflow(), "streamed cap": stream}
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=C.D_MAIN).astype(np.float32)
                         ).to(dev)
    r = torch.from_numpy(rng.normal(size=C.BATCH).astype(np.float32)
                         ).to(dev)
    r_ext = S._extended_r(r)
    m_len = S._ext_len(C.BATCH)

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS):
            fn()
        end.record()
        host_us = (time.perf_counter() - t0) / CALLS * 1e6
        torch.cuda.synchronize()
        return host_us, start.elapsed_time(end) / CALLS

    for name, lay in layouts.items():
        t = lay.to(dev)
        ovf_idx, ovf_src = t.ovf_idx[0], t.ovf_src[0]
        heavy_idx = t.heavy_idx[0]
        heavy_u = t.heavy_cnt[0].to(torch.float32) @ r
        o_m = w[ovf_idx]
        o_w = -0.5 * r_ext[ovf_src]
        mext = torch.zeros(m_len, device=dev)
        w2 = w.clone()
        legs = {
            "margin overflow": (mext, ovf_src, o_m, True),
            "update overflow": (w2, ovf_idx, o_w, True),
            "heavy": (w2, heavy_idx, heavy_u, False),
        }
        print(f"{name}: overflow need {int(lay.need_ovf[0])}, cap "
              f"{lay.ovf_idx.shape[1]}; heavy need {int(lay.need_heavy[0])},"
              f" cap {lay.heavy_idx.shape[1]}", flush=True)
        for leg, (dst, idx, vals, overflow) in legs.items():
            add = timed(lambda: dst.index_add_(0, idx, vals))
            fixed = timed(lambda: S._scatter_add_(dst, idx, vals))
            line = (f"  {leg}: index_add_ {add[0]:.1f} us host, "
                    f"{add[1]:.4f} ms device; fixed order {fixed[0]:.1f} us "
                    f"host, {fixed[1]:.4f} ms device")
            if overflow:
                spread = timed(lambda: S._overflow_scatter_(
                    dst, idx, vals, ovf_src, C.BATCH))
                line += (f"; padding spread {spread[0]:.1f} us host, "
                         f"{spread[1]:.4f} ms device")
            print(f"{line} [{card}]", flush=True)


if __name__ == "__main__":
    main()
