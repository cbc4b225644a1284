"""The dp x tp Wide&Deep step against the one-device step, in both
packages, on the CPU at one mid width.

    python3 scripts/widedeep_dp_tp_drift.py [--steps 3] [--vocab 4096]

Both packages' ``build_sharded_train_step`` on a ``{"data": 2, "model":
2}`` mesh, from their shared init (seed 0), take the same numpy-seeded
batches as their ``build_reference_train_step``; after each step the
sharded parameters (gathered) are compared with the reference's.  The JAX
package runs on its virtual CPU mesh (4 host devices), the port on 4 gloo
ranks.  Prints, per package and step, the largest absolute difference of
any parameter, the values outside ``assert_sharded_matches_reference``'s
tolerance (rtol 1e-4, atol 1e-5) and the loss difference, then one JSON
line.  The mid width: 26 fields of ``--vocab`` ids, 13 dense features,
embedding 32, MLP (512, 256, 128), batch 2048, lr 1e-2 (phase 11 of
``chip_smoke.py`` runs 40329 ids, embedding 64, MLP (1024, 512, 256),
batch 8192).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

FIELDS, DENSE, EMB, HIDDEN, BATCH, LR = 26, 13, 32, (512, 256, 128), 2048, 1e-2
RTOL, ATOL = 1e-4, 1e-5


def batches(vocab: int, steps: int, seed: int = 7):
    """``steps`` batches of (dense, offset ids, labels, mask)."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(FIELDS, dtype=np.int32) * vocab
    out = []
    for _ in range(steps):
        cat = rng.integers(0, vocab, size=(BATCH, FIELDS)).astype(np.int32)
        out.append((rng.normal(size=(BATCH, DENSE)).astype(np.float32),
                    cat + offsets[None, :],
                    rng.integers(0, 2, size=BATCH).astype(np.float32),
                    np.ones(BATCH, np.float32)))
    return out


def drift(got_leaves, ref_leaves, loss, ref_loss) -> dict:
    worst, past, n = 0.0, 0, 0
    for a, b in zip(got_leaves, ref_leaves):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        worst = max(worst, float(np.max(np.abs(a - b))))
        past += int(np.sum(~np.isclose(a, b, rtol=RTOL, atol=ATOL)))
        n += a.size
    return {"max_abs": worst, "past_tolerance": past, "values": n,
            "loss_diff": abs(float(loss) - float(ref_loss))}


def jax_drifts(vocab: int, steps: int):
    """The JAX package's sharded step on its 4-device virtual CPU mesh."""
    import jax

    from flink_ml_tpu.models.recommendation import widedeep as JW
    from flink_ml_tpu.parallel.mesh import device_mesh

    if len(jax.devices()) < 4:
        raise SystemExit("needs 4 virtual CPU devices: run with "
                         "XLA_FLAGS=--xla_force_host_platform_device_count=4"
                         " (the script sets it when JAX is not yet loaded)")
    mesh = device_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    vocab_sizes = [vocab] * FIELDS
    step, params, _, state, shard = JW.build_sharded_train_step(
        mesh, DENSE, vocab_sizes, EMB, HIDDEN, lr=LR)
    ref_step, ref_p, ref_s = JW.build_reference_train_step(
        DENSE, vocab_sizes, EMB, HIDDEN, lr=LR)
    out = []
    for b in batches(vocab, steps):
        params, state, loss = step(params, state, *shard(*b))
        ref_p, ref_s, ref_loss = ref_step(ref_p, ref_s, *b)
        out.append(drift(jax.tree_util.tree_leaves(jax.device_get(params)),
                         jax.tree_util.tree_leaves(jax.device_get(ref_p)),
                         loss, ref_loss))
    return out


def port_rank(rank: int, vocab: int, steps: int):
    """One gloo rank of the port's sharded step; rank 0 compares."""
    import torch

    from flink_ml_tpu_torch.models.recommendation import widedeep as W
    from flink_ml_tpu_torch.parallel.mesh import device_mesh

    mesh = device_mesh({"data": 2, "model": 2}, device="cpu")
    vocab_sizes = [vocab] * FIELDS
    step, params, _, state, shard = W.build_sharded_train_step(
        mesh, DENSE, vocab_sizes, EMB, HIDDEN, lr=LR)
    ref_step, ref_p, ref_s = W.build_reference_train_step(
        DENSE, vocab_sizes, EMB, HIDDEN, lr=LR, device="cpu")
    out = []
    for b in batches(vocab, steps):
        params, state, loss = step(params, state, *shard(*b))
        got = W.gather_sharded_params(params, mesh)
        ref_p, ref_s, ref_loss = ref_step(
            ref_p, ref_s, *(torch.from_numpy(a) for a in b))
        out.append(drift(
            [np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
             for t in W.tree_leaves(got)],
            [t.detach().numpy() for t in W.tree_leaves(ref_p)],
            loss, ref_loss))
    return out if rank == 0 else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--vocab", type=int, default=4096)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "jax" not in sys.modules:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count"
                                   "=4").strip()
    from flink_ml_tpu_torch.utils.backend import run_on_ranks

    t0 = time.perf_counter()
    j = jax_drifts(args.vocab, args.steps)
    t1 = time.perf_counter()
    p = run_on_ranks(port_rank, 4, args.vocab, args.steps,
                     timeout_s=1800.0)[0]
    t2 = time.perf_counter()
    shape = (f"{FIELDS} x {args.vocab} ids, {DENSE} dense, embedding {EMB}, "
             f"MLP {HIDDEN}, batch {BATCH}, lr {LR}, 2 x 2 mesh")
    print(f"dp x tp Wide&Deep vs the one-device step ({shape}); CPU")
    for name, rows, secs in (("JAX", j, t1 - t0), ("port", p, t2 - t1)):
        for i, r in enumerate(rows):
            print(f"  {name} step {i}: max |sharded - one-device| "
                  f"{r['max_abs']:.3e}, {r['past_tolerance']} of "
                  f"{r['values']} values past rtol {RTOL} / atol {ATOL}, "
                  f"loss off by {r['loss_diff']:.3e}")
        print(f"  {name}: {secs:.1f} s")
    print(json.dumps({"shape": shape, "jax": j, "port": p}))


if __name__ == "__main__":
    main()
