"""Entry points of the port: the counterpart of the JAX package's
root ``__graft_entry__.py``.

- :func:`entry`: the flagship model's forward (Wide&Deep under a sigmoid)
  and its example args, the JAX entry's parameters and batch (numpy seed
  0), on the card unless the caller asks for the CPU.
- :func:`dryrun_multichip`: the JAX dryrun's legs over ``n_devices`` ranks
  (``utils/backend.run_on_ranks``; gloo ranks sharing ``cuda:0`` on the
  card, gloo CPU ranks where the caller asks for the CPU): the dp x tp
  Wide&Deep step held to the one-device reference step, the compressed
  step, the routed Wide&Deep fit over ``data`` against the one-rank
  unrouted fit, the mixed LR fits (data-sharded, sharded ELL, dp x model)
  against the one-rank fit, and pipeline, sequence and expert
  parallelism at the dryrun's shapes.  It returns what each rank
  measured: the legs' kernel launches, times and losses.

Where the JAX dryrun shards one global batch over its devices, each rank
here passes its own rows, so each fit's oracle is the one-rank fit of the
rows in the order the ranks' layouts form the global steps
(:func:`_one_process_rows`).
"""

from __future__ import annotations

import sys
import threading
import time

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["VOCAB_SIZES", "EMB_DIM", "HIDDEN", "D_DENSE",
           "DRYRUN_BUDGET_S", "entry", "dryrun_multichip"]

VOCAB_SIZES = (100, 50, 20)
EMB_DIM = 8
HIDDEN = (32, 16)
D_DENSE = 16

#: Soft wall-clock budget for the whole dryrun: past it every rank's
#: watchdog names the phase it is in, and the call raises at its end.
#: The ranks' hard deadline is twice it.
DRYRUN_BUDGET_S = 300.0


def _example_batch(batch: int, rng: np.random.Generator):
    """The JAX entry's draws: dense features, offset ids, labels, mask."""
    from .models.recommendation.widedeep import _field_offsets

    cat = (np.stack([rng.integers(0, v, size=batch) for v in VOCAB_SIZES],
                    axis=1).astype(np.int32)
           + _field_offsets(VOCAB_SIZES)[None, :])
    return (
        rng.normal(size=(batch, D_DENSE)).astype(np.float32),
        cat,
        rng.integers(0, 2, size=batch).astype(np.float32),
        np.ones((batch,), np.float32),
    )


def entry(device=None):
    """Wide&Deep forward (scores) and its example args ``(params, dense,
    cat)`` on ``device`` (default the card; raises without one)."""
    from .models.recommendation.widedeep import (forward, init_params,
                                                 params_to_device)
    from .utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    params = params_to_device(
        init_params(rng, D_DENSE, VOCAB_SIZES, EMB_DIM, HIDDEN), dev)
    dense, cat, _, _ = _example_batch(256, rng)

    def fn(params, dense, cat):
        return torch.sigmoid(forward(params, dense, cat))

    return fn, (params, torch.from_numpy(dense).to(dev),
                torch.from_numpy(cat).to(dev))


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, Any]:
    """The JAX dryrun's legs over ``n_devices`` gloo ranks, on ``device``
    (default the card, every rank on ``cuda:0``; ``"cpu"``: CPU ranks).
    Every leg is held to its oracle on every rank, and each launch of the
    ELL kernels and the fold in the legs to its plain version on the same
    inputs, bit for bit; a rank that fails fails the call.  Returns
    ``{"seconds", "ranks"}``, ``ranks`` each rank's report (launches by
    leg, held launches, phase seconds, losses, the compressed step's
    payload)."""
    from .utils.backend import run_on_ranks
    from .utils.device import resolve_device

    t0 = time.monotonic()
    dev = resolve_device(device)
    ranks = run_on_ranks(_dryrun_rank, n_devices, n_devices,
                         device="cuda:0" if dev.type == "cuda" else "cpu",
                         backend="gloo", timeout_s=2 * DRYRUN_BUDGET_S)
    elapsed = time.monotonic() - t0
    if elapsed > DRYRUN_BUDGET_S:
        raise RuntimeError(
            f"dryrun_multichip took {elapsed:.0f}s (> {DRYRUN_BUDGET_S:.0f}s "
            "soft budget): trim the body before a caller's hard timeout "
            "turns this into an exit with no signal")
    return {"seconds": elapsed, "ranks": ranks}


# ---------------------------------------------------------------------------
# the legs, on each rank
# ---------------------------------------------------------------------------


def _one_process_rows(parts, batch: int, seed: int):
    """Rows of a one-process fit whose epoch layout (``plan_epoch_layout``
    at ``seed``) gives step ``i`` the ranks' ``i``-th local batches in rank
    order: ``parts`` is each rank's tuple of row arrays, each rank's own
    permutation the same seed's over its own rows."""
    world = len(parts)
    n_local = len(parts[0][0])
    b = batch // world
    local = np.random.default_rng(seed).permutation(n_local)
    order = [(r, local[i * b:(i + 1) * b]) for i in range(n_local // b)
             for r in range(world)]
    perm = np.random.default_rng(seed).permutation(world * n_local)
    out = []
    for k in range(len(parts[0])):
        joined = np.concatenate([parts[r][k][rows] for r, rows in order])
        arr = np.empty_like(joined)
        arr[perm] = joined
        out.append(arr)
    return out


class _Held:
    """The legs' kernels swapped for ones that also run the plain version
    on the same inputs and compare bit for bit: ``checked`` and
    ``unequal`` calls and the largest difference by kernel.  The ELL
    kernels are swapped in the kernel registry, where the trainers
    resolve them: the ``"cuda"`` entries, and the ``"plain"`` entries for
    CPU operands (what the legs run on CPU ranks; a plain oracle on the
    card is not held).  The fold is swapped at its wrapper, which the
    route's stages call."""

    def __init__(self):
        from .ops import ell_scatter as E
        from .ops import emb_grad as G

        def scatter_name(args):
            return ("ell_scatter_apply_fused"
                    if args[2].shape[0] % E.FUSED_BLOCK_ROWS == 0
                    else "ell_scatter_apply")

        self.stats: Dict[str, Dict[str, float]] = {}
        self._entries = [
            ("ell_margin", "cuda", lambda args: "ell_margin",
             E.ell_margin_plain),
            ("ell_margin", "plain", lambda args: "ell_margin",
             E.ell_margin_plain),
            ("ell_scatter_apply", "cuda",
             lambda args: "ell_scatter_apply_fused",
             E.ell_scatter_apply_fused_plain),
            ("ell_scatter_apply", "cuda-pair",
             lambda args: "ell_scatter_apply",
             E.ell_scatter_apply_plain_entry),
            ("ell_scatter_apply", "plain", scatter_name,
             E.ell_scatter_apply_plain_entry),
            # on CPU ranks the route's plain entry folds (fold_runs_plain)
            ("routed_table_grad", "plain", lambda args: "fold_runs",
             G.routed_apply_plain)]
        self._swaps = [(G, "fold_runs", G.fold_runs_plain)]
        self._saved = []
        self._saved_entries = []

    def _wrap(self, name_of, kernel, plain, cpu_only=False):
        def on_cpu(args) -> bool:
            if isinstance(args[0], torch.Tensor):
                return args[0].device.type == "cpu"
            # a route entry: (route, g_flat, *step_arrays); it folds only
            # when the route has passes to fold
            return args[1].device.type == "cpu" and args[0].fold_passes > 0

        def held(*args, **kwargs):
            if cpu_only and not on_cpu(args):
                return kernel(*args, **kwargs)
            st = self.stats.setdefault(
                name_of(args), {"checked": 0, "unequal": 0, "max_abs": 0.0})
            # the plain version reads copies taken before the launch
            before = [a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args]
            got = kernel(*args, **kwargs)
            want = plain(*before, **kwargs)
            st["checked"] += 1
            if not torch.equal(got, want):
                st["unequal"] += 1
                st["max_abs"] = max(st["max_abs"],
                                    float((got - want).abs().max()))
            return got

        return held

    def __enter__(self):
        from .kernels import registry

        for op, backend, name_of, plain in self._entries:
            entry = registry.lookup(op, backend=backend)
            self._saved_entries.append(entry)
            registry.register_kernel(
                op, backend,
                self._wrap(name_of, entry.fn, plain,
                           cpu_only=backend == "plain"),
                priority=entry.priority, supports=entry.supports,
                available=entry.available, convention=entry.convention)
        for mod, name, plain in self._swaps:
            kernel = getattr(mod, name)
            self._saved.append((mod, name, kernel))
            setattr(mod, name, self._wrap(lambda args, n=name: n, kernel,
                                          plain))
        return self

    def __exit__(self, *exc):
        from .kernels import registry

        for e in self._saved_entries:
            registry.register_kernel(
                e.op, e.backend, e.fn, priority=e.priority,
                supports=e.supports, available=e.available,
                convention=e.convention)
        for mod, name, kernel in self._saved:
            setattr(mod, name, kernel)


def _launches() -> Dict[str, int]:
    from .ops import ell_scatter as E
    from .ops import emb_grad as G

    return {**E.LAUNCHES, **G.LAUNCHES}


def _reset_launches() -> None:
    from .ops import ell_scatter as E
    from .ops import emb_grad as G

    E.reset_launch_counts()
    G.reset_launch_counts()


def _dryrun_rank(rank: int, world: int):
    """Every leg on this rank; what it measured."""
    from .parallel import distributed

    t0 = time.monotonic()
    phase = ["init"]
    done = threading.Event()

    def _watchdog() -> None:
        # even if a caller still kills the ranks, the output names the
        # stuck phase
        if not done.wait(DRYRUN_BUDGET_S):
            print(f"dryrun_multichip rank {rank}: exceeded "
                  f"{DRYRUN_BUDGET_S:.0f}s soft budget in phase "
                  f"{phase[0]!r} ({time.monotonic() - t0:.0f}s elapsed)",
                  file=sys.stderr, flush=True)

    threading.Thread(target=_watchdog, daemon=True).start()
    dev = distributed.rank_device()
    report = {"launches": {}, "secs": {}}
    legs = (("widedeep dp x tp", _leg_sharded_step),
            ("compressed grad reduce", _leg_grad_reduce),
            ("widedeep routed grads", _leg_widedeep_routed),
            ("mixed LR", _leg_mixed_lr),
            ("pp/sp/ep", _leg_pp_sp_ep))
    try:
        with _Held() as held:
            for name, leg in legs:
                phase[0] = name
                t = time.monotonic()
                _reset_launches()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                got = leg(rank, world, dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                report["launches"][name] = _launches()
                report["secs"][name] = time.monotonic() - t
                if got:
                    report[name] = got
    finally:
        phase[0] = "done"
        done.set()
    report["held"] = held.stats
    distributed.barrier()
    return report


def _leg_sharded_step(rank, world, dev):
    """The dp x tp step on a ``("data", "model")`` mesh, held to the
    one-device reference step from the same init; every leaf keeps its
    ``param_spec`` shard's shape."""
    from .models.recommendation import widedeep as W
    from .parallel.collectives import axis_index
    from .parallel.mesh import device_mesh

    tp = 2 if world % 2 == 0 and world >= 2 else 1
    dp = world // tp
    mesh = device_mesh({"data": dp, "model": tp}, device=dev)
    step, params, _, opt_state, shard = W.build_sharded_train_step(
        mesh, d_dense=D_DENSE, vocab_sizes=VOCAB_SIZES, emb_dim=EMB_DIM,
        hidden=HIDDEN)
    host_batch = _example_batch(8 * dp, np.random.default_rng(0))
    new_params, _, loss = step(params, opt_state, *shard(*host_batch))
    loss_host = float(loss)
    assert np.isfinite(loss_host), f"non-finite loss {loss_host}"
    # the step keeps the tensor-parallel layout: each leaf its shard's shape
    want = W.shard_params(W.init_params(np.random.default_rng(0), D_DENSE,
                                        VOCAB_SIZES, EMB_DIM, HIDDEN),
                          axis_index("model", mesh=mesh), tp)
    for a, b in zip(W.tree_leaves(new_params), W.tree_leaves(want)):
        assert tuple(a.shape) == tuple(np.shape(b)), (a.shape, np.shape(b))
    ref_step, ref_params, ref_state = W.build_reference_train_step(
        D_DENSE, VOCAB_SIZES, EMB_DIM, HIDDEN, device=dev)
    ref_params, _, ref_loss = ref_step(
        ref_params, ref_state, *(torch.from_numpy(a).to(dev)
                                 for a in host_batch))
    W.assert_sharded_matches_reference(new_params, loss_host, ref_params,
                                       float(ref_loss), mesh=mesh)
    return {"loss": loss_host, "ref_loss": float(ref_loss)}


def _leg_grad_reduce(rank, world, dev):
    """Two steps of the top-k 0.1 compressed step on the same mesh: a
    finite loss, and the payload the dense tower puts on the wire."""
    from .models.recommendation import widedeep as W
    from .parallel.grad_reduce import GradReduceConfig, payload_bytes
    from .parallel.mesh import device_mesh

    tp = 2 if world % 2 == 0 and world >= 2 else 1
    dp = world // tp
    mesh = device_mesh({"data": dp, "model": tp}, device=dev)
    gr = GradReduceConfig(mode="topk", density=0.1)
    step, params, _, opt_state, shard, gr_state = \
        W.build_sharded_train_step(mesh, d_dense=D_DENSE,
                                   vocab_sizes=VOCAB_SIZES, emb_dim=EMB_DIM,
                                   hidden=HIDDEN, grad_reduce=gr)
    batch = shard(*_example_batch(8 * dp, np.random.default_rng(0)))
    for _ in range(2):
        params, opt_state, gr_state, loss = step(params, opt_state,
                                                 gr_state, *batch)
    loss_h = float(loss)
    assert np.isfinite(loss_h), f"non-finite compressed loss {loss_h}"
    full = W.gather_sharded_params(params, mesh)
    acc = payload_bytes({k: v for k, v in full.items()
                         if k not in W._LAZY_TABLE_KEYS}, gr)
    if rank == 0:
        print(f"dryrun grad_reduce: topk density=0.1 over {dp}-way data "
              f"axis, loss {loss_h:.4f}, payload {acc['compressed_bytes']}/"
              f"{acc['dense_bytes']} B/step ({acc['compression_ratio']}x)",
              flush=True)
    return {"loss": loss_h, "payload": acc}


def _leg_widedeep_routed(rank, world, dev):
    """``WideDeep.fit`` over the data axis with the routed table gradients
    (the fold on the card) against the one-rank fit with autograd's
    scatter-add on the same global steps: same loss log, same tables."""
    from .data.table import Table
    from .models.recommendation.widedeep import WideDeep
    from .parallel.mesh import device_mesh, local_mesh

    rng = np.random.default_rng(5)
    n = 32 * world
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    cat = np.stack([rng.integers(0, 10, size=n),
                    rng.integers(0, 7, size=n)], axis=1).astype(np.int32)
    label = (dense[:, 0] + 0.2 * (cat[:, 0] - 4.5) > 0).astype(np.int64)
    parts = [tuple(a[r * 32:(r + 1) * 32] for a in (dense, cat, label))
             for r in range(world)]

    def fit(cols, mesh, routed_mode):
        est = (WideDeep(device=dev).set_vocab_sizes([10, 7]).set_max_iter(3)
               .set_seed(0).set_global_batch_size(8 * world)
               .set(WideDeep.ROUTED_EMB_GRAD, routed_mode))
        return est.fit(Table(dict(zip(
            ("denseFeatures", "catFeatures", "label"), cols))), mesh=mesh)

    m_routed = fit(parts[rank], device_mesh({"data": world}, device=dev),
                   "on")
    m_oracle = fit(_one_process_rows(parts, 8 * world, 0), local_mesh(),
                   "off")
    np.testing.assert_allclose(m_routed._loss_log, m_oracle._loss_log,
                               rtol=1e-5, atol=1e-6)
    for k in ("emb", "wide_cat", "wide_dense"):
        np.testing.assert_allclose(np.asarray(m_routed._params[k]),
                                   np.asarray(m_oracle._params[k]),
                                   rtol=1e-4, atol=1e-5)
    return {"loss_log": [float(v) for v in m_routed._loss_log]}


def _leg_mixed_lr(rank, world, dev):
    """The Criteo-native mixed LR fit over ranks against the one-rank fit
    of the same global steps: on the data axis by the port's own plan (at
    the dryrun's 256 slots "plain", the JAX package's off-TPU "xla"); the
    sharded ELL plan (the JAX dryrun forces it by a patch and runs the
    kernels' XLA twin; the port's planner admits it by ``allow_sharded``
    / ``allow_multiprocess``, no patch, at 2^14 slots, the smallest table
    the ELL kernels tile: B1/B2 on the card, the one-rank oracle through
    their plain versions); and dp x model (the weight sharded over
    ``"model"``).  The oracles run first, so the leg's launches are the
    sharded fits'."""
    from .models.common.losses import LOSSES
    from .models.common.sgd import SGDConfig, plan_mixed_impl, sgd_fit_mixed
    from .parallel.mesh import device_mesh, local_mesh

    rng = np.random.default_rng(2)
    # a batch divisible by the ranks keeps every rank's local batch whole
    batch = 4 * world
    n, nd, nc, d = 8 * batch, 3, 2, 256
    d_ell = 1 << 14
    dense = rng.normal(size=(n, nd)).astype(np.float32)
    cat = rng.integers(nd, d, size=(n, nc)).astype(np.int32)
    y = (dense[:, 0] + 0.5 > 0).astype(np.float64)
    cfg = SGDConfig(learning_rate=0.3, max_epochs=3, global_batch_size=batch,
                    tol=0, seed=0)

    def split(k):
        rows = n // k
        return [tuple(a[r * rows:(r + 1) * rows] for a in (dense, cat, y))
                for r in range(k)]

    def fit(cols, width, mesh, plain=False):
        return sgd_fit_mixed(LOSSES["logistic"], cols[0], cols[1], cols[2],
                             None, width, cfg, device=dev, plain=plain,
                             mesh=mesh)

    def oracle(parts, width):
        return fit(_one_process_rows(parts, batch, 0), width, local_mesh(),
                   plain=True)

    data_mesh = device_mesh({"data": world}, device=dev)
    parts = split(world)
    state_1, log_1 = oracle(parts, d)
    state_e1, log_e1 = oracle(parts, d_ell)
    dp_model = world % 2 == 0 and world >= 2
    if dp_model:
        dp_parts = split(world // 2)
        state_d1, log_d1 = oracle(dp_parts, d)
    _reset_launches()

    state_n, log_n = fit(parts[rank], d, data_mesh)
    np.testing.assert_allclose(state_n.coefficients, state_1.coefficients,
                               atol=1e-6)
    np.testing.assert_allclose(log_n, log_1, atol=1e-6)
    assert log_n[-1] < log_n[0]
    out = {"data_plan": state_n.planned_impl, "log": list(log_n)}

    steps = n // batch
    plan = plan_mixed_impl(d_ell, steps, mesh=data_mesh, allow_sharded=True,
                           allow_multiprocess=True)
    assert plan == "ell", plan
    state_e, log_e = fit(parts[rank], d_ell, data_mesh)
    assert state_e.planned_impl == "ell"
    np.testing.assert_allclose(state_e.coefficients, state_e1.coefficients,
                               atol=1e-5)
    np.testing.assert_allclose(log_e, log_e1, atol=1e-6)
    out["ell_log"] = list(log_e)

    if dp_model:
        dpmp = device_mesh({"data": world // 2, "model": 2}, device=dev)
        state_s, log_s = fit(dp_parts[rank // 2], d, dpmp)
        assert state_s.planned_impl == "sharded"
        np.testing.assert_allclose(state_s.coefficients,
                                   state_d1.coefficients, atol=1e-5)
        np.testing.assert_allclose(log_s, log_d1, atol=1e-6)
    return out


def _leg_pp_sp_ep(rank, world, dev):
    """The remaining axis families on the same ranks at the dryrun's
    shapes, each against its dense oracle on the rank: an n-stage tanh
    pipeline, forward and grad; ring attention, causal; the routed MoE,
    tokens over ``data``, experts over ``expert``."""
    from .parallel.mesh import device_mesh
    from .parallel.moe import init_moe, moe_apply
    from .parallel.pipeline_parallel import build_pipeline
    from .parallel.ring_attention import attention_reference, ring_attention

    rng = np.random.default_rng(1)

    # pp: n-stage MLP pipeline, forward + grad (the backward pipeline)
    pipe_mesh = device_mesh({"pipe": world}, device=dev)
    d = 8

    def stage(p, x):
        return torch.tanh(x @ p)

    w_np = (rng.normal(size=(world, d, d)) * 0.3).astype(np.float32)
    x_np = rng.normal(size=(4 * world, d)).astype(np.float32)
    w = torch.from_numpy(w_np).to(dev).requires_grad_(True)
    x = torch.from_numpy(x_np).to(dev)
    out = build_pipeline(stage, pipe_mesh, n_micro=4)(w, x)
    torch.sum(out ** 2).backward()
    assert bool(torch.isfinite(w.grad).all())
    seq_out = x
    for i in range(world):
        seq_out = stage(w[i], seq_out)
    np.testing.assert_allclose(out.detach().cpu().numpy(),
                               seq_out.detach().cpu().numpy(), rtol=1e-5,
                               atol=1e-5)

    # sp: ring attention, sequence sharded over the ring, vs dense oracle
    sp_mesh = device_mesh({"seq": world}, device=dev)
    s = 4 * world
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, 2, 4)).astype(
        np.float32)).to(dev) for _ in range(3))
    blk = slice(4 * rank, 4 * rank + 4)
    got = ring_attention(q[:, blk], k[:, blk], v[:, blk], mesh=sp_mesh,
                         axis="seq", causal=True)
    oracle = attention_reference(q, k, v, causal=True)[:, blk]
    np.testing.assert_allclose(got.cpu().numpy(), oracle.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)

    # ep: routed MoE, experts sharded, tokens data-sharded (dp x ep)
    ep = world // 2 if world % 2 == 0 and world >= 2 else 1
    ep_mesh = device_mesh({"data": world // ep, "expert": ep}, device=dev)
    moe = init_moe(rng, d_model=8, d_hidden=16, n_experts=max(ep, 2),
                   device=dev)
    tokens = torch.from_numpy(rng.normal(size=(16, 8)).astype(
        np.float32)).to(dev)
    rows = 16 // (world // ep)
    mine = slice(rows * (rank // ep), rows * (rank // ep + 1))
    y = moe_apply(moe, tokens[mine], capacity_factor=4.0, mesh=ep_mesh,
                  data_axis="data")
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(
        y.cpu().numpy(), moe_apply(moe, tokens, capacity_factor=4.0)[
            mine].cpu().numpy(), rtol=1e-5, atol=1e-6)
    return None


if __name__ == "__main__":
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    fn, args = entry(dev)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), "finite:",
          bool(torch.isfinite(out).all()))
    dryrun_multichip(4, dev)
    print("dryrun ok")
