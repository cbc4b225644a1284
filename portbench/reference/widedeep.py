"""Wide&Deep trained with Adam on the masked binary log-loss, written from
Cheng et al. 2016 and Kingma and Ba 2015 in plain float32 PyTorch.

Model: a wide tower (a weight a dense feature, a weight a categorical
bucket, a bias) plus a deep tower (the dense features and the 26 field
embeddings concatenated, ReLU layers, one output); the logit is their
sum.  One stacked table holds every field's buckets, each field's ids
offset by the sizes of the fields before it.

What the estimator derives itself from its seed ``s`` is drawn here again
in its order (numpy's ``default_rng``):

- the epoch order: ``default_rng(s).permutation(n)``; the rows in that
  order are cut into ``ceil(n / batch)`` steps, the last padded with rows
  of weight 0;
- the init: from ``default_rng(s + 1)``, each MLP layer's weights
  ``normal * sqrt(2 / fan_in)`` in order, biases 0, then the embedding
  table ``normal * 0.05``; the wide weights start at 0.

Each epoch replays the same order.  A step's loss is the weighted mean of
``log(1 + exp(-y m))`` over the batch; an epoch's loss is the mean of its
step losses.  The table gradients are summed a slot at a time in float64
(``index_add_``) and rounded once to float32, so the reference gives the
same bits run after run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .precision import products


def init_params(seed: int, n_dense: int, vocab_sizes, emb_dim: int,
                hidden) -> Dict:
    rng = np.random.default_rng(seed + 1)
    layers = []
    fan_in = n_dense + len(vocab_sizes) * emb_dim
    for h in list(hidden) + [1]:
        w = (rng.normal(size=(fan_in, h)) * np.sqrt(2.0 / fan_in)).astype(
            np.float32)
        layers.append((w, np.zeros((h,), np.float32)))
        fan_in = h
    total = int(np.sum(vocab_sizes))
    emb = (rng.normal(size=(total, emb_dim)) * 0.05).astype(np.float32)
    return {"wide_cat": np.zeros((total,), np.float32),
            "wide_dense": np.zeros((n_dense,), np.float32),
            "wide_b": np.zeros((), np.float32),
            "emb": emb,
            "mlp": layers}


def leaves(params: Dict) -> Dict[str, np.ndarray]:
    """The parameters as named leaves: ``wide_cat``, ``wide_dense``,
    ``wide_b``, ``emb``, ``mlp.<i>.w``, ``mlp.<i>.b``."""
    out = {k: params[k] for k in ("wide_cat", "wide_dense", "wide_b",
                                  "emb")}
    for i, (w, b) in enumerate(params["mlp"]):
        out[f"mlp.{i}.w"] = w
        out[f"mlp.{i}.b"] = b
    return out


def logit(p: Dict[str, torch.Tensor], n_layers: int, dense, wide_rows,
          emb_rows) -> torch.Tensor:
    wide = dense @ p["wide_dense"] + wide_rows.sum(dim=1) + p["wide_b"]
    h = torch.cat([dense, emb_rows.reshape(emb_rows.shape[0], -1)], dim=1)
    for i in range(n_layers):
        h = h @ p[f"mlp.{i}.w"] + p[f"mlp.{i}.b"]
        if i + 1 < n_layers:
            h = torch.relu(h)
    return wide + h[:, 0]


def fit(dense: np.ndarray, cat: np.ndarray, labels: np.ndarray, *,
        vocab_sizes, emb_dim: int, hidden, lr: float, batch: int,
        epochs: int, seed: int, device, b1: float = 0.9, b2: float = 0.999,
        eps: float = 1e-8, tf32: bool = False,
        keep_half_batch: bool = False, freeze_after=None) -> Dict:
    """The fit's parameters (named leaves, host float32), its per-epoch
    losses and the first step's gradient norm a leaf.  ``tf32`` computes
    the products on the TF32 tensor cores (the control);
    ``keep_half_batch`` drops the second half of every batch and takes the
    mean over the rest, and ``freeze_after`` leaves the parameters and
    Adam's state as they are after that many steps (planted faults)."""
    n = dense.shape[0]
    offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
    ids = (cat.astype(np.int64) + offsets[None, :])
    perm = np.random.default_rng(seed).permutation(n)
    steps = -(-n // batch)
    total = steps * batch

    def epoch_tensor(a, pad):
        a = a[perm]
        if total > n:
            a = np.concatenate([a, np.full((total - n,) + a.shape[1:], pad,
                                           a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(a.reshape(
            (steps, batch) + a.shape[1:]))).to(device)

    X = epoch_tensor(dense.astype(np.float32), 0.0)
    C = epoch_tensor(ids, 0)
    Y = epoch_tensor(labels.astype(np.float32), 0.0)
    M = epoch_tensor(np.ones((n,), np.float32), 0.0)
    if keep_half_batch:
        M[:, batch // 2:] = 0.0

    host = leaves(init_params(seed, dense.shape[1], vocab_sizes, emb_dim,
                              hidden))
    p = {k: torch.from_numpy(np.array(v)).to(device) for k, v in host.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    n_layers = len(hidden) + 1
    dense_keys = [k for k in p if k not in ("emb", "wide_cat")]
    losses: List[float] = []
    grad0 = None
    t = 0
    with products(tf32):
        for _ in range(epochs):
            step_losses = []
            for i in range(steps):
                c = C[i]
                emb_rows = p["emb"][c].detach().requires_grad_(True)
                wide_rows = p["wide_cat"][c].detach().requires_grad_(True)
                rest = {k: p[k].detach().requires_grad_(True)
                        for k in dense_keys}
                with torch.enable_grad():
                    m = logit(rest, n_layers, X[i], wide_rows, emb_rows)
                    z = -(Y[i] * 2.0 - 1.0) * m
                    w = M[i]
                    loss = torch.sum(torch.logaddexp(torch.zeros_like(z), z)
                                     * w) / torch.clamp(torch.sum(w),
                                                        min=1e-12)
                    got = torch.autograd.grad(
                        loss, [rest[k] for k in dense_keys]
                        + [emb_rows, wide_rows])
                g = dict(zip(dense_keys, got[:len(dense_keys)]))
                flat = c.reshape(-1)
                g_emb = torch.zeros(p["emb"].shape, dtype=torch.float64,
                                    device=device)
                g_emb.index_add_(0, flat, got[-2].reshape(
                    -1, emb_dim).double())
                g_wide = torch.zeros(p["wide_cat"].shape,
                                     dtype=torch.float64, device=device)
                g_wide.index_add_(0, flat, got[-1].reshape(-1).double())
                g["emb"], g["wide_cat"] = g_emb.float(), g_wide.float()
                if grad0 is None:
                    grad0 = {k: float(torch.linalg.vector_norm(v))
                             for k, v in g.items()}
                step_losses.append(loss.detach())
                if freeze_after is not None and t >= freeze_after:
                    continue
                t += 1
                c1 = 1.0 - b1 ** t
                c2 = 1.0 - b2 ** t
                for k in p:
                    mu[k] = b1 * mu[k] + (1.0 - b1) * g[k]
                    nu[k] = b2 * nu[k] + (1.0 - b2) * g[k] * g[k]
                    p[k] = p[k] - lr * (mu[k] / c1) / (
                        torch.sqrt(nu[k] / c2) + eps)
            losses.append(float(torch.stack(step_losses).mean()))
    return {"params": {k: v.cpu().numpy() for k, v in p.items()},
            "init": host, "loss_log": np.asarray(losses, np.float64),
            "grad0_norm": grad0}


def change_norm_gaps(params: Dict[str, np.ndarray], ref: Dict,
                     moving_share: float = 1e-3) -> Dict[str, float]:
    """A leaf's gap between the program's and the reference's norm of the
    change from the init, over the larger of the reference's norm of that
    leaf's change and the median leaf's.  Leaves whose first gradient in
    the reference is under ``moving_share`` of the median leaf's are left
    out: Adam moves those by round-off alone."""
    g0 = ref["grad0_norm"]
    g_med = float(np.median(list(g0.values())))
    moved = {}
    for k, p0 in ref["init"].items():
        if g0[k] < moving_share * g_med:
            continue
        moved[k] = (float(np.linalg.norm((params[k] - p0).ravel())),
                    float(np.linalg.norm((ref["params"][k] - p0).ravel())))
    med = float(np.median([r for _, r in moved.values()]))
    return {k: abs(a - r) / max(r, med) for k, (a, r) in moved.items()}


def loss_gaps(loss_log, ref_loss_log) -> np.ndarray:
    """Each epoch's relative gap between the program's and the reference's
    loss."""
    a = np.asarray(loss_log, np.float64)
    r = np.asarray(ref_loss_log, np.float64)
    return np.abs(a - r) / np.abs(r)
