"""Criteo-shaped rows: 13 dense features and 26 categorical fields.

- Dense features are ``log(1 + c)`` of heavy-tailed counts
  ``c = floor(exp(mu + sigma z))``, ``mu`` and ``sigma`` drawn a feature.
- Each field draws its ids from a Zipf law (``zipf_exponent``) over a
  seeded permutation of its buckets, so the hot ids differ by field.
- Labels are Bernoulli from a seeded logistic teacher (a dense weight
  vector plus a random effect a bucket), its bias set by bisection so that
  the mean probability is ``positive_rate``.
"""

from __future__ import annotations

import torch


def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    """The cumulative Zipf probabilities of ranks ``1..vocab`` (float64)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    w = ranks ** (-exponent)
    return torch.cumsum(w, 0) / torch.sum(w)


def make(config: dict, data: dict, seed: int, device) -> dict:
    n = int(config["rows"])
    n_dense = int(config["dense_features"])
    fields = int(config["categorical_fields"])
    vocab = int(config["vocab_per_field"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    lo, hi = data["dense_log_mu"]
    mu = lo + (hi - lo) * torch.rand(n_dense, generator=g, device=device)
    lo, hi = data["dense_log_sigma"]
    sigma = lo + (hi - lo) * torch.rand(n_dense, generator=g, device=device)
    z = torch.randn((n, n_dense), generator=g, device=device)
    counts = torch.floor(torch.exp(torch.clamp(mu + sigma * z, max=30.0)))
    dense = torch.log1p(counts).to(torch.float32)

    cdf = zipf_cdf(vocab, float(data["zipf_exponent"]), device)
    u = torch.rand((n, fields), generator=g, device=device,
                   dtype=torch.float64)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=vocab - 1)
    perms = torch.stack([torch.randperm(vocab, generator=g, device=device)
                         for _ in range(fields)])
    cat = torch.gather(perms, 1, rank.T).T.contiguous()

    w_dense = data["teacher_dense_sd"] * torch.randn(
        n_dense, generator=g, device=device)
    effect = data["teacher_bucket_sd"] * torch.randn(
        (fields, vocab), generator=g, device=device)
    logit = dense @ w_dense + torch.sum(
        torch.gather(effect, 1, cat.T), dim=0)
    lo_b, hi_b = -30.0, 30.0
    for _ in range(48):
        mid = 0.5 * (lo_b + hi_b)
        if float(torch.sigmoid(logit + mid).mean()) > data["positive_rate"]:
            hi_b = mid
        else:
            lo_b = mid
    p = torch.sigmoid(logit + 0.5 * (lo_b + hi_b))
    labels = (torch.rand(n, generator=g, device=device) < p).to(
        torch.float32)
    return {"denseFeatures": dense.cpu().numpy(),
            "catFeatures": cat.to(torch.int32).cpu().numpy(),
            "label": labels.cpu().numpy()}
