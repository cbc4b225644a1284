"""Points of a Gaussian mixture: ``true_centers`` centers drawn
``N(0, center_sd^2)`` a coordinate, each point a uniformly chosen center
plus ``N(0, noise_sd^2)`` noise.  Drawn in float32 on the device and handed
over as the float64 arrays a Flink ``DenseVector`` column holds (every
float32 value is exact in float64)."""

from __future__ import annotations

import torch


def make(config: dict, data: dict, seed: int, device) -> dict:
    n, d = int(config["n"]), int(config["d"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = data["center_sd"] * torch.randn(
        (int(data["true_centers"]), d), generator=g, device=device)
    which = torch.randint(0, centers.shape[0], (n,), generator=g,
                          device=device)
    points = centers[which] + data["noise_sd"] * torch.randn(
        (n, d), generator=g, device=device)
    return {"features": points.cpu().numpy().astype("float64")}
