"""Euclidean-distance loss (port of flowerdiff/losses/distances.py).

Per-sample L2 norm of the flattened difference (not an elementwise MSE):
sqrt(sum((x - y)^2) + 1e-8), reduced by mean / sum / none.
"""
from __future__ import annotations

import torch


def euclidean_distance_loss(x: torch.Tensor, y: torch.Tensor,
                            reduction: str = "mean") -> torch.Tensor:
    # accumulate in f32 whatever the input type (a no-op for f32 inputs)
    diff = (x - y).reshape(x.shape[0], -1).float()
    dist = torch.sqrt((diff * diff).sum(dim=1) + 1e-8)
    if reduction == "mean":
        return dist.mean()
    if reduction == "sum":
        return dist.sum()
    if reduction == "none":
        return dist
    raise ValueError(f"unknown reduction {reduction!r}")
