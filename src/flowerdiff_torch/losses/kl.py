"""KL divergence with the reference's stability clamps (port of
flowerdiff/losses/kl.py).

mu clamped to [-10, 10], logvar to [-2, 10]; the per-sample KL clamped to
[0, 100] before the batch mean; plus a 1e-4 * sum(mu^2) regulariser.

The regulariser is a SUM over the batch. Under a data-parallel mesh each
rank holds its rows only, and `ranks` (the "data" ranks) scales the sum so
that the mean over the ranks of their values, and of their gradients, is
the global batch's, as the reference computes it under its mesh.
"""
from __future__ import annotations

import torch


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor, ranks: int = 1) -> torch.Tensor:
    mu = torch.clamp(mu, -10.0, 10.0)
    logvar = torch.clamp(logvar, -2.0, 10.0)
    kl = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar), dim=1)
    kl = torch.mean(torch.clamp(kl, 0.0, 100.0))
    return kl + (1e-4 * ranks) * torch.sum(mu**2)
