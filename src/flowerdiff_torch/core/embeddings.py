"""Time / class / multi-condition embeddings (port of flowerdiff/core/embeddings.py)."""
from __future__ import annotations

import math

import torch
from torch import nn

from flowerdiff_torch.core.layers import swish


def sinusoidal_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """concat(sin, cos) of t * exp(-log(10000) k / (half - 1)), zero-padded
    to `dim` when odd. f32 throughout, as the reference."""
    half = dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(k * (-math.log(10000.0) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if emb.shape[-1] < dim:
        emb = torch.nn.functional.pad(emb, (0, dim - emb.shape[-1]))
    return emb


class TimeEmbedding(nn.Module):
    """sinusoid -> Linear(d, 2d) -> swish -> Linear(2d, d)."""

    def __init__(self, n_channels: int = 256):
        super().__init__()
        self.n_channels = n_channels
        self.lin1 = nn.Linear(n_channels, 2 * n_channels)
        self.lin2 = nn.Linear(2 * n_channels, n_channels)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = sinusoidal_time_embedding(t, self.n_channels)
        return self.lin2(swish(self.lin1(emb)))


class ClassEmbedding(nn.Module):
    """Embedding(num_classes, d) -> Linear -> swish -> Linear."""

    def __init__(self, num_classes: int = 102, n_channels: int = 256):
        super().__init__()
        self.embedding = nn.Embedding(num_classes, n_channels)
        self.lin1 = nn.Linear(n_channels, n_channels)
        self.lin2 = nn.Linear(n_channels, n_channels)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.lin2(swish(self.lin1(self.embedding(c))))


class MultiConditionEmbedding(nn.Module):
    """Embed(classes, d) ++ Embed(colors, d) -> Linear(2d, d) (v3)."""

    def __init__(self, num_classes: int = 102, num_colors: int = 10,
                 n_channels: int = 256):
        super().__init__()
        self.flower_embedding = nn.Embedding(num_classes, n_channels)
        self.color_embedding = nn.Embedding(num_colors, n_channels)
        self.proj = nn.Linear(2 * n_channels, n_channels)

    def forward(self, flower: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        joint = torch.cat([self.flower_embedding(flower),
                           self.color_embedding(color)], dim=-1)
        return self.proj(joint)
