"""Conv-stack building blocks (port of flowerdiff/core/layers.py).

NCHW, torch's habit; the public decoder output is converted back to the
reference's NHWC (models/vae.py). Submodules carry the flax module names so
the weight bridge (utils/weights.py) maps parameters by name.

Reduced precision is torch autocast around a module (the reference's flax
`dtype`): convolutions and Linears then take bf16 inputs, LayerNorm2d keeps
its statistics in f32 and returns its input's type, as the reference's
does, and `full_precision` marks the parts the reference keeps in f32.

`ConditionedResidualBlock` is not ported: no model of the JAX package uses it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Kaiming-normal std of the reference init (core/layers.py:27-32):
# variance scale 2 / (1 + 0.2**2) over fan_in.
KAIMING_GAIN = 2.0 / (1.0 + 0.2**2)


def kaiming_std(fan_in: int) -> float:
    return math.sqrt(KAIMING_GAIN / fan_in)


def full_precision(x: torch.Tensor):
    """A block with autocast off on x's device: what runs in it computes in
    the type of its operands (cast them to f32 first)."""
    return torch.autocast(x.device.type, enabled=False)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return F.silu(x)


class LayerNorm2d(nn.Module):
    """Per-(sample, channel) normalisation over H, W with a per-channel
    affine; biased variance, eps 1e-5 (the reference's LayerNorm2d). The
    statistics and the affine are f32; the output takes the input's type."""

    def __init__(self, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


class CALayer(nn.Module):
    """Squeeze-excite channel gate: pool -> C/r -> swish -> C -> sigmoid."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.squeeze = nn.Linear(channels, channels // reduction, bias=False)
        self.excite = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=(2, 3))
        gate = torch.sigmoid(self.excite(swish(self.squeeze(pooled))))
        return x * gate[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial gate: [mean_c, max_c] -> 7x7 conv -> sigmoid."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stacked = torch.cat([x.mean(dim=1, keepdim=True),
                             x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.conv(stacked))


class ResidualBlock(nn.Module):
    """conv3x3 -> LN2d -> swish -> conv3x3 -> LN2d -> CA -> SA -> +res -> swish."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.ln1 = LayerNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1)
        self.ln2 = LayerNorm2d(channels)
        self.ca = CALayer(channels)
        self.sa = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = swish(self.ln1(self.conv1(x)))
        h = self.ln2(self.conv2(h))
        h = self.sa(self.ca(h))
        return swish(h + x)
