"""DCGAN-style 64x64 discriminator (port of flowerdiff/models/discriminator.py).

Four 4x4 stride-2 convs (64/128/256/512, padding 1) with LeakyReLU(0.2),
GroupNorm(32) after all but the first (flax's epsilon, 1e-6), then a VALID
4x4 head conv to one logit per image, in f32 whatever the autocast around
it. The output is LOGITS (no sigmoid): the losses take logits
(losses/gan.py). Inputs are NHWC images of 64x64, like the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flowerdiff_torch.core.layers import full_precision
from flowerdiff_torch.utils.device import resolve_device

NORM_EPS = 1e-6
WIDTHS = (64, 128, 256, 512)


class Discriminator64(nn.Module):
    def __init__(self, in_channels: int = 3, device=None):
        """Built on `device` (default cuda; raises without a card)."""
        super().__init__()
        dev = resolve_device(device)
        prev = in_channels
        for i, ch in enumerate(WIDTHS):
            self.add_module(f"conv{i}", nn.Conv2d(prev, ch, 4, stride=2, padding=1))
            if i > 0:
                self.add_module(f"norm{i}", nn.GroupNorm(32, ch, eps=NORM_EPS))
            prev = ch
        self.head = nn.Conv2d(prev, 1, 4)
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 64, 64, C) -> logits (B,), f32."""
        h = x.permute(0, 3, 1, 2)
        for i in range(len(WIDTHS)):
            h = getattr(self, f"conv{i}")(h)
            if i > 0:
                h = getattr(self, f"norm{i}")(h)
            h = F.leaky_relu(h, 0.2)
        with full_precision(h):
            return self.head(h.float()).reshape(x.shape[0])
