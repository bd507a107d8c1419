"""GAN losses on discriminator LOGITS (port of flowerdiff/losses/gan.py).

The discriminator has no final sigmoid; the binary cross-entropy is the
stable form max(x, 0) - x t + log1p(exp(-|x|)).

D loss: (BCE(D(real), 1) + BCE(D(fake.detach()), 0)) / 2
G adv:  BCE(D(recon), 1)
"""
from __future__ import annotations

import torch


def bce_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy from logits."""
    return torch.mean(torch.clamp(logits, min=0.0) - logits * targets
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    real = bce_loss(real_logits, torch.ones_like(real_logits))
    fake = bce_loss(fake_logits, torch.zeros_like(fake_logits))
    return 0.5 * (real + fake)


def generator_adv_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return bce_loss(fake_logits, torch.ones_like(fake_logits))
