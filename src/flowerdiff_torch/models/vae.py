"""VAE encoder and decoder (port of the `Encoder`, `Decoder` and the
encode / reparameterize / decode methods of `FlowerVAE` in
flowerdiff/models/vae.py).

Encoder: image -> 3x3 conv stem (LayerNorm2d, swish) -> three 4x4 stride-2
downs (LayerNorm2d, swish, ResidualBlock) -> flatten -> twin MLP heads
(fc1, LN, swish, fc2) for mu and logvar.

Decoder: z -> fc1 (LN, swish) -> fc2 (LN, swish) -> (deep, base, base) -> ResidualBlock
and 4x4 stride-2 transposed-conv ups (GroupNorm ch/8 groups, swish) -> 3x3
convs (GroupNorm) -> sigmoid. The convolutions run NCHW through PyTorch's
own operators (they are XLA convolutions in the reference, not Pallas).

Layout: images are NHWC (B, H, W, 3) at the public functions, like the
reference, and NCHW inside. The reference flattens HWC-major; here the
encoder flattens, and the decoder's fc2 output is reshaped, CHW-major, so
the weight bridge permutes the heads' fc1 input columns, fc2's output rows
and fc2_ln's affine.

`LatentClassifier` and `init_all` come with the VAE-GAN slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from flowerdiff_torch.core.layers import LayerNorm2d, ResidualBlock, swish

NORM_EPS = 1e-6  # flax LayerNorm / GroupNorm default
LOGVAR_MIN, LOGVAR_MAX = -2.0, 10.0


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, latent_dim: int = 256,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8):
        super().__init__()
        self.channels = tuple(channels)
        ch = self.channels
        self.stem_conv = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.stem_ln = LayerNorm2d(ch[0])
        for i in range(1, len(ch)):
            self.add_module(f"down{i}_conv", nn.Conv2d(ch[i - 1], ch[i], 4, stride=2, padding=1))
            self.add_module(f"down{i}_ln", LayerNorm2d(ch[i]))
            self.add_module(f"res{i}", ResidualBlock(ch[i]))
        flat = ch[-1] * base_size**2
        for name in ("mu", "logvar"):
            self.add_module(f"{name}_fc1", nn.Linear(flat, head_width))
            self.add_module(f"{name}_ln", nn.LayerNorm(head_width, eps=NORM_EPS))
            self.add_module(f"{name}_fc2", nn.Linear(head_width, latent_dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) in [0, 1] -> (mu, logvar), each (B, latent)."""
        h = swish(self.stem_ln(self.stem_conv(x.permute(0, 3, 1, 2))))
        for i in range(1, len(self.channels)):
            h = getattr(self, f"down{i}_conv")(h)
            h = swish(getattr(self, f"down{i}_ln")(h))
            h = getattr(self, f"res{i}")(h)
        flat = h.flatten(1)

        def head(name: str) -> torch.Tensor:
            y = swish(getattr(self, f"{name}_ln")(getattr(self, f"{name}_fc1")(flat)))
            return getattr(self, f"{name}_fc2")(y)

        return head("mu"), head("logvar")


class Decoder(nn.Module):
    def __init__(self, latent_dim: int = 256, out_channels: int = 3,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8):
        super().__init__()
        self.channels = tuple(channels)
        self.base_size = base_size
        deep = self.channels[-1]
        self.fc1 = nn.Linear(latent_dim, head_width)
        self.fc1_ln = nn.LayerNorm(head_width, eps=NORM_EPS)
        self.fc2 = nn.Linear(head_width, deep * base_size**2)
        self.fc2_ln = nn.LayerNorm(deep * base_size**2, eps=NORM_EPS)
        n_ups = len(self.channels) - 1
        self.add_module(f"res{n_ups}", ResidualBlock(deep))
        prev = deep
        for i in range(n_ups, 0, -1):
            ch = self.channels[i - 1]
            self.add_module(f"up{i}_conv",
                            nn.ConvTranspose2d(prev, ch, 4, stride=2, padding=1))
            self.add_module(f"up{i}_gn",
                            nn.GroupNorm(max(1, ch // 8), ch, eps=NORM_EPS))
            if i > 1:
                self.add_module(f"res{i - 1}", ResidualBlock(ch))
            prev = ch
        mid = max(4, self.channels[0] // 2)
        self.final_conv1 = nn.Conv2d(prev, mid, 3, padding=1)
        self.final_gn = nn.GroupNorm(max(1, mid // 4), mid, eps=NORM_EPS)
        self.final_conv2 = nn.Conv2d(mid, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = swish(self.fc1_ln(self.fc1(z)))
        h = swish(self.fc2_ln(self.fc2(h)))
        h = h.reshape(-1, self.channels[-1], self.base_size, self.base_size)
        n_ups = len(self.channels) - 1
        h = getattr(self, f"res{n_ups}")(h)
        for i in range(n_ups, 0, -1):
            h = getattr(self, f"up{i}_conv")(h)
            h = swish(getattr(self, f"up{i}_gn")(h))
            if i > 1:
                h = getattr(self, f"res{i - 1}")(h)
        h = swish(self.final_gn(self.final_conv1(h)))
        img = torch.sigmoid(self.final_conv2(h))
        return img.permute(0, 2, 3, 1)  # NHWC, as the reference returns it


class FlowerVAE(nn.Module):
    """The reference `FlowerVAE` without its classifier head: encoder,
    reparameterisation and `decode(z)` -> images in [0, 1], NHWC."""

    def __init__(self, latent_dim: int = 256, in_channels: int = 3,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8):
        super().__init__()
        self.encoder = Encoder(in_channels, latent_dim, channels, head_width,
                               base_size)
        self.decoder = Decoder(latent_dim, in_channels, channels, head_width,
                               base_size)

    @staticmethod
    def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mu + noise * exp(0.5 * clamp(logvar, -2, 10)); the standard-normal
        noise is drawn from `generator` unless given."""
        std = torch.exp(0.5 * torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX))
        if noise is None:
            noise = torch.randn(std.shape, generator=generator, device=std.device,
                                dtype=std.dtype)
        return mu + noise * std

    def encode_with_params(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, clamped logvar) of NHWC images."""
        mu, logvar = self.encoder(x)
        return mu, torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    forward = decode
