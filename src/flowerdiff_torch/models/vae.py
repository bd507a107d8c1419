"""VAE decoder (port of the `Decoder` and `FlowerVAE.decode` of
flowerdiff/models/vae.py).

z -> fc1 (LN, swish) -> fc2 (LN, swish) -> (deep, base, base) -> ResidualBlock
and 4x4 stride-2 transposed-conv ups (GroupNorm ch/8 groups, swish) -> 3x3
convs (GroupNorm) -> sigmoid. The convolutions run NCHW through PyTorch's
own operators (they are XLA convolutions in the reference, not Pallas).

Layout: the reference flattens HWC-major; here fc2's output is reshaped
CHW-major, so the weight bridge permutes fc2's output rows and fc2_ln's
affine. The decoded image is returned NHWC (B, H, W, 3) like the reference.

`Encoder`, `LatentClassifier` and `reparameterize` are not on the sampling
path and are not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from flowerdiff_torch.core.layers import ResidualBlock, swish

NORM_EPS = 1e-6  # flax LayerNorm / GroupNorm default


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
    """The decode half of the reference `FlowerVAE`: `decode(z)` -> images in
    [0, 1], NHWC."""

    def __init__(self, latent_dim: int = 256, in_channels: int = 3,
                 channels: tuple = (64, 128, 256, 512), head_width: int = 512,
                 base_size: int = 8):
        super().__init__()
        self.decoder = Decoder(latent_dim, in_channels, channels, head_width,
                               base_size)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    forward = decode
