"""Pixel-space 2-D UNet of the v4/v5 DDPM (port of
flowerdiff/models/pixel_unet.py).

  - time path: the raw float timestep (not normalised) -> Linear(1, E) ->
    ReLU -> Linear(E, E), then one Linear a stage to its channel count,
    added as a (B, C, 1, 1) bias after the stage's convolutions;
  - encoder: double conv (base) -> 4x4/s2 down -> double conv (2 base) ->
    down -> double conv (4 base); bottleneck 4 base -> 8 base -> 4 base;
  - decoder: 4x4/s2 transposed convs (flax `SAME`: torch's padding 1 with
    the kernel flipped, which the weight bridge does), each followed by the
    CONCATENATION [up, skip] on the channel axis and a double conv; a 3x3
    output conv;
  - v5 (`learnable_residual`): out += res_ratio * x, res_ratio starting at
    0.1.

All ReLU, no normalisation layers. Images are NHWC (B, H, W, 3) at
`forward`, like the reference, and NCHW inside.

Precision: compute_dtype 'bfloat16' (the reference's `dtype`) runs the
convolutions under bf16 autocast; the time MLP, the three stage-bias
Linears and the output conv stay f32, as flax gives them no `dtype`. A bf16
conv output plus an f32 stage bias promotes to f32 in both frameworks, and
the output conv reads its input cast to f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from flowerdiff_torch.core.layers import full_precision

COMPUTE_DTYPES = ("float32", "bfloat16")


class PixelUNet(nn.Module):
    def __init__(self, in_channels: int = 3, base_channels: int = 64, time_emb_dim: int = 128,
                 learnable_residual: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: choose one of {COMPUTE_DTYPES}")
        b, e = base_channels, time_emb_dim
        self.in_channels, self.base_channels = in_channels, base_channels
        self.learnable_residual, self.compute_dtype = learnable_residual, compute_dtype
        self.time_fc_a = nn.Linear(1, e)
        self.time_fc_b = nn.Linear(e, e)
        for i, ch in enumerate((b, 2 * b, 4 * b), start=1):
            self.add_module(f"time_to_s{i}", nn.Linear(e, ch))

        def double(name, cin, cout):
            self.add_module(f"{name}_a", nn.Conv2d(cin, cout, 3, padding=1))
            self.add_module(f"{name}_b", nn.Conv2d(cout, cout, 3, padding=1))

        double("conv1", in_channels, b)
        self.down1 = nn.Conv2d(b, 2 * b, 4, stride=2, padding=1)
        double("conv2", 2 * b, 2 * b)
        self.down2 = nn.Conv2d(2 * b, 4 * b, 4, stride=2, padding=1)
        double("conv3", 4 * b, 4 * b)
        self.bottleneck_a = nn.Conv2d(4 * b, 8 * b, 3, padding=1)
        self.bottleneck_b = nn.Conv2d(8 * b, 4 * b, 3, padding=1)
        self.up1 = nn.ConvTranspose2d(4 * b, 2 * b, 4, stride=2, padding=1)
        double("conv4", 4 * b, 2 * b)
        self.up2 = nn.ConvTranspose2d(2 * b, b, 4, stride=2, padding=1)
        double("conv5", 2 * b, b)
        self.out_conv = nn.Conv2d(b, in_channels, 3, padding=1)
        if learnable_residual:
            self.res_ratio = nn.Parameter(torch.tensor(0.1))

    def _double(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = F.relu(getattr(self, f"{name}_a")(h))
        return F.relu(getattr(self, f"{name}_b")(h))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) images or noisy images; t: (B,) timesteps ->
        eps, (B, H, W, C) f32."""
        with full_precision(x):
            t_emb = t.to(torch.float32).reshape(-1, 1)
            t_emb = self.time_fc_b(F.relu(self.time_fc_a(t_emb)))
            biases = [getattr(self, f"time_to_s{i}")(t_emb)[:, :, None, None]
                      for i in (1, 2, 3)]
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.compute_dtype == "bfloat16"):
            h = x.permute(0, 3, 1, 2)
            x1 = self._double(h, "conv1") + biases[0]
            x2 = self._double(self.down1(x1), "conv2") + biases[1]
            x3 = self._double(self.down2(x2), "conv3") + biases[2]
            h = F.relu(self.bottleneck_a(x3))
            h = F.relu(self.bottleneck_b(h))
            h = self._double(torch.cat([self.up1(h), x2], dim=1), "conv4")
            h = self._double(torch.cat([self.up2(h), x1], dim=1), "conv5")
        with full_precision(h):
            out = self.out_conv(h.float()).permute(0, 2, 3, 1)
            if self.learnable_residual:
                out = out + self.res_ratio * x.float()
        return out
