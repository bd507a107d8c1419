"""The VAE decoder (Decoder, v1:242-290) and the service's uint8 output.

    z -> fc1, LN, swish -> fc2, LN, swish -> (C[-1], base, base), channels first
      -> ResidualBlock(C[-1])
      -> for each level from the deepest: ConvTranspose 4x4 stride 2, GroupNorm
         (channels / 8 groups), swish, then a ResidualBlock except after the last
      -> conv 3x3 to max(4, C[0] / 2), GroupNorm (its channels / 4 groups), swish
      -> conv 3x3 to RGB -> sigmoid -> (B, H, W, 3)
    ResidualBlock (v1:159-178): conv 3x3, LayerNorm2d, swish, conv 3x3,
      LayerNorm2d, channel gate (mean pool, C/8, swish, C, sigmoid), spatial
      gate (channel mean and max, 7x7 conv, sigmoid), + input, swish.
    LayerNorm2d (v1:144-156): per sample and channel over H, W, biased
      variance, the configuration's `ln2d_eps`; affine per channel; its
      statistics in f32 whatever the input's type.
    uint8: round(clip(img, 0, 1) * 255), half to even.

Parameters are a dict by the names in `portbench/harness/weights.py`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _swish(x):
    return x * torch.sigmoid(x)


def _ln2d(x, p, name, eps):
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p[f"{name}.weight"].view(1, -1, 1, 1) + p[f"{name}.bias"].view(1, -1, 1, 1)
    return y.to(x.dtype)


def _conv(x, p, name, **kw):
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), **kw)


def _residual(x, p, name, eps):
    h = _swish(_ln2d(_conv(x, p, f"{name}.conv1", padding=1), p, f"{name}.ln1", eps))
    h = _ln2d(_conv(h, p, f"{name}.conv2", padding=1), p, f"{name}.ln2", eps)
    gate = torch.sigmoid(F.linear(_swish(F.linear(h.mean(dim=(2, 3)),
                                                  p[f"{name}.ca.squeeze.weight"])),
                                  p[f"{name}.ca.excite.weight"]))
    h = h * gate[:, :, None, None]
    pooled = torch.cat([h.mean(dim=1, keepdim=True), h.amax(dim=1, keepdim=True)], dim=1)
    k = p[f"{name}.sa.conv.weight"].shape[-1]
    h = h * torch.sigmoid(_conv(pooled, p, f"{name}.sa.conv", padding=k // 2))
    return _swish(h + x)


def decode(p: Params, cfg: dict, z: torch.Tensor) -> torch.Tensor:
    """(B, latent) f32 -> (B, H, W, 3) in [0, 1]. cfg: the `decoder` block."""
    ch, base = cfg["channels"], cfg["base_size"]
    eps, eps2d = float(cfg["norm_eps"]), float(cfg["ln2d_eps"])

    def ln(x, name):
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)

    h = _swish(ln(F.linear(z, p["fc1.weight"], p["fc1.bias"]), "fc1_ln"))
    h = _swish(ln(F.linear(h, p["fc2.weight"], p["fc2.bias"]), "fc2_ln"))
    h = h.reshape(-1, ch[-1], base, base)
    n = len(ch) - 1
    h = _residual(h, p, f"res{n}", eps2d)
    for i in range(n, 0, -1):
        h = F.conv_transpose2d(h, p[f"up{i}_conv.weight"], p[f"up{i}_conv.bias"], stride=2,
                               padding=1)
        groups = max(1, ch[i - 1] // 8)
        h = _swish(F.group_norm(h, groups, p[f"up{i}_gn.weight"], p[f"up{i}_gn.bias"], eps))
        if i > 1:
            h = _residual(h, p, f"res{i - 1}", eps2d)
    mid = max(4, ch[0] // 2)
    h = _conv(h, p, "final_conv1", padding=1)
    h = _swish(F.group_norm(h, max(1, mid // 4), p["final_gn.weight"], p["final_gn.bias"], eps))
    img = torch.sigmoid(_conv(h, p, "final_conv2", padding=1).float())
    return img.permute(0, 2, 3, 1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
