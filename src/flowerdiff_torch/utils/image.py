"""Image metrics and helpers (port of flowerdiff/utils/image.py)."""
from __future__ import annotations

import numpy as np
import torch


def psnr(x: torch.Tensor, y: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch (0-d f32)."""
    mse = torch.mean((x.float() - y.float()) ** 2)
    return 10.0 * torch.log10(max_val**2 / torch.clamp(mse, min=1e-12))


def to_uint8(img) -> np.ndarray:
    """[0, 1] images (tensor or array) -> uint8, truncating as the reference."""
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    return np.uint8(255 * np.clip(np.asarray(img), 0, 1))


def normalize_latents(z: torch.Tensor, eps: float = 1e-8):
    """Z-score latents over the batch -> (z_norm, mean, std), std with
    ddof=1 (torch's unbiased std, as the reference's)."""
    mean = z.mean(dim=0, keepdim=True)
    std = z.std(dim=0, keepdim=True, unbiased=True)
    return (z - mean) / (std + eps), mean, std
