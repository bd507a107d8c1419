"""Device-resident dataset holder (port of the holder part of
flowerdiff/data/pipeline.py `DeviceDataset`).

Images stay uint8 on the device, (N, H, W, 3) as the reference holds them;
labels (and the optional v3 color labels) are integer tensors. The
augmentation policy is carried as plain attributes for the training paths to
read. The augmentation program itself (flip, rotation, color jitter:
`make_augment_fn`) and the per-batch `batches` iterator belong to the data
pipeline of the VAE-GAN slice and are not ported yet: a training path that
is asked to augment raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flowerdiff_torch.utils.device import resolve_device


class DeviceDataset:
    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 colors: Optional[np.ndarray] = None, augment: bool = True,
                 max_rotation_deg: float = 10.0, jitter: float = 0.2, device=None):
        dev = resolve_device(device)
        images = np.asarray(images)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError("images must be uint8 (N, H, W, C)")
        self.device = dev
        self.n = images.shape[0]
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        self.labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(dev)
        self.colors = (None if colors is None else
                       torch.as_tensor(np.asarray(colors), dtype=torch.int64).to(dev))
        self.augment_enabled = augment
        self.max_rotation_deg = max_rotation_deg
        self.jitter = jitter

    def full(self):
        """The whole split, un-augmented float [0, 1] images and labels."""
        imgs = self.images.float() / 255.0
        if self.colors is not None:
            return imgs, self.labels, self.colors
        return imgs, self.labels
