"""Synthetic class-conditioned flower images (the port's own copy of
flowerdiff/data/synthetic.py; numpy only).

Deterministic, class-dependent, flower-like images: each class gets a
distinctive petal count, hue and rotation, so conditional training receives
a learnable class signal without the real Flowers102 files. The same seed
gives the same images and labels as the reference's generator.
"""
from __future__ import annotations

import numpy as np


def synthetic_flowers(num_images: int = 256, num_classes: int = 102, img_size: int = 64,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, S, S, 3), labels int32 (N,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_images).astype(np.int32)

    yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
    cx = cy = (img_size - 1) / 2.0
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2) / (img_size / 2.0)
    theta = np.arctan2(yy - cy, xx - cx)

    images = np.empty((num_images, img_size, img_size, 3), np.uint8)
    for i, label in enumerate(labels):
        petals = 3 + int(label) % 7
        hue = (int(label) * 0.618) % 1.0  # golden-ratio hue spread
        phase = rng.uniform(0, 2 * np.pi)
        jitter = rng.uniform(0.85, 1.15)
        petal = 0.55 + 0.35 * np.cos(petals * theta + phase)
        mask = (r < petal * jitter).astype(np.float32)
        core = (r < 0.18).astype(np.float32)
        rgb = _hsv_to_rgb(hue, 0.8, 0.9)
        img = np.stack(
            [mask * c + core * (0.9 - c * 0.5) + (1 - mask) * 0.08 * (1 + k)
             for k, c in enumerate(rgb)],
            axis=-1,
        )
        noise = rng.normal(0, 0.02, img.shape).astype(np.float32)
        images[i] = (np.clip(img + noise, 0, 1) * 255).astype(np.uint8)
    return images, labels


def _hsv_to_rgb(h: float, s: float, v: float) -> tuple[float, float, float]:
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]
