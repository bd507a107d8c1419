"""Reconstruction grid (port of flowerdiff/viz/recon.py): 8 held-out
images, originals over reconstructions ->
test_vae_reconstruction_epoch_{N}.png."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from flowerdiff_torch.viz._common import Seed, generators, host, pyplot


def visualize_reconstructions(encode_decode_fn, images: torch.Tensor, labels: np.ndarray,
                              epoch: int, class_names: Sequence[str],
                              save_dir: str = "./results", seed: Seed = 0, n: int = 8) -> str:
    """encode_decode_fn(images, generator) -> reconstructions (encode,
    reparameterise, decode)."""
    os.makedirs(save_dir, exist_ok=True)
    images = images[:n]
    (gen,) = generators(images.device, seed, 1)
    recon = host(encode_decode_fn(images, gen))
    originals = host(images)

    plt = pyplot()
    fig, axes = plt.subplots(2, n, figsize=(2 * n, 4))
    for i in range(n):
        axes[0, i].imshow(np.clip(originals[i], 0, 1))
        axes[0, i].set_title(f"Original: {class_names[int(labels[i])]}")
        axes[0, i].axis("off")
        axes[1, i].imshow(np.clip(recon[i], 0, 1))
        axes[1, i].set_title("Reconstruction")
        axes[1, i].axis("off")
    plt.tight_layout()
    save_path = os.path.join(save_dir, f"test_vae_reconstruction_epoch_{epoch}.png")
    plt.savefig(save_path)
    plt.close(fig)
    return save_path
