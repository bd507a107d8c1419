"""Reconstruction against generation (port of
flowerdiff/viz/latent_compare.py): three rows per batch of held-out
images: the original, its VAE reconstruction, and a diffusion sample of the
same class."""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from flowerdiff_torch.viz._common import Seed, generators, host, pyplot, sampler_device


def visualize_latent_comparison(encode_decode_fn, decode_fn, sampler, images: torch.Tensor,
                                labels: np.ndarray, class_names: Sequence[str],
                                save_path: str = "./results/latent_comparison.png",
                                seed: Seed = 0, n: int = 8) -> str:
    """The reconstruction from the generator of (seed, 0), the samples from
    (seed, 1)."""
    dev = sampler_device(sampler)
    recon_gen, sample_gen = generators(dev, seed, 2)
    images = images[:n]
    labels = np.asarray(labels)[:n]

    recon = host(encode_decode_fn(images, recon_gen))
    latents = sampler.sample(n, torch.as_tensor(labels, dtype=torch.long, device=dev),
                             generator=sample_gen)
    generated = host(decode_fn(latents))

    plt = pyplot()
    fig, axes = plt.subplots(3, n, figsize=(2 * n, 6.5))
    rows = [(host(images), "Original"), (recon, "VAE recon"), (generated, "Diffusion")]
    for r, (imgs, title) in enumerate(rows):
        for i in range(n):
            axes[r, i].imshow(np.clip(imgs[i], 0, 1))
            axes[r, i].axis("off")
            if r == 0:
                axes[r, i].set_title(class_names[int(labels[i])], fontsize=8)
        axes[r, 0].set_ylabel(title)
    plt.suptitle("Original vs VAE reconstruction vs diffusion generation")
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path
