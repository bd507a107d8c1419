"""Sample grids (port of flowerdiff/viz/grids.py).

  - generate_samples_grid: 10 classes x 5 samples beside a class-name
    column, caption, 150 dpi -> vae_samples_grid_subset.png; the whole grid
    is ONE sampling call of 50 latents and one decode;
  - generate_class_samples: n samples of one class as a strip (class by
    name or index);
  - generate_pixel_samples_grid: an N x N grid of unconditional pixel-space
    samples, one sampling call.

Samplers are the port's facade: `sample(batch, *cond, generator=...)`,
conditions as tensors on the sampler's device; `seed` (an int, or a
`torch.Generator`) stands where the reference takes a key.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowerdiff_torch.viz._common import Seed, generators, host, pyplot, sampler_device


def _resolve_class(target, class_names: Sequence[str]) -> int:
    if isinstance(target, str):
        if target in class_names:
            return list(class_names).index(target)
        raise ValueError(f"Invalid class name: {target!r}")
    return int(target)


def generate_samples_grid(sampler, decode_fn, class_names: Sequence[str], n_per_class: int = 5,
                          n_classes_vis: int = 10, save_dir: str = "./results",
                          seed: Seed = 0) -> str:
    os.makedirs(save_dir, exist_ok=True)
    dev = sampler_device(sampler)
    (gen,) = generators(dev, seed, 1)
    n_classes_vis = min(n_classes_vis, len(class_names))
    classes = torch.arange(n_classes_vis, device=dev).repeat_interleave(n_per_class)
    latents = sampler.sample(n_classes_vis * n_per_class, classes, generator=gen)
    decoded = host(decode_fn(latents))

    plt = pyplot()
    fig, axes = plt.subplots(n_classes_vis, n_per_class + 1,
                             figsize=((n_per_class + 1) * 2, n_classes_vis * 2))
    fig.suptitle("Flowers102 Samples Generated by VAE-Diffusion Model", fontsize=16, y=0.98)
    for i in range(n_classes_vis):
        axes[i, 0].text(0.5, 0.5, class_names[i], fontsize=10, fontweight="bold",
                        ha="center", va="center",
                        bbox=dict(boxstyle="round,pad=0.5", facecolor="lightgray", alpha=0.7))
        axes[i, 0].axis("off")
        for j in range(n_per_class):
            ax = axes[i, j + 1]
            ax.imshow(np.clip(decoded[i * n_per_class + j], 0, 1))
            ax.axis("off")
            if i == 0:
                ax.set_title(f"Sample {j + 1}", fontsize=9)
    plt.figtext(
        0.5, 0.01,
        "Images generated by the conditional latent-diffusion model through "
        "the VAE decoder on Oxford 102 Flowers.\nOnly the first "
        f"{n_classes_vis} classes are shown.",
        ha="center", fontsize=10,
        bbox=dict(boxstyle="round,pad=0.5", facecolor="white", alpha=0.7),
    )
    plt.tight_layout(rect=[0, 0.03, 1, 0.92])
    save_path = os.path.join(save_dir, "vae_samples_grid_subset.png")
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def generate_class_samples(sampler, decode_fn, target_class, class_names: Sequence[str],
                           num_samples: int = 5, save_path: Optional[str] = None,
                           seed: Seed = 0, extra_cond: Optional[torch.Tensor] = None):
    """`num_samples` samples of one class, decoded, as a strip PNG when
    `save_path` is given; returns the decoded images. `extra_cond`: the v3
    color labels."""
    dev = sampler_device(sampler)
    (gen,) = generators(dev, seed, 1)
    class_idx = _resolve_class(target_class, class_names)
    classes = torch.full((num_samples,), class_idx, dtype=torch.long, device=dev)
    cond = (classes,) if extra_cond is None else (classes, extra_cond)
    latents = sampler.sample(num_samples, *cond, generator=gen)
    samples = host(decode_fn(latents))

    if save_path:
        plt = pyplot()
        plt.figure(figsize=(num_samples * 2, 3))
        for i in range(num_samples):
            plt.subplot(1, num_samples, i + 1)
            plt.imshow(np.clip(samples[i], 0, 1))
            plt.axis("off")
            plt.title(str(class_names[class_idx]))
        plt.suptitle(f"Generated {class_names[class_idx]} Samples")
        plt.tight_layout()
        plt.savefig(save_path)
        plt.close()
    return samples


def generate_pixel_samples_grid(sampler, n_samples: int = 16,
                                save_path: str = "samples_grid.png", seed: Seed = 0) -> str:
    """Pixel-space N x N grid from one batched sampling call."""
    (gen,) = generators(sampler_device(sampler), seed, 1)
    rows = int(np.sqrt(n_samples))
    imgs = host(sampler.sample(n_samples, generator=gen))
    plt = pyplot()
    fig, axes = plt.subplots(rows, rows, figsize=(rows * 2, rows * 2))
    for i in range(rows):
        for j in range(rows):
            axes[i, j].imshow(np.clip(imgs[i * rows + j], 0, 1))
            axes[i, j].axis("off")
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path
