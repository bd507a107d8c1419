"""v3 color-conditioning figures (port of flowerdiff/viz/color_viz.py).

  - create_flower_color_visualization: a 4 x 5 grid of dataset images, each
    with its extracted color name and a swatch -> color_visualization.png;
  - generate_class_color_samples: a strip of samples conditioned on
    (flower class, color), each by name or index ->
    sample_class_color_{name}_{color}_*.png.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowerdiff_torch.data.color_labels import (
    COLOR_CATEGORIES,
    COLOR_MAPPING,
    COLOR_NAMES,
    extract_color_category,
)
from flowerdiff_torch.viz._common import Seed, generators, host, pyplot, sampler_device


def create_flower_color_visualization(images: np.ndarray, flower_labels: np.ndarray,
                                      class_names: Sequence[str], num_samples: int = 20,
                                      save_path: str = "flower_color_visualization.png",
                                      color_labels: Optional[np.ndarray] = None) -> str:
    """Samples with their color label (given, or extracted) and a swatch."""
    import matplotlib.patches as mpatches

    plt = pyplot()
    n = min(num_samples, len(images))
    cols = 5
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(cols * 3, rows * 3.2))
    axes = np.atleast_2d(axes)
    for i in range(rows * cols):
        ax = axes[i // cols, i % cols]
        ax.axis("off")
        if i >= n:
            continue
        img = np.asarray(images[i])
        shown = img if img.max() <= 1.0 else img / 255.0
        ax.imshow(np.clip(shown, 0, 1))
        if color_labels is not None:
            color_name = COLOR_NAMES[int(color_labels[i])]
        else:
            color_name, _ = extract_color_category(img)
        ax.set_title(f"{class_names[int(flower_labels[i])]}\ncolor: {color_name}", fontsize=9)
        if color_name in COLOR_CATEGORIES:
            swatch = np.asarray(COLOR_CATEGORIES[color_name], np.float32) / 255.0
            ax.add_patch(mpatches.Rectangle((0.02, 0.02), 0.2, 0.12, transform=ax.transAxes,
                                            facecolor=swatch, edgecolor="black", linewidth=1))
    plt.suptitle("Flowers with automatically extracted color labels", fontsize=14)
    plt.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path


def generate_class_color_samples(sampler, decode_fn, target_class, target_color,
                                 class_names: Sequence[str], num_samples: int = 5,
                                 save_path: Optional[str] = None, seed: Seed = 0):
    """Samples conditioned on (class, color), by names or indices, in one
    sampling call; a strip PNG when `save_path` is given. Returns the
    decoded images."""
    dev = sampler_device(sampler)
    (gen,) = generators(dev, seed, 1)
    if isinstance(target_class, str):
        target_class = list(class_names).index(target_class)
    if isinstance(target_color, str):
        target_color = COLOR_MAPPING[target_color]

    classes = torch.full((num_samples,), int(target_class), dtype=torch.long, device=dev)
    colors = torch.full((num_samples,), int(target_color), dtype=torch.long, device=dev)
    latents = sampler.sample(num_samples, classes, colors, generator=gen)
    samples = host(decode_fn(latents))

    if save_path:
        plt = pyplot()
        color_name = COLOR_NAMES[int(target_color)]
        plt.figure(figsize=(num_samples * 2, 3))
        for i in range(num_samples):
            plt.subplot(1, num_samples, i + 1)
            plt.imshow(np.clip(samples[i], 0, 1))
            plt.axis("off")
            plt.title(f"{class_names[int(target_class)]}\n{color_name}", fontsize=9)
        plt.suptitle(f"Generated {color_name} {class_names[int(target_class)]} samples")
        plt.tight_layout()
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        plt.savefig(save_path)
        plt.close()
    return samples
