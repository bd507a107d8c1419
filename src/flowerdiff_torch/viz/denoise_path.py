"""Denoising-path figure (port of flowerdiff/viz/denoise_path.py).

PCA(2) fit on all held-out mu latents; 5 samples denoised from each of 8
evenly spaced start timesteps; the image grid on top, and below the 2-D
PCA path of sample 0 across the start timesteps with arrows, start and end
markers and the target class's centroid; 300 dpi PNG.

All (8 start timesteps x 5 samples) = 40 chains run as ONE batch through
one T-step `masked_denoise`: chain j takes the steps t_start_j .. 0. The
same 5 starting draws are tiled over the 8 start timesteps.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from flowerdiff_torch.viz._common import Seed, generators, host, pyplot, sampler_device
from flowerdiff_torch.viz.latent_plots import encode_split, pca_projection


def visualize_denoising_steps(encode_mu_fn, decode_fn, sampler, test_images: torch.Tensor,
                              test_labels: np.ndarray, class_idx: int,
                              class_names: Sequence[str], save_path: Optional[str] = None,
                              seed: Seed = 0, n_samples: int = 5, steps_to_show: int = 8,
                              extra_cond: Optional[torch.Tensor] = None) -> str:
    """The starting draws from the generator of (seed, 0), the chains'
    step noise from (seed, 1)."""
    dev = sampler_device(sampler)
    init_gen, scan_gen = generators(dev, seed, 2)
    sched = sampler.sched

    all_latents = encode_split(encode_mu_fn, test_images)
    all_labels = np.asarray(test_labels)
    latents_2d, pca = pca_projection(all_latents)

    step_size = sched.n_steps // steps_to_show
    timesteps = list(range(0, sched.n_steps, step_size))[::-1]  # start steps, descending

    x = torch.randn((n_samples, sampler.latent_dim), generator=init_gen, device=dev)
    x_tiled = x.repeat(len(timesteps), 1)  # (8 * 5, D)
    t_start = torch.tensor(timesteps, dtype=torch.long, device=dev).repeat_interleave(n_samples)
    classes = torch.full((len(timesteps) * n_samples,), class_idx, dtype=torch.long, device=dev)
    cond = (classes,) if extra_cond is None else (classes, extra_cond)
    final = sampler.masked_denoise(x_tiled, t_start, *cond, generator=scan_gen)
    decoded = host(decode_fn(final))
    decoded = decoded.reshape(len(timesteps), n_samples, *decoded.shape[1:])

    # chain 0's end point per start timestep, the last one repeated
    path_latents = host(final).reshape(len(timesteps), n_samples, -1)[:, 0, :]
    path_latents = np.vstack([path_latents, path_latents[-1:]])
    path_2d = pca.transform(path_latents)

    plt = pyplot()
    fig = plt.figure(figsize=(16, 16))
    gs = plt.GridSpec(2, 1, height_ratios=[1.5, 1], hspace=0.3)
    ax_top = fig.add_subplot(gs[0])
    ax_top.set_title(f"VAE-Diffusion Denoising Process for {class_names[class_idx]}",
                     fontsize=16, pad=10)
    ax_top.set_xticks([])
    ax_top.set_yticks([])
    sub = gs[0].subgridspec(n_samples, len(timesteps), wspace=0.1, hspace=0.1)
    for i in range(n_samples):
        for j, t in enumerate(timesteps):
            ax = fig.add_subplot(sub[i, j])
            ax.imshow(np.clip(decoded[j, i], 0, 1))
            if i == 0:
                ax.set_title(f"t={t}", fontsize=9)
                for spine in ax.spines.values():
                    spine.set_color("red")
                    spine.set_linewidth(2)
            if j == 0:
                ax.set_ylabel(f"Sample {i + 1}", fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
    plt.figtext(0.02, 0.65, "Path Tracked →", fontsize=12, color="red",
                bbox=dict(facecolor="white", alpha=0.7, edgecolor="red"))

    ax_lat = fig.add_subplot(gs[1])
    for i in range(min(10, len(class_names))):
        mask = all_labels == i
        ax_lat.scatter(latents_2d[mask, 0], latents_2d[mask, 1], label=class_names[i],
                       alpha=0.8 if i == class_idx else 0.3, s=40 if i == class_idx else 20)
    ax_lat.plot(path_2d[:, 0], path_2d[:, 1], "r-o", linewidth=2.5, markersize=8,
                label="Diffusion Path", zorder=10)
    for i in range(len(path_2d) - 1):
        ax_lat.annotate("", xy=tuple(path_2d[i + 1]), xytext=tuple(path_2d[i]),
                        arrowprops=dict(arrowstyle="->", color="darkred", lw=1.5))
    for i, t in enumerate(timesteps):
        ax_lat.annotate(f"t={t}", xy=tuple(path_2d[i]),
                        xytext=(path_2d[i, 0] + 2, path_2d[i, 1] + 2), fontsize=8,
                        color="darkred")
    ax_lat.scatter(*path_2d[0], c="black", s=100, marker="x", label="Start (Noise)", zorder=11)
    ax_lat.scatter(*path_2d[-1], c="green", s=100, marker="*", label="End (Generated)",
                   zorder=11)
    target_mask = all_labels == class_idx
    if target_mask.any():
        center = latents_2d[target_mask].mean(axis=0)
        ax_lat.scatter(*center, c="green", s=300, marker="*", edgecolor="black", alpha=0.7,
                       zorder=9)
        ax_lat.annotate(f"TARGET: {class_names[class_idx]}", xy=tuple(center),
                        xytext=(center[0] + 5, center[1] + 5), fontsize=14,
                        fontweight="bold", color="darkgreen",
                        bbox=dict(boxstyle="round,pad=0.5", facecolor="white", alpha=0.8))
    ax_lat.set_title(f"VAE-Diffusion Path in Latent Space for {class_names[class_idx]}",
                     fontsize=16)
    ax_lat.legend(fontsize=10, loc="best")
    ax_lat.grid(True, linestyle="--", alpha=0.7)
    plt.figtext(
        0.5, 0.01,
        "Denoising process (top) and the corresponding path in latent space "
        "(bottom).\nThe first row (highlighted in red) corresponds to the "
        "latent-space path.",
        ha="center", fontsize=12, bbox=dict(boxstyle="round", facecolor="white", alpha=0.8))
    fig.subplots_adjust(left=0.05, right=0.95, top=0.95, bottom=0.05)
    if save_path is None:
        save_path = f"./results/denoising_path_{class_names[class_idx]}.png"
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return save_path
