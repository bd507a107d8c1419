"""Latent-space projections (port of flowerdiff/viz/latent_plots.py).

  - encode_split: a whole split to mu latents in batches of 500, one host
    copy at the end;
  - visualize_latent_space: t-SNE (perplexity min(40, N / 4), 1000 iters,
    seed 42) of the split's mu's, the first 10 classes scattered ->
    vae_latent_space_epoch_{N}.png; any failure (sklearn or matplotlib
    missing included) prints one line and writes nothing, as the
    reference's guard does;
  - pca_projection: PCA(2, seed 42).

t-SNE and PCA run on the host (sklearn).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flowerdiff_torch.viz._common import host, pyplot


def encode_split(encode_mu_fn, images: torch.Tensor, batch_size: int = 500) -> np.ndarray:
    """(N, latent) mu latents of `images`, encoded `batch_size` at a time."""
    chunks = [encode_mu_fn(images[start:start + batch_size])
              for start in range(0, images.shape[0], batch_size)]
    return np.concatenate([host(c) for c in chunks], axis=0)


def visualize_latent_space(encode_mu_fn, images: torch.Tensor, labels: np.ndarray, epoch: int,
                           class_names: Sequence[str], save_dir: str = "./results",
                           max_points: Optional[int] = None) -> Optional[str]:
    os.makedirs(save_dir, exist_ok=True)
    latents = encode_split(encode_mu_fn, images)
    labels = np.asarray(labels)
    if max_points is not None and latents.shape[0] > max_points:
        latents, labels = latents[:max_points], labels[:max_points]
    try:
        from sklearn.manifold import TSNE

        plt = pyplot()
        perplexity = min(40, max(2, latents.shape[0] // 4))
        tsne = TSNE(n_components=2, random_state=42, perplexity=perplexity, max_iter=1000)
        latents_2d = tsne.fit_transform(latents)
        plt.figure(figsize=(10, 8))
        for i in range(min(10, len(class_names))):
            mask = labels == i
            plt.scatter(latents_2d[mask, 0], latents_2d[mask, 1], label=class_names[i],
                        alpha=0.6)
        plt.title(f"t-SNE Visualization of VAE Latent Space (Epoch {epoch})")
        plt.legend()
        plt.grid(True, linestyle="--", alpha=0.7)
        plt.tight_layout()
        save_path = os.path.join(save_dir, f"vae_latent_space_epoch_{epoch}.png")
        plt.savefig(save_path)
        plt.close()
        return save_path
    except Exception as exc:  # noqa: BLE001 - the reference's guard around the figure
        print(f"t-SNE visualization error: {exc}")
        return None


def pca_projection(latents: np.ndarray) -> Tuple[np.ndarray, object]:
    """PCA(2, seed 42) fit: (projected (N, 2), the fitted PCA)."""
    from sklearn.decomposition import PCA

    pca = PCA(n_components=2, random_state=42)
    return pca.fit_transform(latents), pca
