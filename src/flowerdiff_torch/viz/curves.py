"""Loss-curve PNGs (port of flowerdiff/viz/curves.py):
autoencoder_losses.png, and diffusion_loss.png /
diffusion_loss_continued.png."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from flowerdiff_torch.viz._common import pyplot

_AE_CURVES = [  # (history key, legend label)
    ("total", "Total Loss"),
    ("recon", "Reconstruction Loss"),
    ("kl", "KL Loss"),
    ("class", "Classification Loss"),
    ("center", "Center Loss"),
]


def plot_loss_curves(history: Dict[str, List[float]],
                     save_path: str = "./results/autoencoder_losses.png",
                     title: str = "Autoencoder Training Losses") -> str:
    plt = pyplot()
    plt.figure(figsize=(10, 6))
    for key, label in _AE_CURVES:
        if key in history and history[key]:
            plt.plot(history[key], label=label)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.title(title)
    plt.legend()
    plt.grid(True)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close()
    return save_path


def plot_single_loss_curve(losses: Sequence[float],
                           save_path: str = "./results/diffusion_loss.png",
                           title: str = "Diffusion Model Training Loss",
                           start_epoch: Optional[int] = None) -> str:
    plt = pyplot()
    plt.figure(figsize=(8, 5))
    if start_epoch:
        plt.plot(range(start_epoch + 1, start_epoch + len(losses) + 1), losses)
    else:
        plt.plot(losses)
    plt.title(title)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.grid(True)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    plt.savefig(save_path)
    plt.close()
    return save_path
