"""Multi-epoch training windows over a device-resident dataset (port of the
latent-cache part of flowerdiff/train/fused.py).

The reference compiles a window of epochs into one `lax.scan` program. Here
a window is a plain Python loop over the steps, each step enqueueing its
kernels without a host synchronisation; the losses come back as one device
tensor. (A CUDA graph of the step is later performance work.)

Ported: `epoch_rows`, `make_latent_cache_builder`, `make_fused_cached_epochs`.
The uncached `make_fused_latent_epochs` and every augmenting path need the
device-side augmentation program of the data pipeline, which comes with the
VAE-GAN slice: asking for them raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    make_latent_denoise_body,
    make_latent_encode_fn,
)

_KERNEL_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def epoch_rows(rng, n: int, batch_size: int, epochs: int, shuffle: bool = True,
               drop_remainder: bool = True) -> Tuple[np.ndarray, int]:
    """Host-side index plan: (T, B) int64 dataset rows for `epochs` epochs
    over an n-item dataset, one permutation per epoch, and the steps per
    epoch. The same integer seed gives the same rows as the reference's
    `epoch_rows`. With drop_remainder=False the short tail batch is padded
    by wrapping rows from the start of the same epoch's permutation."""
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(int(rng))
    steps = n // batch_size if drop_remainder else -(-n // batch_size)
    if steps == 0:
        steps = 1
        batch_size = n
    idx = np.empty((epochs * steps, batch_size), np.int64)
    for e in range(epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        for s in range(steps):
            row = order[s * batch_size:(s + 1) * batch_size]
            if len(row) < batch_size:  # wrap the tail (only if not dropping)
                row = np.concatenate([row, order[:batch_size - len(row)]])
            idx[e * steps + s] = row
    return idx, steps


def make_fused_latent_epochs(*args, **kwargs):
    """The uncached fused epochs encode freshly augmented images every
    epoch; they wait for the augmentation program."""
    raise NotImplementedError(
        "make_fused_latent_epochs needs the device-side augmentation program, "
        "which comes with the VAE-GAN slice; use cfg.latent_cache > 0")


def make_latent_cache_builder(vae: FlowerVAE, cfg: LatentDiffusionConfig,
                              augment: bool = True, max_rotation_deg: float = 10.0,
                              jitter: float = 0.2, chunk: int = 255):
    """build(images_u8, generator, latent_stats=None) -> the (K, N, latent)
    f32 pool of frozen-VAE posterior draws, slot k holding one fresh
    reparameterisation draw of the whole dataset, encoded in `chunk`-sized
    pieces. cfg.encode_dtype='bfloat16' runs the encoder under autocast;
    the noise and the pool stay f32."""
    if augment:
        raise NotImplementedError(
            "device-side augmentation (make_augment_fn: flip, rotation, color "
            "jitter) comes with the VAE-GAN slice's data pipeline; build the "
            "DeviceDataset with augment=False")
    k_slots = cfg.latent_cache
    if k_slots <= 0:
        raise ValueError("latent_cache must be > 0 for the cached path")
    encode = make_latent_encode_fn(vae, cfg.encode_dtype)

    def build(images_u8, generator=None, latent_stats=None):
        n = images_u8.shape[0]
        slots = []
        for _ in range(k_slots):
            zs = [encode(images_u8[i:i + chunk].float() / 255.0, generator, latent_stats)
                  for i in range(0, n, chunk)]
            slots.append(torch.cat(zs))
        return torch.stack(slots)

    return build


def make_fused_cached_epochs(model: ConditionalLatentDenoiser, cfg: LatentDiffusionConfig,
                             has_colors: bool = False, steps_per_epoch: int = 1):
    """fn(state, sched, z_pool (K, N, L), labels_all, colors_all, idx (T, B),
    generator) -> losses (T,) on the device; the state is updated in place.

    Per step each sample draws a pool slot uniformly and the denoiser trains
    on the cached posterior draw `pool[slot, idx]`; there is no VAE in the
    loop. cfg.train_kernel selects the hand-written train step
    (kernels/train_step.py), which supports the v1/v2 variants only."""
    k_slots = cfg.latent_cache
    if k_slots <= 0:
        raise ValueError("latent_cache must be > 0 for the cached path")
    if cfg.train_kernel:
        from flowerdiff_torch.kernels.train_step import (
            kernel_supported,
            make_kernel_denoise_body,
        )

        if not kernel_supported(model):
            raise ValueError(
                "cfg.train_kernel=True requires a shared_cond_proj single-condition "
                "variant (v1/v2); use the eager path for v3")
        if cfg.train_kernel_dtype not in _KERNEL_DTYPES:
            raise ValueError(f"train_kernel_dtype {cfg.train_kernel_dtype!r}: choose "
                             f"one of {sorted(_KERNEL_DTYPES)}")
        denoise = make_kernel_denoise_body(model, cfg,
                                           dtype=_KERNEL_DTYPES[cfg.train_kernel_dtype])
    else:
        denoise = make_latent_denoise_body(model, cfg)

    def epochs_fn(state, sched, z_pool, labels_all, colors_all, idx,
                  generator: Optional[torch.Generator] = None):
        if idx.shape[0] % steps_per_epoch:
            raise ValueError(f"T={idx.shape[0]} is not a multiple of steps={steps_per_epoch}")
        n = z_pool.shape[1]
        pool_flat = z_pool.reshape(-1, z_pool.shape[-1])  # (K * N, L)
        losses = []
        for idx_row in idx:
            slot = torch.randint(0, k_slots, idx_row.shape, generator=generator,
                                 device=idx_row.device)
            z = pool_flat[slot * n + idx_row]
            cols = colors_all[idx_row] if has_colors else None
            losses.append(denoise(state, sched, z, labels_all[idx_row], cols, generator))
        return torch.stack(losses)

    return epochs_fn
