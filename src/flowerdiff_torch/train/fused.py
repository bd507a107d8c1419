"""Multi-epoch training windows over a device-resident dataset (port of the
latent-DDPM part of flowerdiff/train/fused.py).

The reference compiles a window of epochs into one `lax.scan` program. Here
a window is a plain Python loop over the steps, each step enqueueing its
kernels without a host synchronisation; the losses come back as one device
tensor. (A CUDA graph of the step is later performance work.)

Ported: `epoch_rows`, `_make_gather`, `make_latent_cache_builder`,
`make_fused_cached_epochs`, `make_fused_latent_epochs` (both forms:
the frozen encode per step, or once per epoch),
`make_fused_vae_gan_epochs` (plain, and with the best-state policy) and
`make_fused_pixel_epochs`. Each
augmenting latent path takes its draws from one generator in a fixed order,
a row at a time: the augmentation's, the posterior noise, then the step's.
The VAE-GAN and pixel windows derive a generator per row from (seed, row,
step), the reference's fold_in(rng, offset) and fold_in(.., step), and draw
the augmentation, then the step's draws, from it.

Every window takes `mesh=` (parallel/mesh.py), as the reference's do. Under
a data-parallel mesh each rank draws the GLOBAL batch's augmentation,
posterior noise and step draws exactly as one process does, keeps its rows
of them and of the batch, and steps on those rows; the step bodies average
the gradients and the losses over the ranks (train/latent_ddpm.py,
vae_gan.py, pixel_ddpm.py), so every rank holds the same state and returns
the global batch's losses. The train-step kernel does not shard: it raises
under a mesh of more than one rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flowerdiff_torch.data.pipeline import make_augment_fn, unit_float
from flowerdiff_torch.kernels.train_step import draw_step_inputs
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser
from flowerdiff_torch.models.vae import FlowerVAE
from flowerdiff_torch.models.pixel_unet import PixelUNet
from flowerdiff_torch.parallel.mesh import data_size, local_rows, mesh_size
from flowerdiff_torch.train.latent_ddpm import (
    LatentDiffusionConfig,
    make_latent_denoise_body,
    make_latent_encode_fn,
)
from flowerdiff_torch.train.pixel_ddpm import make_pixel_diffusion_step_body
from flowerdiff_torch.train.vae_gan import METRICS, make_vae_gan_step_body
from flowerdiff_torch.utils.device import derived_generator

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


def _make_gather(augment: bool, max_rotation_deg: float, jitter: float, mesh=None):
    """gather(images_u8, idx_row, generator=None, draws=None) -> the rows'
    float [0, 1] images, augmented when `augment` (the reference's
    `_make_gather`: the same program as `DeviceDataset.assemble`). idx_row
    and the augmentation draws (given, or drawn from `generator`) are the
    global batch's; under `mesh` the rank keeps its rows of both."""
    augment_fn = make_augment_fn(max_rotation_deg, jitter) if augment else None

    def gather(images_u8, idx_row, generator=None, draws=None):
        if augment_fn is not None and draws is None:
            draws = augment_fn.draw(idx_row.shape[0], generator, images_u8.device)
        imgs = unit_float(images_u8[local_rows(mesh, idx_row)])
        if augment_fn is not None:
            imgs = augment_fn(imgs, None, local_rows(mesh, draws))
        return imgs

    gather.augment_fn = augment_fn
    return gather


def _kernel_denoise_body(model: ConditionalLatentDenoiser, cfg: LatentDiffusionConfig):
    """cfg.train_kernel's body (kernels/train_step.py) in
    cfg.train_kernel_dtype, v1/v2 only."""
    from flowerdiff_torch.kernels.train_step import kernel_supported, make_kernel_denoise_body

    if not kernel_supported(model):
        raise ValueError(
            "cfg.train_kernel=True requires a shared_cond_proj single-condition "
            "variant (v1/v2); use the eager path for v3")
    if cfg.train_kernel_dtype not in _KERNEL_DTYPES:
        raise ValueError(f"train_kernel_dtype {cfg.train_kernel_dtype!r}: choose "
                         f"one of {sorted(_KERNEL_DTYPES)}")
    return make_kernel_denoise_body(model, cfg, dtype=_KERNEL_DTYPES[cfg.train_kernel_dtype])


def make_fused_latent_epochs(model: ConditionalLatentDenoiser, vae: FlowerVAE, sched,
                             cfg: LatentDiffusionConfig, has_colors: bool = False,
                             augment: bool = True, max_rotation_deg: float = 10.0,
                             jitter: float = 0.2, steps_per_epoch: int = 1,
                             epoch_encode: Optional[bool] = None, mesh=None):
    """fn(state, images_u8, labels_all, colors_all, idx (T, B), generator=None,
    latent_stats=None) -> losses (T,) on the device; the state is updated in
    place. T must be whole epochs of steps_per_epoch rows.

    Per step (epoch_encode False, the default from cfg.epoch_encode): gather
    and augment the row's images, draw their posterior through the frozen
    encoder (the VAE's own f32 convolutions, as the reference's step body),
    then the eager denoise step. epoch_encode=True: the epoch's S rows are
    drawn first, a row at a time in the per-step order (augmentation,
    posterior noise, step draws), so each row sees the same numbers; then
    the S * B augmented images go through ONE encoder call
    (cfg.encode_dtype='bfloat16' runs its convolutions under bf16 autocast;
    the noise and latents stay f32), then S denoise steps. cfg.train_kernel
    selects the train-step kernel for those steps and requires
    epoch_encode. Under `mesh` each rank encodes and steps on its rows;
    the losses are the global batch's."""
    if epoch_encode is None:
        epoch_encode = cfg.epoch_encode
    if cfg.train_kernel:
        if not epoch_encode:
            raise ValueError("cfg.train_kernel=True requires epoch_encode")
        if mesh_size(mesh) > 1:
            raise ValueError(
                "cfg.train_kernel is the single-chip fast path; multi-GPU training uses the "
                "eager step body (the train-step kernel does not shard under a mesh)")
    gather = _make_gather(augment, max_rotation_deg, jitter, mesh)
    ranks, lat = data_size(mesh), model.latent_dim

    def check(idx):
        if idx.shape[0] % steps_per_epoch:
            raise ValueError(f"T={idx.shape[0]} is not a multiple of steps={steps_per_epoch}")

    if not epoch_encode:
        encode = make_latent_encode_fn(vae)
        denoise = make_latent_denoise_body(model, cfg, mesh)

        def epochs_fn(state, images_u8, labels_all, colors_all, idx,
                      generator: Optional[torch.Generator] = None, latent_stats=None):
            check(idx)
            b, dev = idx.shape[1], idx.device
            losses = []
            for idx_row in idx:
                imgs = gather(images_u8, idx_row, generator)
                noise = local_rows(mesh, torch.randn((b, lat), generator=generator, device=dev))
                z = encode(imgs, None, latent_stats, noise=noise)
                mine = local_rows(mesh, idx_row)
                cols = colors_all[mine] if has_colors else None
                losses.append(denoise(state, sched, z, labels_all[mine], cols, generator))
            return torch.stack(losses)

        return epochs_fn

    encode = make_latent_encode_fn(vae, cfg.encode_dtype)
    denoise = (_kernel_denoise_body(model, cfg) if cfg.train_kernel
               else make_latent_denoise_body(model, cfg, mesh))

    def epochs_fn(state, images_u8, labels_all, colors_all, idx,
                  generator: Optional[torch.Generator] = None, latent_stats=None):
        check(idx)
        b, dev = idx.shape[1], idx.device
        bl = b // ranks
        z_like = torch.empty((b, lat), device=dev)
        losses = []
        for e in range(0, idx.shape[0], steps_per_epoch):
            rows = idx[e:e + steps_per_epoch]
            aug, noise, step_draws = [], [], []
            for _ in range(steps_per_epoch):
                if gather.augment_fn is not None:
                    aug.append(gather.augment_fn.draw(b, generator, dev))
                noise.append(torch.randn((b, lat), generator=generator, device=dev))
                step_draws.append(draw_step_inputs(model, sched.n_steps, cfg.cond_dropout,
                                                   z_like, generator))
            imgs = torch.cat([gather(images_u8, r, draws=aug[s] if aug else None)
                              for s, r in enumerate(rows)])
            z = encode(imgs, None, latent_stats,
                       noise=torch.cat([local_rows(mesh, n) for n in noise]))
            for s, r in enumerate(rows):
                mine = local_rows(mesh, r)
                cols = colors_all[mine] if has_colors else None
                losses.append(denoise(state, sched, z[s * bl:(s + 1) * bl], labels_all[mine],
                                      cols, draws=local_rows(mesh, step_draws[s])))
        return torch.stack(losses)

    return epochs_fn


def make_latent_cache_builder(vae: FlowerVAE, cfg: LatentDiffusionConfig,
                              augment: bool = True, max_rotation_deg: float = 10.0,
                              jitter: float = 0.2, chunk: int = 255):
    """build(images_u8, generator, latent_stats=None) -> the (K, N, latent)
    f32 pool of frozen-VAE posterior draws, slot k holding one fresh
    augmentation draw and one reparameterisation draw of the whole dataset,
    encoded in `chunk`-sized pieces (per chunk: the augmentation's draws,
    then the noise). cfg.encode_dtype='bfloat16' runs the encoder under
    autocast; the images, the noise and the pool stay f32."""
    k_slots = cfg.latent_cache
    if k_slots <= 0:
        raise ValueError("latent_cache must be > 0 for the cached path")
    encode = make_latent_encode_fn(vae, cfg.encode_dtype)
    gather = _make_gather(augment, max_rotation_deg, jitter)

    def build(images_u8, generator=None, latent_stats=None):
        n = images_u8.shape[0]
        rows = torch.arange(n, device=images_u8.device)
        slots = []
        for _ in range(k_slots):
            zs = [encode(gather(images_u8, rows[i:i + chunk], generator), generator, latent_stats)
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
    denoise = (_kernel_denoise_body(model, cfg) if cfg.train_kernel
               else make_latent_denoise_body(model, cfg))

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


def make_fused_vae_gan_epochs(vae, disc, cfg, vgg=None, augment: bool = True,
                              max_rotation_deg: float = 10.0, jitter: float = 0.2,
                              steps_per_epoch: int = 1, track_best: bool = False, mesh=None):
    """fn(state, images_u8, labels_all, idx (T, B), gates (T, 5), seed=0,
    draws=None) -> metrics, a dict of (T,) device tensors; the state is
    updated in place. T must be whole epochs of steps_per_epoch rows.

    Row r gathers and augments its images (`_make_gather`) and takes one
    VAE-GAN step with gate row r, drawing from the generator of (seed..., r,
    state step) (`seed`: an int or a tuple of ints): the augmentation, then
    the step's noise and dropout masks. draws: per row, (augmentation
    draws or None, step draws) in place of the generator's.

    track_best=True: fn(..., best_loss (0-d tensor), best_state (a
    VAEGANSnapshot)) -> (metrics, best_loss, best epoch in the window (-1
    if none), best_state). At the end of each epoch whose mean total is
    below the carried best, the snapshot takes the state's tensors and step
    by a device-side select: no host fetch an epoch.

    Under `mesh` the draws (drawn or given) are the global batch's, each
    rank steps on its rows, and the metrics, so the best epoch too, are the
    global batch's on every rank."""
    step_body = make_vae_gan_step_body(vae, disc, cfg, vgg, mesh)
    gather = _make_gather(augment, max_rotation_deg, jitter, mesh)

    def epochs_fn(state, images_u8, labels_all, idx, gates, seed=0, draws=None,
                  best_loss=None, best_state=None):
        if idx.shape[0] % steps_per_epoch:
            raise ValueError(f"T={idx.shape[0]} is not a multiple of steps={steps_per_epoch}")
        if track_best and (best_loss is None or best_state is None):
            raise ValueError("track_best needs best_loss and best_state")
        words = seed if isinstance(seed, tuple) else (seed,)
        dev = idx.device
        rows = []
        best_epoch = torch.tensor(-1, device=dev)
        for r, idx_row in enumerate(idx):
            gen = derived_generator(dev, *words, r, state.step) if draws is None else None
            aug, step_draws = (None, None) if draws is None else draws[r]
            imgs = gather(images_u8, idx_row, gen, aug)
            rows.append(step_body(state, imgs, labels_all[local_rows(mesh, idx_row)], gates[r],
                                  gen, step_draws))
            if track_best and (r + 1) % steps_per_epoch == 0:
                epoch_mean = torch.stack([m["total"] for m in rows[-steps_per_epoch:]]).mean()
                better = epoch_mean < best_loss
                best_loss = torch.where(better, epoch_mean, best_loss)
                best_epoch = torch.where(better, r // steps_per_epoch, best_epoch)
                live = state.tensors()
                torch._foreach_copy_(best_state.tensors, [torch.where(better, n, b) for n, b in
                                                          zip(live, best_state.tensors)])
                best_state.step.copy_(torch.where(better, state.step, best_state.step))
        metrics = {k: torch.stack([m[k] for m in rows]) for k in METRICS}
        if track_best:
            return metrics, best_loss, best_epoch, best_state
        return metrics

    return epochs_fn


def make_fused_pixel_epochs(model: PixelUNet, augment: bool = True,
                            max_rotation_deg: float = 10.0, jitter: float = 0.2,
                            steps_per_epoch: int = 1, mesh=None):
    """fn(state, sched, images_u8, idx (T, B), seed=0, draws=None) -> losses
    (T,) on the device; the state is updated in place. T must be whole
    epochs of steps_per_epoch rows.

    Row r gathers and augments its images (`_make_gather`) and takes one
    pixel-DDPM step (train/pixel_ddpm.py), drawing from the generator of
    (seed..., r, state step) (`seed`: an int or a tuple of ints): the
    augmentation, then t and eps. draws: per row, (augmentation draws or
    None, (t, eps)) in place of the generator's. Under `mesh` the draws are
    the global batch's, each rank steps on its rows, and the losses are the
    global batch's."""
    step_body = make_pixel_diffusion_step_body(model, mesh)
    gather = _make_gather(augment, max_rotation_deg, jitter, mesh)

    def epochs_fn(state, sched, images_u8, idx, seed=0, draws=None):
        if idx.shape[0] % steps_per_epoch:
            raise ValueError(f"T={idx.shape[0]} is not a multiple of steps={steps_per_epoch}")
        words = seed if isinstance(seed, tuple) else (seed,)
        losses = []
        for r, idx_row in enumerate(idx):
            gen = derived_generator(idx.device, *words, r, state.step) if draws is None else None
            aug, step_draws = (None, None) if draws is None else draws[r]
            imgs = gather(images_u8, idx_row, gen, aug)
            losses.append(step_body(state, sched, imgs, gen, step_draws))
        return torch.stack(losses)

    return epochs_fn
