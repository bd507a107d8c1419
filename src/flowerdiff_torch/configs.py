"""Version presets v1..v5 and the flagship (port of flowerdiff/configs.py),
over the port's configuration classes, field for field the reference's.

  v1: VAE-GAN + class-conditional latent DDPM
  v2: v1 + learned global UNet skip
  v3: v1 + separate condition projections + color conditioning
  v4: pixel-space DDPM baseline
  v5: v4 + learnable output residual + train-time visualisation
  flagship: v1's widths with classifier-free guidance training, per-step
    weight EMA, latent-cache training, the 30k-epoch horizon and guidance
    7.0 (the reference's measured operating point)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from flowerdiff_torch.train.latent_ddpm import LatentDiffusionConfig
from flowerdiff_torch.train.pixel_ddpm import PixelDiffusionConfig
from flowerdiff_torch.train.vae_gan import VAEGANConfig


@dataclasses.dataclass(frozen=True)
class VersionPreset:
    name: str
    img_size: int = 64
    batch_size: int = 64
    # latent pipeline (None for v4/v5)
    vae: Optional[VAEGANConfig] = None
    latent: Optional[LatentDiffusionConfig] = None
    vae_epochs: int = 1200  # v3: 2000
    total_epochs: int = 10_000
    vae_visualize_every: int = 300
    diffusion_visualize_every: int = 50
    # pixel pipeline (None for v1..v3)
    pixel: Optional[PixelDiffusionConfig] = None
    pixel_epochs: int = 300
    pixel_visualize_every: Optional[int] = None  # v5: every 10


def _latent_cfg(**kw) -> LatentDiffusionConfig:
    # every latent preset trains in z-scored latent space and samples with
    # x0-thresholding at 3 posterior sigmas
    kw.setdefault("normalize_latents", True)
    kw.setdefault("clip_denoised", 3.0)
    return LatentDiffusionConfig(**kw)


def _vae_cfg() -> VAEGANConfig:
    return VAEGANConfig(lambda_cls=0.3, lambda_center=0.1, lambda_vgg=0.4)


V1 = VersionPreset(name="v1", vae=_vae_cfg(),
                   latent=_latent_cfg(shared_cond_proj=True, global_skip=False))

V2 = VersionPreset(name="v2", vae=_vae_cfg(),
                   latent=_latent_cfg(shared_cond_proj=True, global_skip=True))

V3 = VersionPreset(name="v3", vae=_vae_cfg(),
                   latent=_latent_cfg(shared_cond_proj=False, global_skip=False,
                                      num_colors=10),
                   vae_epochs=2000)

V4 = VersionPreset(name="v4", pixel=PixelDiffusionConfig(learnable_residual=False))

V5 = VersionPreset(name="v5", pixel=PixelDiffusionConfig(learnable_residual=True),
                   pixel_visualize_every=10)

FLAGSHIP = VersionPreset(
    name="flagship", vae=_vae_cfg(),
    latent=_latent_cfg(shared_cond_proj=True, global_skip=False, cond_dropout=0.1,
                       ema_decay=0.999, guidance_scale=7.0, latent_cache=8,
                       cache_refresh_epochs=50, encode_dtype="bfloat16"),
    total_epochs=30_000,
)

PRESETS = {p.name: p for p in (V1, V2, V3, V4, V5, FLAGSHIP)}


def get_preset(name: str) -> VersionPreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown version {name!r}; choose from {sorted(PRESETS)}") from None


def bf16_preset(preset: VersionPreset) -> VersionPreset:
    """Mixed precision: every model's stacks compute in bfloat16, its
    parameters and optimizer state stay f32."""
    rep = {}
    for field in ("vae", "latent", "pixel"):
        cfg = getattr(preset, field)
        if cfg is not None:
            rep[field] = dataclasses.replace(cfg, compute_dtype="bfloat16")
    return dataclasses.replace(preset, **rep)


def tiny_preset(preset: VersionPreset) -> VersionPreset:
    """Every model of a preset shrunk for smoke runs and tests (the
    capabilities kept, the widths reduced)."""
    vae = latent = pixel = None
    if preset.vae is not None:
        vae = dataclasses.replace(preset.vae, latent_dim=32, channels=(8, 16, 24, 32),
                                  head_width=32, use_perceptual=False)
    if preset.latent is not None:
        latent = dataclasses.replace(preset.latent, latent_dim=32, hidden_dims=(32, 64, 32),
                                     time_emb_dim=32, n_steps=50)
    if preset.pixel is not None:
        pixel = dataclasses.replace(preset.pixel, base_channels=8, time_emb_dim=16,
                                    n_steps=50)
    return dataclasses.replace(
        preset, vae=vae, latent=latent, pixel=pixel, batch_size=8,
        vae_epochs=1, total_epochs=1, pixel_epochs=1,
        vae_visualize_every=1, diffusion_visualize_every=1,
    )
