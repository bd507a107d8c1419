"""flowerdiff_torch: the PyTorch + CUDA (Hopper) port of flowerdiff.

The JAX package `flowerdiff` is the reference; this package reproduces its
class-conditional latent sampling path (denoiser, ancestral, DDIM, partial
and trajectory samplers, VAE decode, bucketed serving), its latent-DDPM
training on augmented images (device-side flip, rotation and color jitter;
frozen VAE encoder, cached or per-step latents, clip + AdamW + SGDR + EMA
trainer), its VAE-GAN training, the pixel family (v4/v5: PixelUNet, its
DDPM trainer and service), checkpoints with exact resume, the presets, the
quality utilities, the Flowers102 loader and v3 color labels, the figures
(`viz`), and the pipeline with its command line (`runner`, `cli`; `python -m
flowerdiff_torch`) and the services built from a run directory, in
PyTorch, with the Pallas TPU kernels of those paths rewritten as
hand-written CUDA C++ kernels for sm_90a (`flowerdiff_torch.kernels`).

Importing this package imports `torch` only. Kernel libraries are compiled
and loaded on first launch, so the package imports on a CPU-only machine.
Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; without a card and without that argument they raise.
"""
from flowerdiff_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
