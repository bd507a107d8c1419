"""Command line of the port (port of flowerdiff/cli.py): the same flags,
defaults and preset resolution.

    PYTHONPATH=src python -m flowerdiff_torch.cli --version v1 --total_epochs 2000
    PYTHONPATH=src python -m flowerdiff_torch.cli --version v1 \\
        --checkpoint_path .../epoch_450
    PYTHONPATH=src python -m flowerdiff_torch.cli --version v4 --total_epochs 300
    FLOWERDIFF_PLATFORM=cpu PYTHONPATH=src python -m flowerdiff_torch.cli \\
        --version v1 --dataset synthetic --tiny --total_epochs 2 --vae_epochs 2 \\
        --batch_size 16 --synthetic_size 64      # offline smoke run on the CPU

The run is on the CUDA card (and raises without one) unless
FLOWERDIFF_PLATFORM=cpu selects the CPU. --mesh_data / --mesh_model shape
the ('data', 'model') mesh (parallel/mesh.py) over torchrun's processes;
under torchrun the CLI joins the process group itself (NCCL on the card,
gloo on the CPU), every rank trains on its rows of each batch and rank 0
writes:

    FLOWERDIFF_PLATFORM=cpu PYTHONPATH=src torchrun --nproc_per_node 2 \
        -m flowerdiff_torch.cli --mesh_data 2 --version v1 --dataset synthetic --tiny

A mesh of more than one process without torchrun's environment raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional, Sequence

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="flowerdiff_torch",
        description="VAE-GAN + latent diffusion for Oxford 102 Flowers, PyTorch + CUDA")
    p.add_argument("--version", default="v1",
                   choices=["v1", "v2", "v3", "v4", "v5", "flagship"],
                   help="version preset (configs.py); 'flagship' = v1 widths with CFG "
                        "training, EMA, latent-cache training and guidance 7.0")
    p.add_argument("--total_epochs", type=int, default=None,
                   help="diffusion training horizon (preset default)")
    p.add_argument("--checkpoint_path", default=None,
                   help="resume checkpoint; '...epoch_N' resumes the diffusion stage "
                        "from step N")
    p.add_argument("--vae_epochs", type=int, default=None,
                   help="VAE-GAN training epochs (preset default)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--data_root", default="./data")
    p.add_argument("--dataset", default="auto",
                   choices=["auto", "flowers102", "synthetic"])
    p.add_argument("--results_dir", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic_size", type=int, default=512)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="data-parallel size (default: every process torchrun starts)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel size")
    p.add_argument("--vae_bf16", action="store_true",
                   help="bfloat16 compute for the VAE-GAN stage only (parameters and "
                        "optimizer f32)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for every model (configs.bf16_preset)")
    p.add_argument("--tiny", action="store_true",
                   help="shrink all models for smoke runs and tests")
    p.add_argument("--visualize_every", type=int, default=None,
                   help="diffusion visualization cadence (preset default 50)")
    p.add_argument("--vae_visualize_every", type=int, default=None,
                   help="VAE visualization cadence (preset default 300)")
    p.add_argument("--cond_dropout", type=float, default=None,
                   help="classifier-free-guidance training: per-sample null-condition "
                        "probability")
    p.add_argument("--guidance_scale", type=float, default=None,
                   help="classifier-free guidance at sampling (needs a model trained "
                        "with --cond_dropout > 0)")
    p.add_argument("--ema_decay", type=float, default=None,
                   help="per-step EMA of the denoiser weights; sampling uses the EMA copy")
    p.add_argument("--latent_cache", type=int, default=None,
                   help="latent-cache training: a pool of K frozen-VAE posterior draws "
                        "per image; epochs train the denoiser only")
    p.add_argument("--cache_refresh_epochs", type=int, default=None,
                   help="rebuild the latent cache every R epochs (0 = never)")
    p.add_argument("--train_kernel", action="store_true",
                   help="the hand-written forward+backward train-step kernel for the "
                        "latent denoiser (kernels/train_step.py; v1/v2)")
    p.add_argument("--sampler", default=None, choices=["ancestral", "ddim"],
                   help="sampling mode of the grids and sweeps: ancestral (1000 steps, "
                        "default) or ddim")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="DDIM step count (default 50; with --sampler ddim)")
    p.add_argument("--raw_latents", action="store_true",
                   help="train and sample the latent DDPM on raw (not z-scored) latents "
                        "with no x0 clip, the original repository's semantics")
    p.add_argument("--checkpoint_every", type=int, default=None,
                   help="checkpoint cadence in epochs (default: the visualization "
                        "cadence)")
    p.add_argument("--no-final-sweep", action="store_true",
                   help="skip the final sample grid, denoising paths, GIFs and quality "
                        "report")
    p.add_argument("--no-cadence-viz", action="store_true",
                   help="train without the per-cadence figures")
    p.add_argument("--no-fused-epochs", action="store_true",
                   help="train epoch by epoch instead of in fused chunks of epochs")
    return p


def resolve_preset(args: argparse.Namespace):
    """The VersionPreset that `args` select: the version's preset, then
    --tiny, --bf16 and --vae_bf16, the cadence flags, the sampler flags and
    the latent configuration flags (--latent_cache forces the bf16 encode),
    then --raw_latents. Flags the preset has no stage for print a warning
    and change nothing."""
    from flowerdiff_torch.configs import bf16_preset, get_preset, tiny_preset

    preset = get_preset(args.version)
    if args.tiny:
        preset = tiny_preset(preset)
    if args.bf16:
        preset = bf16_preset(preset)
    if args.vae_bf16 and preset.vae is not None:
        preset = dataclasses.replace(
            preset, vae=dataclasses.replace(preset.vae, compute_dtype="bfloat16"))
    if args.visualize_every is not None:
        preset = dataclasses.replace(
            preset, diffusion_visualize_every=args.visualize_every,
            pixel_visualize_every=(args.visualize_every if preset.pixel is not None
                                   else preset.pixel_visualize_every))
    if args.vae_visualize_every is not None:
        preset = dataclasses.replace(preset, vae_visualize_every=args.vae_visualize_every)

    sampler_flags_given = args.sampler is not None or args.ddim_steps is not None
    if sampler_flags_given and preset.latent is None:
        print(f"warning: --sampler/--ddim_steps ignored — preset {args.version} has no "
              f"latent-diffusion stage")
    if sampler_flags_given and preset.latent is not None:
        lat = preset.latent
        preset = dataclasses.replace(preset, latent=dataclasses.replace(
            lat,
            sampler=args.sampler if args.sampler is not None else lat.sampler,
            ddim_steps=args.ddim_steps if args.ddim_steps is not None else lat.ddim_steps))

    cfg_flags_given = (
        args.cond_dropout is not None or args.guidance_scale is not None
        or args.ema_decay is not None or args.latent_cache is not None
        or args.cache_refresh_epochs is not None or args.train_kernel)
    if cfg_flags_given and preset.latent is None:
        print(f"warning: --cond_dropout/--guidance_scale/--ema_decay/--latent_cache/"
              f"--train_kernel ignored — preset {args.version} has no latent-diffusion "
              f"stage (pixel-space DDPM)")
    if cfg_flags_given and preset.latent is not None:
        lat = preset.latent

        def pick(value, default):
            return value if value is not None else default

        preset = dataclasses.replace(preset, latent=dataclasses.replace(
            lat,
            cond_dropout=pick(args.cond_dropout, lat.cond_dropout),
            guidance_scale=pick(args.guidance_scale, lat.guidance_scale),
            ema_decay=pick(args.ema_decay, lat.ema_decay),
            latent_cache=pick(args.latent_cache, lat.latent_cache),
            cache_refresh_epochs=pick(args.cache_refresh_epochs, lat.cache_refresh_epochs),
            train_kernel=args.train_kernel or lat.train_kernel,
            encode_dtype="bfloat16" if args.latent_cache else lat.encode_dtype))

    if args.raw_latents:
        if preset.latent is None:
            print(f"warning: --raw_latents ignored — preset {args.version} has no "
                  f"latent-diffusion stage")
        else:
            preset = dataclasses.replace(preset, latent=dataclasses.replace(
                preset.latent, normalize_latents=False, clip_denoised=None))
    return preset


def run_device() -> str:
    """'cpu' when FLOWERDIFF_PLATFORM=cpu, else 'cuda'."""
    platform = os.environ.get("FLOWERDIFF_PLATFORM", "").lower()
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"FLOWERDIFF_PLATFORM={platform!r}: choose 'cpu' or 'cuda'")


def main(argv: Optional[Sequence[str]] = None):
    """Parse `argv`, run the pipeline, return the PipelineRunner."""
    args = build_parser().parse_args(argv)
    from flowerdiff_torch.parallel import create_mesh, init_distributed
    from flowerdiff_torch.runner import PipelineRunner

    device = run_device()
    init_distributed("gloo" if device == "cpu" else None)
    mesh = create_mesh(data=args.mesh_data, model=args.mesh_model)
    preset = resolve_preset(args)
    runner = PipelineRunner(
        preset, results_dir=args.results_dir, data_root=args.data_root, dataset=args.dataset,
        seed=args.seed, synthetic_size=args.synthetic_size,
        fused_epochs=not args.no_fused_epochs, device=device, mesh=mesh)
    if preset.pixel is not None:
        runner.run_pixel(epochs=args.total_epochs, batch_size=args.batch_size,
                         cadence_viz=not args.no_cadence_viz)
    else:
        runner.run_latent(
            total_epochs=(args.total_epochs if args.total_epochs is not None
                          else preset.total_epochs),
            vae_epochs=args.vae_epochs, checkpoint_path=args.checkpoint_path,
            batch_size=args.batch_size, final_sweep=not args.no_final_sweep,
            cadence_viz=not args.no_cadence_viz, checkpoint_every=args.checkpoint_every)
    return runner


if __name__ == "__main__":
    main()
