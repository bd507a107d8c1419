"""Convert the original repository's PyTorch checkpoints into a run
directory of the port (port of tools/import_torch_checkpoint.py).

A user of the original repository holds .pt files from hours of GPU training:
  flower_autoencoder.pt            {'autoencoder': sd, 'discriminator': sd}
                                   (v1/model_train_test.py:1188-1191) or a raw
                                   autoencoder state dict (v1:1326)
  conditional_diffusion_final.pt   a raw ConditionalUNet state dict (v1:1283)
  diffusion_unet_pixels.pth        a raw SimpleUNet state dict (v4:252/v5:275)

This tool maps them (utils/torch_import.py) into fresh training states of
the preset and saves them with the port's CheckpointManager at the epoch
stamps the JAX tool uses, so that the port's command line resumes from the
imported weights instead of retraining, and `serving.service_from_run`
(`pixel_service_from_run` for v4/v5) serves them. Optimizer moments start
fresh (the original repository never saves them); EMA weights, where the
preset keeps them, start as the imported weights.

    python -m flowerdiff_torch.tools.import_torch_checkpoint --preset v1 \\
        --out results_v1 --autoencoder flower_autoencoder.pt \\
        --diffusion conditional_diffusion_final.pt
    python -m flowerdiff_torch.cli --version v1 --results_dir results_v1 --raw_latents

The states are built on the CUDA card (the tool raises without one) unless
FLOWERDIFF_PLATFORM=cpu selects the CPU.

NOTE: the original denoisers are trained on RAW VAE latents; sample them
with `--raw_latents` (the presets default to z-scored latents and x0
thresholding, which assume a denoiser trained here). `service_from_run` has
no such option and serves an import z-scored and clipped as the preset says.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, Optional, Sequence

import torch

PRESETS = ("v1", "v2", "v3", "v4", "v5")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="v1", choices=PRESETS,
                    help="which reference variant the checkpoints came from")
    ap.add_argument("--out", required=True, help="results_dir to write into")
    ap.add_argument("--autoencoder", default=None, help="flower_autoencoder.pt")
    ap.add_argument("--diffusion", default=None, help="conditional_diffusion_*.pt")
    ap.add_argument("--pixel", default=None,
                    help="diffusion_unet_pixels.pth (v4/v5 SimpleUNet)")
    ap.add_argument("--vae_epoch", type=int, default=None,
                    help="epoch to stamp the VAE checkpoint with "
                         "(default: the preset's full schedule -> 'trained')")
    ap.add_argument("--diff_epoch", type=int, default=None,
                    help="epoch stamp for the diffusion checkpoint (default: "
                         "parsed from the filename, else the full schedule)")
    return ap


def report(name: str, res) -> None:
    print(f"  {name}: {len(res.used)} tensors imported, {len(res.approximated)} approximated, "
          f"{len(res.skipped)} skipped (dead/unmappable)")
    for k in res.approximated:
        print(f"    ~ approximated: {k} (BatchNorm affine -> GroupNorm)")
    for k in res.skipped:
        print(f"    - skipped: {k}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the tool; returns the ImportResult of each imported model, by
    name (autoencoder, discriminator, denoiser, pixel_unet)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.autoencoder and not args.diffusion and not args.pixel:
        ap.error("nothing to do: pass --autoencoder, --diffusion and/or --pixel")

    from flowerdiff_torch.cli import run_device
    from flowerdiff_torch.configs import get_preset
    from flowerdiff_torch.train.checkpoints import (
        CheckpointManager,
        parse_epoch_from_filename,
        state_to_tree,
        vae_gan_state_to_tree,
    )
    from flowerdiff_torch.utils.torch_import import (
        import_autoencoder,
        import_discriminator,
        import_latent_denoiser,
        import_pixel_unet,
        load_torch_file,
    )

    device = run_device()
    preset = get_preset(args.preset)
    os.makedirs(args.out, exist_ok=True)
    results: Dict[str, object] = {}

    if args.autoencoder:
        from flowerdiff_torch.train.vae_gan import create_vae_gan_state

        print(f"Importing autoencoder from {args.autoencoder}")
        obj = load_torch_file(args.autoencoder)
        if "autoencoder" in obj:  # combined dict (v1:1188-1191)
            ae_sd, d_sd = obj["autoencoder"], obj.get("discriminator")
        else:  # raw autoencoder state dict (v1:1326)
            ae_sd, d_sd = obj, None
        ae = results["autoencoder"] = import_autoencoder(ae_sd)
        report("autoencoder", ae)
        cfg = preset.vae
        if (ae.aux["latent_dim"], ae.aux["num_classes"]) != (cfg.latent_dim, cfg.num_classes):
            raise SystemExit(
                f"checkpoint geometry (latent={ae.aux['latent_dim']}, "
                f"classes={ae.aux['num_classes']}) does not match preset "
                f"{args.preset} ({cfg.latent_dim}/{cfg.num_classes})")
        state, vae, disc = create_vae_gan_state(0, cfg, img_size=preset.img_size, device=device)
        vae.load_state_dict(ae.params, strict=True)
        if d_sd is not None:
            d_res = results["discriminator"] = import_discriminator(d_sd)
            report("discriminator", d_res)
            disc.load_state_dict(d_res.params, strict=True)
        if ae.aux["class_centers"] is not None:
            state.centers.copy_(ae.aux["class_centers"])
        epoch = args.vae_epoch or preset.vae_epochs
        mgr = CheckpointManager(os.path.join(args.out, "ckpt_vae"))
        mgr.save(epoch, vae_gan_state_to_tree(state))
        print(f"  -> {mgr.directory} @ epoch {epoch}")

    if args.diffusion:
        from flowerdiff_torch.train.latent_ddpm import create_latent_diffusion_state

        print(f"Importing latent denoiser from {args.diffusion}")
        res = results["denoiser"] = import_latent_denoiser(load_torch_file(args.diffusion))
        report("denoiser", res)
        lcfg = preset.latent
        detected = (res.aux["hidden_dims"], res.aux["latent_dim"], res.aux["num_classes"],
                    res.aux["num_colors"], res.aux["shared_cond_proj"])
        expected = (tuple(lcfg.hidden_dims), lcfg.latent_dim, lcfg.num_classes,
                    lcfg.num_colors, lcfg.shared_cond_proj)
        if detected != expected:
            raise SystemExit(
                f"checkpoint geometry {detected} does not match preset "
                f"{args.preset} {expected} — pick the matching --preset")
        # the imported weights were trained on raw latents (sampling:
        # --raw_latents); the state's tree does not depend on it
        lcfg = dataclasses.replace(lcfg, normalize_latents=False, clip_denoised=None)
        state, model, _ = create_latent_diffusion_state(0, lcfg, device=device)
        model.load_state_dict(res.params, strict=True)
        if state.ema is not None:
            torch._foreach_copy_(state.ema, state.params)
        epoch = (args.diff_epoch or parse_epoch_from_filename(args.diffusion)
                 or preset.total_epochs)
        mgr = CheckpointManager(os.path.join(args.out, "ckpt_diffusion"))
        mgr.save(epoch, state_to_tree(state))
        print(f"  -> {mgr.directory} @ epoch {epoch}")

    if args.pixel:
        from flowerdiff_torch.train.pixel_ddpm import create_pixel_diffusion_state

        if preset.pixel is None:
            raise SystemExit(f"preset {args.preset} has no pixel pipeline — use v4/v5 for "
                             f"diffusion_unet_pixels.pth")
        print(f"Importing pixel UNet from {args.pixel}")
        res = results["pixel_unet"] = import_pixel_unet(load_torch_file(args.pixel))
        report("pixel_unet", res)
        pcfg = preset.pixel
        detected = (res.aux["base_channels"], res.aux["time_emb_dim"],
                    res.aux["learnable_residual"])
        expected = (pcfg.base_channels, pcfg.time_emb_dim, pcfg.learnable_residual)
        if detected != expected:
            raise SystemExit(
                f"checkpoint geometry {detected} does not match preset "
                f"{args.preset} {expected} — pick the matching --preset "
                f"(v5 has the learnable residual, v4 does not)")
        state, model, _ = create_pixel_diffusion_state(0, pcfg, device=device)
        model.load_state_dict(res.params, strict=True)
        epoch = (args.diff_epoch or parse_epoch_from_filename(args.pixel)
                 or preset.pixel_epochs)
        mgr = CheckpointManager(os.path.join(args.out, "ckpt_pixel"))
        mgr.save(epoch, state_to_tree(state))
        print(f"  -> {mgr.directory} @ epoch {epoch}")

    print("\nDone. Resume with:")
    flags = "" if args.preset in ("v4", "v5") else " --raw_latents"
    print(f"  python -m flowerdiff_torch.cli --version {args.preset} "
          f"--results_dir {args.out}{flags}")
    return results


if __name__ == "__main__":
    main()
