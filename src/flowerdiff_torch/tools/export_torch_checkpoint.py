"""Export a run directory of the port as the original repository's PyTorch
files (port of tools/export_torch_checkpoint.py), the inverse of
import_torch_checkpoint.py:

  flower_autoencoder.pt             {'autoencoder': sd, 'discriminator': sd}
                                    (v1/model_train_test.py:1188-1191)
  conditional_diffusion_epoch_N.pt  a raw ConditionalUNet state dict (v1:1283)
  diffusion_unet_pixels.pth         a raw SimpleUNet state dict (v4:252/v5:275)

so that the original scripts load them with `load_state_dict(...,
strict=True)` and resume by their filename epoch (v1:1352-1363). The two
documented approximations are the discriminator's GroupNorm -> BatchNorm
affines (with fresh BN running statistics) and the original model's dead
ModuleList tails (zeros; never used in forward, v1:510-516 vs 541-556).

    python -m flowerdiff_torch.tools.export_torch_checkpoint --preset v1 \\
        --results_dir results_v1 --out exported/

The checkpoints are read on the host: the tool runs no device work.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from flowerdiff_torch.tools.import_torch_checkpoint import PRESETS


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="v1", choices=PRESETS)
    ap.add_argument("--results_dir", required=True,
                    help="run directory holding ckpt_vae/, ckpt_diffusion/ and/or ckpt_pixel/")
    ap.add_argument("--out", required=True, help="directory for the .pt files")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step/epoch to export (default: latest)")
    ap.add_argument("--ema", action="store_true",
                    help="export the denoiser's EMA weights instead of the raw training weights")
    return ap


def report(name: str, res) -> None:
    print(f"  {name}: {len(res.used)} tensors exported, "
          f"{len(res.approximated)} approximated/synthesized")
    for k in res.approximated:
        print(f"    ~ {k}")


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Run the tool; returns the files written, by model name."""
    args = build_parser().parse_args(argv)

    from flowerdiff_torch.configs import get_preset
    from flowerdiff_torch.train.checkpoints import CheckpointManager
    from flowerdiff_torch.utils.torch_import import (
        export_autoencoder,
        export_discriminator,
        export_latent_denoiser,
        export_pixel_unet,
    )

    preset = get_preset(args.preset)
    os.makedirs(args.out, exist_ok=True)
    written: Dict[str, str] = {}

    def restore(directory):
        mgr = CheckpointManager(directory)
        step = args.step or mgr.latest_step()
        return step, mgr.restore(step)

    vae_dir = os.path.join(args.results_dir, "ckpt_vae")
    if os.path.isdir(vae_dir):
        step, tree = restore(vae_dir)
        print(f"Exporting VAE-GAN from {vae_dir} @ step {step}")
        ae = export_autoencoder(tree["gen"]["params"], class_centers=tree["centers"])
        report("autoencoder", ae)
        d_res = export_discriminator(tree["disc"]["params"])
        report("discriminator", d_res)
        out = written["autoencoder"] = os.path.join(args.out, "flower_autoencoder.pt")
        torch.save({"autoencoder": ae.params, "discriminator": d_res.params}, out)
        print(f"  -> {out}")

    diff_dir = os.path.join(args.results_dir, "ckpt_diffusion")
    if os.path.isdir(diff_dir):
        step, tree = restore(diff_dir)
        which = "ema_params" if args.ema and "ema_params" in tree else "params"
        print(f"Exporting latent denoiser from {diff_dir} @ step {step} ({which})")
        res = export_latent_denoiser(tree[which])
        report("denoiser", res)
        out = written["denoiser"] = os.path.join(args.out, f"conditional_diffusion_epoch_{step}.pt")
        torch.save(res.params, out)
        print(f"  -> {out}")

    pixel_dir = os.path.join(args.results_dir, "ckpt_pixel")
    if os.path.isdir(pixel_dir):
        if preset.pixel is None:
            raise SystemExit(f"preset {args.preset} has no pixel pipeline but {pixel_dir} "
                             f"exists — use --preset v4 or v5")
        step, tree = restore(pixel_dir)
        print(f"Exporting pixel UNet from {pixel_dir} @ step {step}")
        res = export_pixel_unet(tree["params"])
        report("pixel_unet", res)
        out = written["pixel_unet"] = os.path.join(args.out, "diffusion_unet_pixels.pth")
        torch.save(res.params, out)
        print(f"  -> {out}")

    if not written:
        raise SystemExit(f"no ckpt_vae/, ckpt_diffusion/ or ckpt_pixel/ under {args.results_dir}")
    print("\nDone. Load in the original repository with torch.load(..., map_location=...) "
          "as usual.")
    return written


if __name__ == "__main__":
    main()
