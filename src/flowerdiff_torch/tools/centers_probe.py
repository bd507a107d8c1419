#!/usr/bin/env python3
"""Where the VAE-GAN's class centers part, card against CPU.

    python3 src/flowerdiff_torch/tools/centers_probe.py [--seeds 4]

Runs the card test's case (`tests/test_torch_port_cuda.py::
test_vae_gan_step_on_the_card_matches_the_cpu`: channels (16, 32, 48, 64),
latent 32, head 64, 10 classes, B = 8, VGG on, the gates of epoch 200 of
1200, three f32 steps with TF32 off and the CPU's draws) on the card and on
the CPU from one init, on synthetic flower images and on uniform-noise
images with the same labels, for several noise seeds. For each step it
prints, card against CPU:
  - z: max |difference|, max |z| and their ratio; the same for mu and for
    the clamped logvar's std (exp(0.5 logvar)), which scales the noise;
  - every encoder module's output, leaf by leaf up the stack: max
    |difference| over max |CPU value|;
  - the encoder's weights after the step: the largest relative difference
    of any leaf, and the elements whose card and CPU values differ by more
    than lr: how many, and the largest CPU bias-corrected Adam first
    moment |mu / (1 - b1^step)| among them (at the first step, the
    gradient itself) against the largest of any encoder weight (Adam's
    first update is lr sign(g), so an element whose gradient is rounding
    noise can step either way);
  - the centers: max |difference|, max |centers|, their ratio, and the
    bound the z differences give for them, 0.1 sum_k 0.9^(S-1-k) max
    |dz_k| (the EMA of per-class batch means, momentum 0.9: a mean moves a
    center by a tenth of its own difference at most).
Ends with one JSON line of the readings per case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flowerdiff_torch.data import synthetic_flowers  # noqa: E402
from flowerdiff_torch.models import VGGPerceptual  # noqa: E402
from flowerdiff_torch.models.vae import LOGVAR_MAX, LOGVAR_MIN  # noqa: E402
from flowerdiff_torch.train import vae_gan as vg  # noqa: E402
from flowerdiff_torch.train.schedules import vae_gan_loss_gates  # noqa: E402

GAN = dict(channels=(16, 32, 48, 64), latent_dim=32, head_width=64, num_classes=10,
           total_steps=100)
STEPS, BATCH = 3, 8


def batches(kind: str, seed: int):
    """The card test's flower batches (`_gan_batches`), or uniform noise
    images from `seed` with the same labels."""
    imgs, labels = synthetic_flowers(STEPS * BATCH, 10, 64, seed=3)
    x = torch.from_numpy(imgs).float() / 255.0
    if kind == "noise":
        x = torch.rand(x.shape, generator=torch.Generator().manual_seed(seed))
    y = torch.from_numpy(labels).long()
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]) for i in range(STEPS)]


def run(device: str, cfg, data, draws, vgg):
    """Three steps; per step the encoder's module outputs, (mu, logvar, z)
    as the step saw them, the encoder's weights and the centers, on the CPU."""
    state, vae, disc = vg.create_vae_gan_state(5, cfg, device=device)
    body = vg.make_vae_gan_step_body(vae, disc, cfg, vgg)
    gates = vg.gates_array(vae_gan_loss_gates(200, 1200), device)
    seen = {}

    def hook(name):
        def fn(_module, _inputs, out):
            if isinstance(out, tuple):
                for j, o in enumerate(out):
                    seen[f"{name}[{j}]"] = o.detach().float().cpu()
            else:
                seen[name] = out.detach().float().cpu()
        return fn

    handles = [m.register_forward_hook(hook(n or "encoder"))
               for n, m in vae.encoder.named_modules()]
    steps = []
    try:
        for (x, y), (eps, masks) in zip(data, draws):
            seen.clear()
            body(state, x.to(device), y.to(device), gates,
                 draws=(eps.to(device), tuple(k.to(device) for k in masks)))
            mu, logvar = seen["encoder[0]"], seen["encoder[1]"]
            std = torch.exp(0.5 * torch.clamp(logvar, LOGVAR_MIN, LOGVAR_MAX))
            moments = dict(zip(state.gen.names, state.gen.mu))
            steps.append(dict(acts=dict(seen), mu=mu, std=std, z=mu + eps * std,
                              enc={n: p.detach().cpu().clone()
                                   for n, p in vae.encoder.named_parameters()},
                              enc_mu={n: moments[f"encoder.{n}"].detach().cpu().clone()
                                      for n, _ in vae.encoder.named_parameters()},
                              centers=state.centers.detach().cpu().clone()))
    finally:
        for h in handles:
            h.remove()
    return steps


def amax(t) -> float:
    return float(t.abs().max())


def compare(kind: str, seed: int, vgg, vgg_cpu) -> dict:
    cfg = vg.VAEGANConfig(**GAN)
    data = batches(kind, seed)
    _, cpu_vae, _ = vg.create_vae_gan_state(5, cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    draws = [vg.draw_step_inputs(cpu_vae, BATCH, g, "cpu") for _ in range(STEPS)]
    ref = run("cpu", cfg, data, draws, vgg_cpu)
    got = run("cuda", cfg, data, draws, vgg)
    out = dict(kind=kind, seed=seed, steps=[])
    dz = []
    for k, (a, b) in enumerate(zip(got, ref)):
        row = {}
        for key in ("z", "mu", "std"):
            d, m = amax(a[key] - b[key]), amax(b[key])
            row[key] = (d, m, d / m)
        dz.append(row["z"][0])
        acts = {n: amax(a["acts"][n] - b["acts"][n]) / max(amax(b["acts"][n]), 1e-30)
                for n in b["acts"]}
        w_rel = {n: amax(a["enc"][n] - b["enc"][n]) / max(amax(b["enc"][n]), 1e-30)
                 for n in b["enc"]}
        wn = max(w_rel, key=w_rel.get)
        n_flip, g_flip, g_max = 0, 0.0, 0.0
        dw = {n: amax(a["enc"][n] - b["enc"][n]) / cfg.lr for n in b["enc"]}
        dn = max(dw, key=dw.get)
        for n in b["enc"]:
            flip = (a["enc"][n] - b["enc"][n]).abs() > cfg.lr
            g = b["enc_mu"][n].abs() / (1.0 - 0.9 ** (k + 1))
            n_flip += int(flip.sum())
            g_max = max(g_max, amax(g))
            if flip.any():
                g_flip = max(g_flip, amax(g[flip]))
        dc, mc = amax(a["centers"] - b["centers"]), amax(b["centers"])
        bound = 0.1 * sum(0.9 ** (k - j) * dz[j] for j in range(k + 1))
        row.update(centers=(dc, mc, dc / max(mc, 1e-30)), centers_bound=bound,
                   worst_weight=(wn, w_rel[wn]), moved_apart=(n_flip, g_flip, g_max),
                   largest_dw_lr=(dn, dw[dn]))
        print(f"[centers] {kind} seed {seed} step {k}: "
              + ", ".join(f"{key} diff {row[key][0]:.3e} of max {row[key][1]:.3e} "
                          f"(rel {row[key][2]:.2e})" for key in ("z", "mu", "std"))
              + f"; centers diff {dc:.3e} of max {mc:.3e} (rel {dc / max(mc, 1e-30):.2e}), "
              f"bound from dz {bound:.3e}; encoder weights worst rel {w_rel[wn]:.2e} ({wn}); "
              f"{n_flip} weights apart by more than lr, their largest |corrected moment| "
              f"{g_flip:.2e} against the largest {g_max:.2e}; largest |dw| {dw[dn]:.3f} lr "
              f"({dn})")
        print(f"[centers]   activations, max|diff| / max|CPU| up the stack: "
              + ", ".join(f"{n} {v:.2e}" for n, v in acts.items()
                          if "." not in n or n.count(".") == 1))
        row["acts"] = acts
        out["steps"].append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("centers_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    vgg, vgg_cpu = VGGPerceptual(), VGGPerceptual(device="cpu")
    cases = [compare("flowers", 0, vgg, vgg_cpu)]
    cases += [compare("noise", s, vgg, vgg_cpu) for s in range(args.seeds)]
    print(card)
    print(json.dumps([{**c, "steps": [{k: v for k, v in r.items() if k != "acts"}
                                      for r in c["steps"]]} for c in cases]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
