"""The train-step kernel's left-out-term gate, over many draws.

chip_smoke.py::phase_train_kernel holds the train-step kernel's gradients
against autograd on its twin within TRAIN_BF16_REL of each leaf's largest
gradient, and shows that the check would catch a kernel that left out any
one term: leaving it out of the twin moves some gradient by more than twice
that limit. The gate is the twin's alone, so it runs anywhere; this tool
runs it on `--draws` draws of the phase's inputs at the flagship's widths
and prints each draw's weakest terms and the least move of all.

A bias that a LayerNorm reads next (each stage's block_fc and attention
out biases, its downsample's, the head's time and condition projections')
moves the gradients least when left out: the LayerNorm takes its mean away
and divides by the spread of what it is added to. The phase's module draws
such biases PRE_LN_BIAS_SCALE times wider than the others, so that leaving
one out shows on any draw.

    PYTHONPATH=src python -m flowerdiff_torch.tools.train_gate --draws 24 [--device cuda]
"""
from __future__ import annotations

import argparse

import torch

from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.kernels import train_step as ts
from flowerdiff_torch.utils.weights import denoiser_from_params, init_numpy_params

FLAGSHIP = dict(latent_dim=256, hidden_dims=(256, 512, 1024, 512, 256), time_emb_dim=256,
                num_classes=102, shared_cond_proj=True, global_skip=False)
BATCH = 64
PRE_LN_BIAS_SCALE = 3.0
_PRE_LN = ("block_fc_", "downsample_", "attn_", "final_time_proj.", "final_cond_proj.")


def _pre_ln(name: str) -> bool:
    """Whether a 1-D parameter is a bias a LayerNorm reads next."""
    return name.startswith(_PRE_LN) and (not name.startswith("attn_")
                                         or name.endswith(".out.bias"))


def perturb_module(model, gen, pre_ln_scale: float = 1.0):
    """Biases and LN shifts z (a bias a LayerNorm reads next `pre_ln_scale`
    z), LN scales 1 + 0.2 z, in place, one draw of z a parameter in the
    module's order: values at which a dropped vector shows."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim != 1:
                continue
            z = torch.randn(p.shape, generator=gen, device=p.device)
            if name.endswith(".weight"):  # a 1-D weight is a LayerNorm scale
                p.copy_(1 + 0.2 * z)
            else:
                p.copy_(pre_ln_scale * z if _pre_ln(name) else z)


def step_case(model, gen):
    """One step's inputs at B = 64 for the model's widths, on its device:
    draws at dropout 0.3, and a condition keep-mask with every fourth row
    zero."""
    dev = next(model.parameters()).device
    sched = linear_schedule(1000).to(dev)
    z = torch.randn((BATCH, model.latent_dim), generator=gen, device=dev)
    labels = torch.randint(0, model.num_classes, (BATCH,), generator=gen, device=dev)
    t, eps, _, masks = ts.draw_step_inputs(model, 1000, 0.0, z, gen)
    keep = (torch.arange(BATCH, device=dev) % 4 != 0).float()
    data = ts.step_data(sched, z, labels, t, eps, keep,
                        ts.sinusoid_freqs(model.time_emb_dim, dev))
    return data, masks


def moved(grads, ref) -> float:
    """The largest change of any gradient leaf, relative to the leaf's max."""
    return max(float((grads[k] - ref[k]).abs().max() / (ref[k].abs().max() + 1e-30))
               for k in ref)


def left_out_moves(named, data, masks) -> dict:
    """Each term of the step left out of the f32 twin at a time (the
    condition keep-mask, each dropout mask, each 1-D weight: scales to 1,
    biases to 0; a stage's bt also halved, as a kernel adding it once
    instead of twice would) -> how far it moves the gradients (`moved`)."""
    _, ref = ts.twin_loss_and_grads(named, data, masks, dtype=torch.float32)

    def variant(weights=None, masks_=None, data_=None):
        w = dict(named, **(weights or {}))
        return ts.twin_loss_and_grads(w, data_ or data, masks_ or masks, dtype=torch.float32)[1]

    moves = {"cond_mask": moved(variant(data_=dict(
        data, cond_mask=torch.ones_like(data["cond_mask"]))), ref)}
    for i, m in enumerate(masks):
        ones = list(masks)
        ones[i] = torch.ones_like(m)
        moves[f"mask {i}"] = moved(variant(masks_=ones), ref)
    for k, v in named.items():
        if v.ndim != 1:
            continue
        if k.endswith(".bt"):  # a kernel using bt once: forward of bt / 2, half the gradient
            g = variant({k: 0.5 * v})
            g[k] = 0.5 * g[k]
            moves[f"2*{k}"] = moved(g, ref)
        moves[k] = moved(variant({k: (torch.ones_like if k.split(".")[-1].startswith("g")
                                       else torch.zeros_like)(v)}), ref)
    return moves


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=12)
    ap.add_argument("--first", type=int, default=0, help="the first draw's seed")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--pre-ln-scale", type=float, default=PRE_LN_BIAS_SCALE)
    args = ap.parse_args()
    least = None
    for seed in range(args.first, args.first + args.draws):
        gen = torch.Generator(device=args.device).manual_seed(seed)
        model = denoiser_from_params(init_numpy_params("denoiser", seed=3, **FLAGSHIP),
                                     device=args.device, **FLAGSHIP)
        perturb_module(model, gen, args.pre_ln_scale)
        named = dict(ts.weights_spec(model))
        moves = left_out_moves(named, *step_case(model, gen))
        weak = sorted(moves, key=moves.get)[:3]
        print(f"draw {seed}: {len(moves)} terms, the weakest "
              f"{[(k, round(moves[k], 4)) for k in weak]}", flush=True)
        least = min(least or moves[weak[0]], moves[weak[0]])
    print(f"least move over {args.draws} draws: {least:.4f}")


if __name__ == "__main__":
    main()
