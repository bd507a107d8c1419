"""Kernel inference path for the conditional latent denoiser (port of
flowerdiff/kernels/denoiser_apply.py).

`make_fast_denoiser(model)` returns an eps_fn equal to `model(...)` to bf16
precision, with every stage run by `fused_stage` and the head by
`fused_head`. Only the v-slice of attention is needed (one key), so q and k
are never read. Embeddings, the per-stage condition projections, the
latent projection and the v2 skip stay PyTorch ops, as the reference's
`make_fast_denoiser` leaves them to XLA (its `:118` and `:142`). The full
sampler's Pallas kernel computes the projection in its own body
(flowerdiff/kernels/full_sampler.py:118); the port's sampler step runs it,
and the skip, in the `latent_proj` kernel (full_sampler.py).
"""
from __future__ import annotations

from typing import Dict

import torch

from flowerdiff_torch.kernels.latent_stage import bind_head, bind_stage
from flowerdiff_torch.models.latent_unet import ConditionalLatentDenoiser


def _w(linear: torch.nn.Linear) -> torch.Tensor:
    """A Linear's weight as the kernels' bf16 operand, (out, in)."""
    return linear.weight.detach().to(torch.bfloat16).contiguous()


def _b(module: torch.nn.Module) -> torch.Tensor:
    return module.bias.detach().float().contiguous()


def stage_weights(model: ConditionalLatentDenoiser, i: int) -> Dict[str, torch.Tensor]:
    """Stage i's kernel operands: bf16 (out, in) weights, f32 vectors."""
    block_ln, stage_ln = model.stage("block_ln", i), model.stage("stage_ln", i)
    attn = model.stage("attn", i)
    down = model.stage("downsample", i)
    return {
        "wb": _w(model.stage("block_fc", i)), "bb": _b(model.stage("block_fc", i)),
        "g1": block_ln.weight.detach().contiguous(), "b1": _b(block_ln),
        "g2": stage_ln.weight.detach().contiguous(), "b2": _b(stage_ln),
        "wv": _w(attn.v), "bv": _b(attn.v), "wo": _w(attn.out), "bo": _b(attn.out),
        "wd": _w(down), "bd": _b(down),
    }


def head_weights(model: ConditionalLatentDenoiser) -> Dict[str, torch.Tensor]:
    return {
        "wt": _w(model.final_time_proj), "bt": _b(model.final_time_proj),
        "wc": _w(model.final_cond_proj), "bc": _b(model.final_cond_proj),
        "g": model.final_norm.weight.detach().contiguous(), "b": _b(model.final_norm),
        "wf": _w(model.final), "bf": _b(model.final),
    }


def make_fast_denoiser(model: ConditionalLatentDenoiser):
    """eps_fn(x, t, cond[, color]) over `model`'s weights (converted once),
    with the stages and the head run by the kernels."""
    model = model.eval()
    stages = [bind_stage(**stage_weights(model, i)) for i in range(model.n_stages)]
    head = bind_head(**head_weights(model))

    @torch.no_grad()
    def eps_fn(x, t, cond, color=None):
        t_base = model.time_emb(t)
        c_base = model.embed_condition(cond, color)
        h = model.latent_proj(x)
        for i, stage in enumerate(stages):
            tc = model.stage("time_proj", i)(t_base) + model.cond_proj(i)(c_base)
            h = stage(h, tc)
        out = head(h, t_base, c_base)
        if model.global_skip:
            out = out + torch.sigmoid(model.residual_weight) * model.final(x)
        return out

    return eps_fn
