#!/usr/bin/env python3
"""How deep denoisers from the plain seeded tree amplify rounding, on the
CPU: why the card tests' deep nets are residual streams
(`utils/weights.residual_stream`).

    python3 src/flowerdiff_torch/tools/depth_probe.py [--sampler] [--train] [--epoch]

--sampler: the 20-step guided host loop (the reverse-process kernel's
oracle, on the plain twins; CFG 7.0, x0 clip 3.0, batch 8, step noise) of
deep nets from the plain seeded tree and as residual streams, run twice:
with the twins' products summed in f32 and in f64 (rounded to f32), as the
card's kernels sum theirs in another order than the host loop's. Prints
whether x_0 is finite, the difference in units of the card tests'
PROCESS_TOL (3e-2 of max|x|), and how far leaving out the noise, the last
stage's condition add, CFG or the clip moves the result, in the same units.

--train: the train step's bf16 twin over 40 stages of 128 at B = 64 (the
card's `DEEP_TRAIN`), from the plain seeded tree and as a residual stream,
against the same twin with each product's incoming gradient rounded to
bf16 before dX and dW, where the kernel's bf16 lane rounds it: the worst
leaf's difference over the leaf's largest gradient, against
`chip_smoke.py`'s TRAIN_BF16_REL (1.5e-2).

--epoch: the epoch twin (`train_epoch.mega_epoch_plain`) over the same
40-stage net, f32 lane, f32 moments, S = 15 steps of B = 64 with the draws
the epoch makes (`chip_smoke.py`'s deep epoch), from the plain seeded tree
and as a residual stream, against the same twin with every product summed
in f64 (rounded to f32), forward and backward: losses, weights and the
q/k leaves in units of `chip_smoke.py`'s f32 epoch limits. With none given,
all three run.
"""
from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from flowerdiff_torch.diffusion import linear_schedule  # noqa: E402
from flowerdiff_torch.kernels import latent_stage  # noqa: E402
from flowerdiff_torch.kernels import train_step as ts  # noqa: E402
from flowerdiff_torch.kernels.full_sampler import (  # noqa: E402
    draw_request,
    prepare_fused_sampler,
    run_steps,
)
from flowerdiff_torch.utils.weights import (  # noqa: E402
    denoiser_from_params,
    init_numpy_params,
    residual_stream,
)

SAMPLER_NETS = [("23 stages of 512", 512, (512,) * 24, False),
                ("63 stages of 256", 256, (256,) * 64, False),
                ("340 stages of 64", 64, (64,) * 341, False),
                ("12 stages of 64, v2", 64, (64,) * 13, True)]
DEEP_TRAIN = dict(latent_dim=128, hidden_dims=(128,) * 41, time_emb_dim=64, num_classes=102)


def _tree(stream: bool, **kw):
    tree = init_numpy_params("denoiser", seed=3, bias_std=0.3, **kw)
    return residual_stream(tree) if stream else tree


def _f64_sums(a, w, b):
    return (a.to(torch.bfloat16).double() @ w.double().t()).float() + b


def sampler_probe() -> None:
    for name, latent, hidden, skip in SAMPLER_NETS:
        kw = dict(latent_dim=latent, hidden_dims=hidden, time_emb_dim=64, num_classes=11,
                  shared_cond_proj=True, global_skip=skip)
        for stream in (False, True):
            model = denoiser_from_params(_tree(stream, **kw), device="cpu", **kw)
            prep = prepare_fused_sampler(model, linear_schedule(20))
            inputs = draw_request(prep, 8, torch.arange(8) % 11, None,
                                  torch.Generator().manual_seed(31), None, True)
            run = dict(stochastic=True, clip_x0=3.0, guidance_scale=7.0)
            ref = run_steps(prep, inputs, **run)
            mm = latent_stage._mm
            latent_stage._mm = _f64_sums
            try:
                other = run_steps(prep, inputs, **run)
            finally:
                latent_stage._mm = mm
            tol = 3e-2 * float(ref.abs().max())
            adds = list(inputs.stage_adds)
            adds[-1] = torch.zeros_like(adds[-1])
            moves = {"noise": run_steps(prep, inputs, **dict(run, stochastic=False)),
                     "last stage's add": run_steps(prep, inputs._replace(stage_adds=tuple(adds)),
                                                   **run),
                     "CFG": run_steps(prep, inputs, **dict(run, guidance_scale=1.0)),
                     "clip": run_steps(prep, inputs, **dict(run, clip_x0=None))}
            moved = {k: round(float((v - ref).abs().max()) / tol, 2) for k, v in moves.items()}
            print(f"[depth_probe] sampler {name}, {'residual stream' if stream else 'plain tree'}:"
                  f" x_0 finite {bool(torch.isfinite(ref).all())};"
                  f" f64 sums move x_0 by {float((other - ref).abs().max()) / tol:.3f} limits;"
                  f" left-out terms, in limits: {moved}", flush=True)


def _train_case(stream: bool, batch: int = 64):
    model = denoiser_from_params(_tree(stream, **DEEP_TRAIN), device="cpu", **DEEP_TRAIN)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "_ln_" in name or "final_norm" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    z = torch.randn((batch, 128), generator=gen)
    labels = torch.randint(0, 102, (batch,), generator=gen)
    t, eps, _, masks = ts.draw_step_inputs(model, 1000, 0.0, z, gen)
    keep = (torch.arange(batch) % 4 != 0).float()
    data = ts.step_data(linear_schedule(1000), z, labels, t, eps, keep,
                        ts.sinusoid_freqs(64, "cpu"))
    return dict(ts.weights_spec(model)), data, masks


class _RoundedGradMM(torch.autograd.Function):
    """bf16(a) bf16(k)^T, its backward rounding the incoming gradient to
    bf16 before dX and dW, as the kernel's bf16 lane does."""

    @staticmethod
    def forward(ctx, a, k):
        ab, kb = a.to(torch.bfloat16).float(), k.to(torch.bfloat16).float()
        ctx.save_for_backward(ab, kb)
        return ab @ kb.t()

    @staticmethod
    def backward(ctx, dy):
        ab, kb = ctx.saved_tensors
        d = dy.to(torch.bfloat16).float()
        return d @ kb, d.t() @ ab


def _twin_with(product: str):
    """`train_step.forward_loss_plain` with its product written as
    `product` (an expression of a, kernel, bias and cast)."""
    src = inspect.getsource(ts.forward_loss_plain)
    plain_mm = "return cast(a) @ cast(kernel).t() + bias"
    assert plain_mm in src
    scope = dict(vars(ts), _RoundedGradMM=_RoundedGradMM)
    exec(src.replace(plain_mm, f"return {product}"), scope)
    return scope["forward_loss_plain"]


def _with_twin(fwd, fn, *args, **kw):
    twin = ts.forward_loss_plain
    ts.forward_loss_plain = fwd
    try:
        return fn(*args, **kw)
    finally:
        ts.forward_loss_plain = twin


def train_probe() -> None:
    rounded = _twin_with("_RoundedGradMM.apply(a, kernel) + bias")
    for stream in (False, True):
        named, data, masks = _train_case(stream)
        _, ref = ts.twin_loss_and_grads(named, data, masks, dtype=torch.bfloat16)
        _, got = _with_twin(rounded, ts.twin_loss_and_grads, named, data, masks,
                            dtype=torch.bfloat16)
        rel, leaf = max((float((got[k] - r).abs().max() / (r.abs().max() + 1e-30)), k)
                        for k, r in ref.items())
        print(f"[depth_probe] train step, 40 stages of 128, "
              f"{'residual stream' if stream else 'plain tree'}: the gradient rounded before the "
              f"products moves leaf {leaf} by {rel:.4e} of its largest gradient (limit 1.5e-2)",
              flush=True)


EPOCH_LOSS_RTOL, EPOCH_W_RTOL, EPOCH_W_ATOL, EPOCH_QK_RTOL = 1e-4, 2e-3, 5e-4, 1e-6


def epoch_probe(steps: int = 15, batch: int = 64) -> None:
    from flowerdiff_torch.kernels import train_epoch as te
    from flowerdiff_torch.train.latent_ddpm import (
        LatentDiffusionConfig,
        create_latent_diffusion_state,
    )

    cfg = LatentDiffusionConfig(**{**DEEP_TRAIN, "n_steps": 1000, "steps_per_epoch": steps,
                                   "dropout_rate": 0.3, "cond_dropout": 0.25})
    f64 = _twin_with("(cast(a).double() @ cast(kernel).double().t()).float() + bias")
    for stream in (False, True):
        tree = init_numpy_params("denoiser", seed=3, bias_std=0.0, **DEEP_TRAIN)
        params = residual_stream(tree) if stream else tree
        gen = torch.Generator().manual_seed(23)
        z = torch.randn((steps, batch, cfg.latent_dim), generator=gen)
        labels = torch.randint(0, cfg.num_classes, (steps, batch), generator=gen)
        runs = []
        for fwd in (ts.forward_loss_plain, f64):
            state, model, sched = create_latent_diffusion_state(3, cfg, device="cpu",
                                                                params=params)
            draws = te.epoch_draws(model, cfg, sched, steps, batch, 7, 0)
            losses, _ = _with_twin(fwd, te.mega_epoch_plain, state, sched, z, labels, draws,
                                   dtype=torch.float32, moments_dtype=torch.float32)
            runs.append((losses, state))
        (l32, s32), (l64, s64) = runs
        qk = {j for j, n in enumerate(s32.names) if ".q." in n or ".k." in n}

        def over(idx, rtol, atol):
            return max(float(((s64.params[j] - s32.params[j]).abs()
                              / (atol + rtol * s32.params[j].abs())).max()) for j in idx)

        rest = [j for j in range(len(s32.names)) if j not in qk]
        loss = float(((l64 - l32).abs() / l32.abs()).max()) / EPOCH_LOSS_RTOL
        print(f"[depth_probe] epoch, 40 stages of 128, S={steps}, f32 lane, "
              f"{'residual stream' if stream else 'plain tree'}: f64 sums move, in units of "
              f"the f32 epoch limits: loss {loss:.3f}, w "
              f"{over(rest, EPOCH_W_RTOL, EPOCH_W_ATOL):.3f}, q/k "
              f"{over(sorted(qk), EPOCH_QK_RTOL, 0.0):.3f}; losses {float(l32[0]):.5f} .. "
              f"{float(l32[-1]):.5f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sampler", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--epoch", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(max(1, min(8, torch.get_num_threads())))
    every = not (args.sampler or args.train or args.epoch)
    if args.sampler or every:
        sampler_probe()
    if args.train or every:
        train_probe()
    if args.epoch or every:
        epoch_probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
