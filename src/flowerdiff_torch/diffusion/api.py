"""Sampling facade (port of flowerdiff/diffusion/api.py).

`DiffusionSampler` holds (model, schedule) and samples with the plain f32
model; `FusedDiffusionSampler` swaps its `sample` for the kernel path
(kernels/full_sampler.py); `NormalizedSampler` denormalises z-scored latents.

Classifier-free guidance doubles the batch: conditional rows, then the same
rows with cond_mask 0, and eps = eps_u + s * (eps_c - eps_u).

Randomness comes from an explicit `torch.Generator`; `x_init` and
`stochastic=False` let a caller inject the starting state and drop the step
noise, which is how the port is held against the reference. DDIM, the
trajectory and masked samplers are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from flowerdiff_torch.diffusion.sampler import sample as _sample_impl
from flowerdiff_torch.kernels.full_sampler import (
    SamplerGraph,
    draw_request,
    prepare_fused_sampler,
    run_steps,
)
from flowerdiff_torch.diffusion.schedule import DiffusionSchedule
from flowerdiff_torch.utils.device import resolve_device


def guided_eps_fn(model, guidance_scale: Optional[float]):
    """eps_fn(x, t, *cond) over `model`, with CFG by batch doubling when
    guidance_scale is set."""
    if guidance_scale is None:
        return lambda x, t, *cond: model(x, t, *cond)
    s = float(guidance_scale)

    def eps(x, t, *cond):
        b = x.shape[0]
        cond2 = tuple(torch.cat([c, c]) for c in cond)
        mask = torch.cat([torch.ones(b, device=x.device),
                          torch.zeros(b, device=x.device)])
        e = model(torch.cat([x, x]), torch.cat([t, t]), *cond2, cond_mask=mask)
        e_c, e_u = e[:b], e[b:]
        return e_u + s * (e_c - e_u)

    return eps


class DiffusionSampler:
    """Ancestral sampling for one (model, schedule) pair with the plain model.

    Conditioning is variadic: (classes,) for v1/v2, (classes, colors) for v3.
    """

    def __init__(self, model, sched: DiffusionSchedule, event_shape: Tuple[int, ...],
                 clip_x0: Optional[float] = None,
                 guidance_scale: Optional[float] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.sched = sched.to(self.device)
        self.event_shape = tuple(event_shape)
        self.clip_x0 = clip_x0
        self.guidance_scale = guidance_scale

    @torch.no_grad()
    def sample(self, batch: int, *cond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               stochastic: bool = True) -> torch.Tensor:
        cond = tuple(c.to(self.device) for c in cond)
        return _sample_impl(
            self.sched, guided_eps_fn(self.model, self.guidance_scale),
            (batch,) + self.event_shape, *cond, generator=generator,
            device=self.device, clip_x0=self.clip_x0, x_init=x_init,
            stochastic=stochastic)


class FusedDiffusionSampler(DiffusionSampler):
    """DiffusionSampler whose `sample` runs the kernel path: per step the
    projection, stage, head and reverse-step kernels
    (kernels/full_sampler.py). Latent pipeline only.

    On a CUDA device every call is one replay of a captured CUDA graph of
    the T steps (`SamplerGraph`), captured at the first call of each
    (batch, guided, clip_x0, stochastic, has_color) and kept in `graphs`;
    a failed capture raises. On the CPU the same loop runs the kernels'
    plain twins."""

    def __init__(self, model, sched: DiffusionSchedule, event_shape: Tuple[int, ...],
                 clip_x0: Optional[float] = None,
                 guidance_scale: Optional[float] = None, device=None):
        super().__init__(model, sched, event_shape, clip_x0=clip_x0,
                         guidance_scale=guidance_scale, device=device)
        self._prep = prepare_fused_sampler(self.model, self.sched)
        self.graphs: Dict[tuple, SamplerGraph] = {}

    @torch.no_grad()
    def sample(self, batch: int, *cond: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               x_init: Optional[torch.Tensor] = None,
               stochastic: bool = True) -> torch.Tensor:
        color = cond[1] if len(cond) > 1 else None
        guided = self.guidance_scale is not None
        inputs = draw_request(self._prep, batch, cond[0], color, generator, x_init, guided)
        kw = dict(stochastic=stochastic, clip_x0=self.clip_x0,
                  guidance_scale=self.guidance_scale)
        if self.device.type != "cuda":
            return run_steps(self._prep, inputs, **kw)
        key = (batch, guided, self.clip_x0, stochastic, color is not None)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = SamplerGraph(self._prep, inputs, **kw)
        return graph(inputs)


class NormalizedSampler:
    """Sampler over a model trained on per-dim z-scored latents: outputs are
    denormalised to raw VAE-latent space (x * std + mean)."""

    def __init__(self, inner: DiffusionSampler, mean, std):
        self._inner = inner
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=inner.device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=inner.device)

    def sample(self, batch: int, *cond, **kw) -> torch.Tensor:
        return self._inner.sample(batch, *cond, **kw) * self.std + self.mean
