"""Ancestral reverse-diffusion sampling (port of `sample` in
flowerdiff/diffusion/sampler.py): a plain per-step loop over `p_sample`.

It is the plain whole-path oracle for the kernel sampler. Trajectory,
`sample_from` and DDIM sampling are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from flowerdiff_torch.diffusion.ddpm import p_sample, p_sample_mean
from flowerdiff_torch.diffusion.schedule import DiffusionSchedule

EpsFn = Callable[..., torch.Tensor]


@torch.no_grad()
def sample(sched: DiffusionSchedule, eps_fn: EpsFn, shape: tuple, *cond: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           device=None, clip_x0: Optional[float] = None,
           x_init: Optional[torch.Tensor] = None,
           stochastic: bool = True) -> torch.Tensor:
    """Full ancestral sampling from N(0, I) (or from `x_init`).
    `stochastic=False` runs the posterior-mean recursion (no step noise)."""
    if x_init is None:
        x = torch.randn(shape, generator=generator, device=device)
    else:
        x = x_init.to(device=device, dtype=torch.float32)
    sched = sched.to(x.device)
    for t in range(sched.n_steps - 1, -1, -1):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        eps = eps_fn(x, t_vec, *cond)
        if stochastic:
            noise = torch.randn(x.shape, generator=generator, device=x.device)
            x = p_sample(sched, x, t_vec, eps, noise, clip_x0)
        else:
            x = p_sample_mean(sched, x, t_vec, eps, clip_x0)
    return x
