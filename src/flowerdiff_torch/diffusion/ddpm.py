"""DDPM forward/reverse step math (port of flowerdiff/diffusion/ddpm.py).

`t` is a (B,) integer tensor; coefficients broadcast over trailing dims.
`ddpm_eps_loss` belongs to the training slice and is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from flowerdiff_torch.diffusion.schedule import DiffusionSchedule


def _bcast(coef: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return coef.reshape(coef.shape + (1,) * (like.ndim - coef.ndim))


def q_sample(sched: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             eps: torch.Tensor) -> torch.Tensor:
    """sqrt(abar_t) x0 + sqrt(1 - abar_t) eps."""
    abar = _bcast(sched.alpha_bar[t], x0)
    return torch.sqrt(abar) * x0 + torch.sqrt(1.0 - abar) * eps


def clip_eps_for_x0(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
                    eps_theta: torch.Tensor, clip_x0: float) -> torch.Tensor:
    """Clamp the implied x0 estimate to [-clip, clip] and return the
    equivalent epsilon (static x0-thresholding)."""
    abar = _bcast(sched.alpha_bar[t], xt)
    x0 = (xt - torch.sqrt(1.0 - abar) * eps_theta) / torch.sqrt(abar)
    x0 = torch.clamp(x0, -clip_x0, clip_x0)
    return (xt - torch.sqrt(abar) * x0) / torch.sqrt(1.0 - abar)


def p_sample_mean(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
                  eps_theta: torch.Tensor,
                  clip_x0: Optional[float] = None) -> torch.Tensor:
    """Posterior mean (xt - (1 - a_t) / sqrt(1 - abar_t) eps) / sqrt(a_t)."""
    if clip_x0 is not None:
        eps_theta = clip_eps_for_x0(sched, xt, t, eps_theta, clip_x0)
    alpha = _bcast(sched.alpha[t], xt)
    abar = _bcast(sched.alpha_bar[t], xt)
    return (xt - ((1.0 - alpha) / torch.sqrt(1.0 - abar)) * eps_theta) / torch.sqrt(alpha)


def p_sample(sched: DiffusionSchedule, xt: torch.Tensor, t: torch.Tensor,
             eps_theta: torch.Tensor, noise: torch.Tensor,
             clip_x0: Optional[float] = None) -> torch.Tensor:
    """One ancestral step, sigma^2 = beta_t, no noise where t == 0."""
    mean = p_sample_mean(sched, xt, t, eps_theta, clip_x0)
    sigma = torch.sqrt(_bcast(sched.beta[t], xt))
    keep = _bcast((t > 0).to(xt.dtype), xt)
    return mean + sigma * noise * keep
